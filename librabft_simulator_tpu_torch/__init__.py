"""PyTorch/CUDA port of the batched LibraBFTv2 simulator.

Mirrors ``librabft_simulator_tpu`` module for module (``sim/simulator.py``
here is ``sim/simulator.py`` there) and is held against it leaf for leaf.
It imports torch and numpy only.

Representation decided once for the whole port: every uint32 state leaf of
the JAX package is stored as an int32 tensor holding the same bit pattern
(``convert.py`` views it back as uint32).  Hash arithmetic runs in int64
masked to 32 bits (``utils/hashing.py``); unsigned compares are made on the
int64 value, never on the signed int32.
"""
