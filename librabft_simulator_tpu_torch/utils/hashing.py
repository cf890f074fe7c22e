"""Deterministic integer hashing / RNG: the port of
``librabft_simulator_tpu/utils/hashing.py``.

The functions are murmur3-style finalizer rounds over uint32 words.  Torch
has no usable uint32 arithmetic, so the words are carried in int64 tensors
holding the unsigned value and masked to 32 bits after every multiply and
before every shift.  The public functions take int32 bit patterns, bools,
int64 values or Python ints and return the int32 tensor with the uint32
result's bit pattern (the port's representation of a uint32 leaf).  Calls
with Python ints only return a Python int of that bit pattern.

``as_u32`` gives the unsigned value back as int64 for the sites that compare
or shift a draw as unsigned (the drop test and the quantile-table index).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF

# Domain-separation tags for record hashing (arbitrary odd constants).
TAG_BLOCK = 0x9E3779B1
TAG_VOTE = 0x85EBCA77
TAG_QC = 0xC2B2AE3D
TAG_TIMEOUT = 0x27D4EB2F
TAG_STATE = 0x165667B1
TAG_EPOCH = 0x5851F42D
TAG_LEADER = 0x2545F491
TAG_SEED = 0x9E447687


def as_u32(x):
    """The uint32 value of a word (int32 bit pattern, bool or int) as int64."""
    if isinstance(x, (int, bool)):
        return int(x) & M32
    return x.to(torch.int64) & M32


def to_i32(v):
    """int32 bit pattern of a uint32 value held in int64 (or a Python int)."""
    if isinstance(v, int):
        v &= M32
        return v - (1 << 32) if v >= (1 << 31) else v
    return v.to(torch.int32)


def _mix(h, x):
    """One murmur3 fmix fold of word ``x`` into ``h``; both uint32 values."""
    h = h ^ x
    h = (h * 0x9E3779B1) & M32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    h = h ^ (h >> 16)
    return h


def _fold_u(*words):
    h = 0x811C9DC5
    for w in words:
        # Leading Python-int words (the domain tags) fold on the host.
        h = _mix(h, as_u32(w))
    return h


def mix32(h, x):
    """Fold one uint32 word ``x`` into accumulator ``h`` (murmur3 fmix rounds)."""
    return to_i32(_mix(as_u32(h), as_u32(x)))


def fold(*words):
    """Hash a sequence of uint32-like words into a single uint32 tag."""
    return to_i32(_fold_u(*words))


def rng_u32(seed, counter):
    """Counter-based uniform uint32: stream ``seed``, index ``counter``."""
    return fold(TAG_SEED, seed, counter)


def rng_u32_pair(seed, counter):
    """Two independent uint32 draws for one counter (delay + drop decision)."""
    a = _fold_u(TAG_SEED, seed, counter)
    b = _mix(a, 0x632BE59B)
    return to_i32(a), to_i32(b)


def state_tag_next(prev_tag, cmd_proposer, cmd_index, time):
    """Rolling ledger-state hash: executing one command on top of prev state."""
    return fold(TAG_STATE, prev_tag, cmd_proposer, cmd_index, time)


def epoch_initial_tag(epoch_id):
    """Initial QC 'hash' for an epoch."""
    return fold(TAG_EPOCH, epoch_id)


def initial_state_tag():
    """Tag of the empty ledger state."""
    return fold(TAG_STATE, 0)
