"""Checkpoint / resume: the port of the ``.npz`` half of
``librabft_simulator_tpu/sim/checkpoint.py``.

The whole fleet (all instances, queues or inboxes, rng counters, planes) is
one state, so a checkpoint is every leaf as a numpy array, and a restored
run continues bit for bit.  Keys and dtypes are the JAX package's (``_key``:
the leaf's path joined by ``/``; uint32 leaves stored as uint32), so a
checkpoint written by either package loads into the other.  The port's
states always carry the batch dim: a JAX checkpoint of one unbatched
instance loads as a batch of one.

:func:`load_sharded` restores a fleet checkpoint onto a device mesh
(parallel/mesh.py).  Not ported: the orbax pair (no orbax on the card's
machine).
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import from_reference, to_reference
from ..core.types import SimParams, leaves_with_path


def _key(path: str) -> str:
    """The checkpoint key of a leaf path (``"store.blk_round"`` ->
    ``"store/blk_round"``): the JAX package's key rule."""
    return path.replace(".", "/")


def _ho_default(field: str, shape, dtype) -> np.ndarray:
    """Fresh-init value of a cross-epoch handoff leaf (soft cache state):
    zero packs, -1 ('no epoch held') slots."""
    return np.full(shape, -1 if field == "ho_epoch" else 0, dtype)


def _sc_default(p: SimParams, field: str, shape, dtype) -> np.ndarray:
    """Knob-default scenario-plane rows of the load params (a zero-width
    target restores empty)."""
    if shape[-1] == 0:
        return np.zeros(shape, dtype)
    row = (np.asarray(p.delay_table(), dtype) if field == "sc_delay"
           else np.asarray([p.commit_chain], dtype))
    return np.broadcast_to(row, shape).copy()


_ADV_FIELDS = ("adv_sched", "adv_link", "adv_group", "adv_heal")
_TRACE = ("trace_node", "trace_round", "trace_time")
_PLANES = ("metrics", "flight", "wd")


def save(path: str, state) -> None:
    """Write every leaf of a batched ``SimState`` or ``PSimState``."""
    arrays = {_key(k): v for k, v in to_reference(state).items()}
    np.savez_compressed(path, **arrays)


def _template(p: SimParams, data, like):
    """(path, shape, numpy dtype) of every leaf the restored state has."""
    b = None
    if like is None:
        from . import parallel_sim as P
        from . import simulator as S

        sample = data["clock"]
        b = sample.shape[0] if sample.ndim > 0 else 1
        engine = P if "in_valid" in data else S
        # A batch of one on the CPU; every leaf has the batch dim in front.
        like = engine.init_batch(p, np.zeros(1, np.uint32), device="cpu")
    out = []
    for path, leaf, is_u32 in leaves_with_path(like):
        dtype = np.uint32 if is_u32 else np.bool_ if leaf.dtype == torch.bool else np.int32
        shape = tuple(leaf.shape) if b is None else (b,) + tuple(leaf.shape[1:])
        out.append((path, shape, dtype))
    return out


def load(path: str, p: SimParams, like=None, device="cuda"):
    """Restore a state on ``device``.  ``like`` gives the structure and
    shapes (default: those of a fresh ``init_batch`` of the load params at
    the checkpoint's batch, a lane state when it holds inboxes).  Leaves the load params resize or
    that an older checkpoint lacks are restored as the JAX package
    restores them: soft state (handoff ring, trace ring, planes) empty, the
    scenario rows from the load params, the adversary rows inert; any
    other missing or resized leaf raises."""
    data = np.load(path)
    batched = data["clock"].ndim > 0
    leaves = {}
    flat = _template(p, data, like)
    # A trace_cap change resets the ring, so its count must reset with it.
    ring_reset = any(k.split(".")[-1] == "trace_node" and _key(k) in data
                     and _shape(data[_key(k)], batched) != shape
                     for k, shape, _ in flat)
    for k, shape, dtype in flat:
        key, field = _key(k), k.split(".")[-1]
        if field == "trace_count" and ring_reset:
            leaves[k] = np.zeros(shape, dtype)
            continue
        if key not in data:
            leaves[k] = _default(p, key, field, shape, dtype)
            continue
        arr = data[key] if batched else data[key][None]
        if arr.shape != shape:
            if field in _ADV_FIELDS and arr.size != 0:
                # The plane rows are per-instance attack data: refuse rather
                # than report an attacked run as attack-free.
                raise ValueError(f"{key}: shape {arr.shape} != {shape}")
            leaves[k] = _default(p, key, field, shape, dtype, resized=arr.shape)
            continue
        leaves[k] = arr.astype(dtype)
    return from_reference(leaves, device=device)


def _shape(arr, batched):
    return arr.shape if batched else (1,) + arr.shape


def _default(p, key, field, shape, dtype, resized=None):
    """The restore value of a leaf the checkpoint lacks (``resized`` None)
    or holds at another shape."""
    if field in ("ho_pay", "ho_epoch"):
        return _ho_default(field, shape, dtype)
    if field in _TRACE + ("trace_count",) + _PLANES + _ADV_FIELDS:
        if resized is None or field != "trace_count":
            return np.zeros(shape, dtype)
    if field in ("sc_delay", "sc_commit"):
        return _sc_default(p, field, shape, dtype)
    if resized is None:
        raise KeyError(f"checkpoint missing leaf {key}")
    raise ValueError(f"{key}: shape {resized} != {shape}")


def load_sharded(path: str, p: SimParams, mesh, engine=None, like=None):
    """Restore a batched checkpoint onto a device mesh; returns ``(state,
    n_valid)``, a ``ShardedState`` and the checkpoint's batch.

    The checkpoint is loaded on the host and, if the mesh does not divide
    its batch, padded there with pre-halted instances
    (``parallel/sharded.py::pad_to_multiple``); then each shard's rows go to
    its own device, so no device ever holds a whole leaf.  ``engine`` makes
    the padding (default: the engine of the checkpoint's state); ``like`` is
    as in :func:`load`.  Drop the padding with ``sharded.unpad(state,
    n_valid)``."""
    from ..parallel import mesh as mesh_ops, sharded

    if np.load(path)["clock"].ndim == 0:
        raise ValueError(
            "load_sharded needs a batched checkpoint (this one holds a "
            "single instance); use load() for single-instance restores")
    host = load(path, p, like=like, device="cpu")
    host, n_valid = sharded.pad_to_multiple(p, host, mesh.size, engine=engine)
    return mesh_ops.shard_batch(mesh, host), n_valid
