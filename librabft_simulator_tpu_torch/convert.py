"""Carry engine state across between the JAX package and the port.

``to_reference`` gives every leaf of a serial ``SimState`` or a lane
``PSimState`` as a numpy array (a copy) keyed by its JAX pytree path
(``"store.blk_round"``, ``"queue.payload"``, ``"in_pay"``, the planes
``"metrics"``, ``"flight"`` and ``"wd"``, ...), uint32
leaves viewed back as uint32.  ``from_reference`` is the inverse: it takes
such a dict (uint32 leaves as uint32 or as int32 bit patterns) and builds a
port state on ``device``: a ``PSimState`` when the dict has the lane
engine's inboxes, else a ``SimState``.  Leaves keep the batch dim in front; a JAX
state of one unbatched instance is a batch of one here.  The port itself
never sees a JAX object: callers flatten JAX states to numpy first.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.types import Context, NodeExtra, Pacemaker, Queue, SimState, Store, \
    leaves_with_path, tree_fields
from .sim import parallel_sim as P

_NESTED = {"store": Store, "pm": Pacemaker, "node": NodeExtra, "ctx": Context,
           "queue": Queue}


def to_reference(st) -> dict:
    """``{path: np.ndarray}`` in JAX leaf order, uint32 leaves as uint32.
    The arrays are copies: the lane engine updates its inboxes in place."""
    out = {}
    for path, leaf, is_u32 in leaves_with_path(st):
        a = leaf.detach().to("cpu", copy=True).contiguous().numpy()
        out[path] = a.view(np.uint32) if is_u32 else a
    return out


def _leaf(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.bool_:
        a = a.astype(np.int32)
    return torch.as_tensor(a.copy(), device=device)


def from_reference(leaves: dict, device="cuda"):
    """Build a port SimState, or a PSimState, from ``{path: array}`` leaves."""
    state = P.PSimState if "in_valid" in leaves else SimState
    kw = {}
    for name in tree_fields(state):
        cls = _NESTED.get(name)
        if name in P.INBOX:
            v = _leaf(leaves[name], "cpu")
            kw[name] = P.inbox_buffer(v.shape, v.dtype, device, v)
        elif cls is None:
            kw[name] = _leaf(leaves[name], device)
        else:
            kw[name] = cls(**{f: _leaf(leaves[f"{name}.{f}"], device)
                              for f in tree_fields(cls)})
    return state(**kw)
