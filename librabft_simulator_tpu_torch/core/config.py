"""EpochConfiguration as weight tensors: the port of
``librabft_simulator_tpu/core/config.py``.

Voting rights are an int32 tensor ``weights[B, N]`` (index = author).

The quorum aggregations take an author group, ``axis_name``: the mesh axis
the author dimension is split over (``MP_AXIS``), as in the JAX package,
where ``SimParams.mp_authors`` makes the step's three quorum sites
(core/store.py) psum their partial sums over it.  The group must be bound,
as a JAX ``shard_map`` binds it: parallel/sharded.py binds it around each
shard's chunk (:func:`bound_axes`), and outside a bound group the sums
raise ``NameError``, as JAX's trace of an unbound axis does.  The fleet
runtime binds groups of one shard only (it refuses ``mp_authors`` on a
mesh with n_mp > 1, as the JAX package does), so a bound sum is its own
partial sum: at n_mp = 1 the armed sites compute exactly what the plain
ones do.  Sums over several author shards are
``parallel/sharded.py::sharded_count_votes`` and
``sharded_quorum_reached``.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from ..utils import hashing as H

I32 = torch.int32

#: Mesh axis the author dimension splits over (parallel/mesh.py).
MP_AXIS = "mp"

_BOUND: contextvars.ContextVar = contextvars.ContextVar("bound_axes", default=frozenset())


def mp_axis(p) -> str | None:
    """The author group the quorum sites sum over for these params (None:
    one device's author math, the default)."""
    return MP_AXIS if getattr(p, "mp_authors", False) else None


@contextlib.contextmanager
def bound_axes(names):
    """Bind mesh axes of one shard each for the block (the fleet runtime's
    per-shard context)."""
    token = _BOUND.set(_BOUND.get() | frozenset(names))
    try:
        yield
    finally:
        _BOUND.reset(token)


def _psum(x, axis_name):
    """The sum of ``x`` over the author group ``axis_name``: ``x`` itself
    inside a bound group of one shard; NameError outside."""
    if axis_name is not None and axis_name not in _BOUND.get():
        raise NameError(f"unbound axis name: {axis_name}")
    return x


def total_votes(weights, axis_name=None):
    return _psum(weights.sum(dim=-1, dtype=I32), axis_name)


def quorum_threshold(weights, axis_name=None):
    """2N/3 + 1 (configuration.rs:52-56)."""
    return torch.div(2 * total_votes(weights, axis_name), 3, rounding_mode="floor") + 1


def validity_threshold(weights, axis_name=None):
    """(N + 2) / 3 (configuration.rs:58-62)."""
    return torch.div(total_votes(weights, axis_name) + 2, 3, rounding_mode="floor")


def count_votes(weights, author_mask, axis_name=None):
    """Sum of voting rights over a boolean author mask (configuration.rs:43)."""
    return _psum(torch.where(author_mask, weights, 0).sum(dim=-1, dtype=I32), axis_name)


def pick_author(weights, seed_u32):
    """Weighted author choice: first author with cumweight > target
    (configuration.rs:65-75).  ``seed_u32`` is a uint32 draw (int32 bit
    pattern); the modulus is taken on its unsigned value."""
    total = H.as_u32(total_votes(weights))
    target = (H.as_u32(seed_u32) % total).to(I32)
    cum = torch.cumsum(weights, dim=-1, dtype=I32)
    return (cum <= target.unsqueeze(-1)).sum(dim=-1, dtype=I32)


def leader_of_round(weights, round_):
    """PacemakerState::leader: hash the round, pick an author weighted by
    voting rights."""
    return pick_author(weights, H.fold(H.TAG_LEADER, round_))
