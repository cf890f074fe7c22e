"""Batched write and gather helpers: the semantics of
``librabft_simulator_tpu/utils/xops.py``'s ``wset`` and
``scatter_set(mode="scatter")`` over a leading instance dim ``[B]``.

Both are "an out-of-range index writes nothing": ``wset`` is a one-hot
``torch.where`` (an index outside ``[0, size)`` matches no position), and
``scatter_set`` pads one spare slot, scatters, and slices the spare off, so
the sentinel ``idx == size`` lands in the spare (torch's ``scatter_`` raises
where JAX's ``mode="drop"`` discards).

The JAX package's lowering choices (``SimParams.dense_writes``, ``packed``,
``gate_handlers``, ``unroll``) pick between bit-identical forms there; the
port accepts the fields and they have no effect on it.  :func:`resolve_params`
makes the dispatch fields (``macro_k``, ``wrap``, ``ring_k``) explicit.

Nothing here mutates its inputs: state tensors are never written in place,
which is what lets ``zeros`` hand one cached tensor to many leaves.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

I32 = torch.int32

#: Digest-ring depth of ``wrap="device"`` when ``SimParams.ring_k`` is unset.
DEFAULT_RING_K = 16


def resolve_params(p):
    """The dispatch fields of a SimParams made explicit, as the JAX
    package's ``resolve_params`` makes them, but from the params' own
    values only (the port reads no environment variable): ``macro_k`` None
    becomes 1, ``wrap`` None becomes ``"host"``, and ``ring_k`` becomes
    :data:`DEFAULT_RING_K` (if unset) under ``wrap="device"`` and None
    under ``wrap="host"``.  The lowering fields have no effect on the port
    and stay as they are."""
    macro = p.macro_k if p.macro_k is not None else 1
    wrap = p.wrap if p.wrap is not None else "host"
    ring = None if wrap == "host" else (p.ring_k if p.ring_k is not None else DEFAULT_RING_K)
    if (macro, wrap, ring) == (p.macro_k, p.wrap, p.ring_k):
        return p
    return dataclasses.replace(p, macro_k=macro, wrap=wrap, ring_k=ring)


@functools.lru_cache(maxsize=None)
def arange(n: int, device) -> torch.Tensor:
    """Cached int64 ``arange(n)`` (index math and one-hot masks)."""
    return torch.arange(n, device=device)


@functools.lru_cache(maxsize=None)
def const(shape: tuple, value, dtype, device) -> torch.Tensor:
    """Cached constant tensor; shared by every caller, so never written in
    place."""
    return torch.full(shape, value, dtype=dtype, device=device)


def zeros(shape: tuple, dtype, device) -> torch.Tensor:
    return const(shape, 0, dtype, device)


def needed(mask: torch.Tensor) -> bool:
    """Whether work masked by the per-instance ``mask`` must run.  On the
    card it always does: the work is queued and no host sync is taken.  On
    the CPU, where reading the mask is free, it runs only when some
    instance has it set; skipped work would have changed nothing."""
    return mask.device.type != "cpu" or bool(mask.any())


def bc(pred: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """View a per-instance ``[B, ...]`` value so it broadcasts against the
    trailing dims of ``like`` (the batched form of a JAX scalar predicate)."""
    extra = like.dim() - pred.dim()
    if extra <= 0:
        return pred
    return pred.reshape(pred.shape + (1,) * extra)


def where(pred, a, b):
    """``jnp.where`` with a per-instance predicate broadcast over trailing dims."""
    ref = b if isinstance(b, torch.Tensor) else a
    if isinstance(pred, torch.Tensor) and isinstance(ref, torch.Tensor):
        pred = bc(pred, ref)
    return torch.where(pred, a, b)


def onehot(arr: torch.Tensor, idx, when=None) -> torch.Tensor:
    """Mask of the positions ``arr[b, idx[0][b], idx[1][b], ...]`` (``when``
    gates each instance).  Out-of-range indices select nothing."""
    idxs = idx if isinstance(idx, tuple) else (idx,)
    b = arr.shape[0]
    mask = None
    for d, ix in enumerate(idxs):
        size = arr.shape[d + 1]
        shape = [1] * (len(idxs) + 1)
        shape[d + 1] = size
        ixv = ix.reshape((b,) + (1,) * len(idxs))
        m = arange(size, arr.device).reshape(shape) == ixv
        mask = m if mask is None else mask & m
    if when is not None:
        mask = mask & when.reshape((b,) + (1,) * len(idxs))
    return mask


def put(mask: torch.Tensor, arr: torch.Tensor, val) -> torch.Tensor:
    """Write ``val`` (per instance, shaped like the indexed slice) where
    ``mask`` (from :func:`onehot`) is set."""
    extra = arr.dim() - mask.dim()
    if extra:
        mask = mask.reshape(mask.shape + (1,) * extra)
    if isinstance(val, torch.Tensor):
        if val.dtype != arr.dtype:
            val = val.to(arr.dtype)
        lead = arr.dim() - val.dim()  # the index dims the value lacks
        val = val.reshape(val.shape[:1] + (1,) * lead + val.shape[1:])
    return torch.where(mask, val, arr)


def wset(arr: torch.Tensor, idx, val, when=None) -> torch.Tensor:
    """``arr.at[idx].set(val)`` per instance, for per-instance scalar
    indices into the dims after ``[B]``.  Out-of-range (and negative)
    indices write nothing, as in the JAX package."""
    return put(onehot(arr, idx, when), arr, val)


def take(arr: torch.Tensor, *idx) -> torch.Tensor:
    """``arr[b, idx[0][b], ...]`` per instance; indices must be in range."""
    b = arr.shape[0]
    return arr[(arange(b, arr.device),) + idx]


def scatter_set(dst: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """``dst.at[idx].set(src, mode="drop")`` over the dim after ``[B]``.

    ``dst``: ``[B, M, ...]``; ``idx``: ``[B, K]`` targets in ``[0, M]``
    (``M`` is the drop sentinel); ``src``: a Python scalar, ``[B, K]`` or
    ``[B, K, ...]`` rows.  Targets are distinct apart from the sentinel."""
    b, m = dst.shape[0], dst.shape[1]
    k = idx.shape[1]
    pad = zeros((b, 1) + tuple(dst.shape[2:]), dst.dtype, dst.device)
    out = torch.cat([dst, pad], dim=1)
    tail = tuple(dst.shape[2:])
    index = idx.to(torch.int64).reshape((b, k) + (1,) * len(tail)).expand(
        (b, k) + tail)
    if isinstance(src, torch.Tensor):
        src = src.to(dst.dtype).expand((b, k) + tail)
        out.scatter_(1, index, src)
    else:
        out.scatter_(1, index, src)
    return out[:, :m]
