"""Device meshes and sharded fleet states: the port of
``librabft_simulator_tpu/parallel/mesh.py``.

Instances are independent, so a fleet spreads over devices by splitting its
batch dim: a :class:`Mesh` is a ('dp', 'mp') grid of torch devices, and a
fleet on it is a :class:`ShardedState`, one engine state per grid cell
holding a contiguous block of the batch (dp-major, as JAX's
``P(("dp", "mp"))`` splits it).

A device may appear in more than one cell, and then holds more than one
shard: that is how a 2- or 3-shard mesh runs on the CPU (``devices=["cpu"]
* 2``) and on one card (``[torch.device("cuda", 0)] * 3``).

Every shard owns its buffers: a block of rows is copied into fresh tensors
(a lane state's inboxes into buffers with their routing pad,
``sim/parallel_sim.py::inbox_buffer``), never kept as a view at a row
offset, because the lane engine writes its inboxes in place and the select
kernel needs each operand to start 16-byte aligned.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import Tree, tree_fields, tree_map
from ..sim import parallel_sim as P

AXES = ("dp", "mp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('dp', 'mp') grid of torch devices: ``devices[i][j]`` is the device
    of the dp index ``i`` and mp index ``j``."""

    devices: tuple

    axis_names = AXES

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "mp": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def flat(self) -> list:
        """The devices in batch-block order (dp-major)."""
        return [d for row in self.devices for d in row]


def visible_devices() -> list:
    """The CUDA devices torch sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(d) -> torch.device:
    """``d`` as a torch.device with its index (``"cuda"`` is the current
    card), so that it compares equal to a tensor's device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_dp: int | None = None, n_mp: int = 1, devices=None) -> Mesh:
    """A ('dp', 'mp') mesh over ``devices`` (default: the visible CUDA
    devices).  Raises ValueError when the shape does not fit them."""
    devices = visible_devices() if devices is None else [_indexed(d) for d in devices]
    if n_mp < 1:
        raise ValueError(f"n_mp must be >= 1, got {n_mp}")
    if n_dp is None:
        n_dp = len(devices) // n_mp
    if n_dp < 1:
        raise ValueError(
            f"n_dp must be >= 1, got {n_dp} ({len(devices)} devices visible "
            f"for n_mp={n_mp})")
    if n_dp * n_mp > len(devices):
        raise ValueError(
            f"mesh shape dp={n_dp} x mp={n_mp} needs {n_dp * n_mp} devices "
            f"but only {len(devices)} are visible (a device may hold several "
            "shards: pass devices=[device] * n)")
    grid = np.asarray(devices[: n_dp * n_mp], dtype=object).reshape(n_dp, n_mp)
    return Mesh(tuple(tuple(row) for row in grid.tolist()))


@dataclasses.dataclass
class ShardedState:
    """A fleet on a mesh: ``shards[i]`` is an engine state on
    ``mesh.flat[i]`` holding rows ``[i * b, (i + 1) * b)`` of the batch."""

    mesh: Mesh
    shards: list

    @property
    def batch(self) -> int:
        return sum(s.clock.shape[0] for s in self.shards)


def batch_sharding(mesh: Mesh, b: int) -> list:
    """The split of a batch of ``b`` instances over the mesh:
    ``[(start, stop, device)]``, one contiguous block per device cell,
    dp-major."""
    if b % mesh.size:
        raise ValueError(f"batch {b} not divisible over the mesh's {mesh.size} devices")
    per = b // mesh.size
    return [(i * per, (i + 1) * per, d) for i, d in enumerate(mesh.flat)]


def map_state(fn, states):
    """An engine state whose leaf at each path is ``fn(leaves, inbox)``:
    ``leaves`` that path's leaf of every state of ``states`` (one type),
    ``inbox`` whether it is a lane state's inbox leaf."""
    st0 = states[0]
    inbox = P.INBOX if isinstance(st0, P.PSimState) else ()
    kw = {}
    for f in tree_fields(st0):
        vals = [getattr(s, f) for s in states]
        if isinstance(vals[0], Tree):
            kw[f] = tree_map(lambda *xs: fn(list(xs), False), *vals)
        else:
            kw[f] = fn(vals, f in inbox)
    return type(st0)(**kw)


def fill(parts, device, inbox: bool) -> torch.Tensor:
    """The row blocks ``parts`` one after another in a fresh tensor on
    ``device`` (an inbox leaf: in a buffer with the routing pad)."""
    x0 = parts[0]
    shape = (sum(x.shape[0] for x in parts),) + tuple(x0.shape[1:])
    device = torch.device(device)
    out = (P.inbox_buffer(shape, x0.dtype, device) if inbox
           else torch.empty(shape, dtype=x0.dtype, device=device))
    r = 0
    for x in parts:
        out[r:r + x.shape[0]].copy_(x)
        r += x.shape[0]
    return out


def rows_of(st, start: int, stop: int, device):
    """Rows ``[start, stop)`` of a batched engine state as a state of its
    own on ``device``."""
    return map_state(lambda xs, inbox: fill([xs[0][start:stop]], device, inbox), [st])


def concat(states, device, stop: int | None = None):
    """Engine states stacked along the batch into one state of its own on
    ``device``, cut to its first ``stop`` rows (all by default)."""
    sizes = [s.clock.shape[0] for s in states]
    stop = sum(sizes) if stop is None else stop
    keep, starts = [], np.cumsum([0] + sizes)
    for s, n, a in zip(states, sizes, starts):
        if a < stop:
            keep.append((s, min(n, stop - a)))

    def cat(xs, inbox):
        return fill([x[:n] for x, (_, n) in zip(xs, keep)], device, inbox)

    return map_state(cat, [s for s, _ in keep])


def shard_batch(mesh: Mesh, state) -> ShardedState:
    """Place a batched engine state on the mesh, each block of rows on its
    device as a state of its own.  A block that is the whole state, already
    on its device, is the state itself: it is then taken over (donated, as
    JAX donates a run's buffers), so do not use ``state`` again."""
    b = state.clock.shape[0]
    shards = []
    for start, stop, dev in batch_sharding(mesh, b):
        whole = start == 0 and stop == b and state.clock.device == dev
        shards.append(state if whole else rows_of(state, start, stop, dev))
    return ShardedState(mesh, shards)


def replicate(mesh: Mesh, tree) -> list:
    """A copy of ``tree`` (a tensor or a Tree of tensors) on each device of
    the mesh, in ``mesh.flat`` order."""
    def to(d):
        if isinstance(tree, torch.Tensor):
            return tree.to(d, copy=True)
        return tree_map(lambda x: x.to(d, copy=True), tree)

    return [to(d) for d in mesh.flat]
