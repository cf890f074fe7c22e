"""The metrics plane and its static slot registry, and the flight
recorder: the port of ``librabft_simulator_tpu/telemetry/plane.py``.

Every counter, high-water mark and histogram bucket of one instance lives
in one flat ``[M]`` int32 plane (``[B, M]`` for a batch) at a static
(name -> offset) registry; the offsets are Python ints, so every update is
a static-slice write.  The flight recorder is a ``[K, FR_COLS]`` ring per
instance: one row per processed event (kind, actor, global time, the
actor's round after the update, queue depth), its running count in the
plane's ``fr_count`` slot.

Everything is gated by ``SimParams.telemetry``; off, the plane and the
ring are zero-width and the engines skip every update.  Nothing here
mutates its inputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.types import FR_COLS
from ..utils import quantile
from ..utils.xops import arange, take

I32 = torch.int32

# Flight-recorder row layout: the event kind (KIND_* incl. timer), the
# handling node, the event's global time, the node's current_round after the
# update, and the queue/inbox occupancy after the step's writes.
FR_NAMES = ("kind", "actor", "time", "round", "depth")

# Slot aggregation kinds (how batched planes merge on the host).
SUM = "sum"    # counters and histogram buckets: add across instances
MAX = "max"    # high-water marks: max across instances


@functools.lru_cache(maxsize=None)
def registry(p_structural):
    """Static slot registry of one instance's plane: ``(slots, width)``,
    ``slots`` a name-keyed dict of ``(offset, size, agg)``.  The layout
    depends only on n_nodes and the histogram width."""
    n = p_structural.n_nodes
    hb = quantile.HIST_BUCKETS
    order = [
        # Per-event-kind counters (live processed events; sum == n_events).
        ("ev_notify", 1, SUM),
        ("ev_request", 1, SUM),
        ("ev_response", 1, SUM),
        ("ev_timer", 1, SUM),
        # Loss / anomaly tallies.
        ("drops", 1, SUM),          # network drops (== n_msgs_dropped)
        ("overflow", 1, SUM),       # queue/inbox overflow (== n_queue_full)
        ("sync_jumps", 1, SUM),     # state-sync jumps across the fleet
        # Queue pressure high-water marks (post-step occupancy).
        ("queue_hwm", 1, MAX),          # total in-flight messages
        ("node_depth_hwm", n, MAX),     # per-receiver depth
        # Latency histograms (geometric buckets, utils/quantile.py).
        ("round_lat_hist", hb, SUM),    # time spent in a round at switch
        ("commit_lat_hist", hb, SUM),   # proposal -> commit, global time
        ("commit_lat_miss", 1, SUM),    # commits whose block left the window
        # Flight-recorder running count (the ring is SimState.flight).
        ("fr_count", 1, SUM),
        # Lane engine window health; zero under the serial engine.
        ("windows", 1, SUM),        # conservative windows processed
        ("horizon_stall", 1, SUM),  # nodes with work beyond the hz horizon
        ("lane_spill", 1, SUM),     # qualifying nodes beyond the A lanes
    ]
    slots = {}
    off = 0
    for name, size, agg in order:
        slots[name] = (off, size, agg)
        off += size
    return slots, off


def width(p) -> int:
    """Plane length M for these params (0 when telemetry is off)."""
    if not p.telemetry:
        return 0
    return registry(p.structural())[1]


def slot(p, name: str) -> tuple[int, int]:
    """(offset, size) of a named slot: static Python ints."""
    off, size, _ = registry(p.structural())[0][name]
    return off, size


def init_plane(p, shape=(), device="cuda"):
    """Zero plane ([M] per instance; [0] when telemetry is off)."""
    return torch.zeros(tuple(shape) + (width(p),), dtype=I32, device=device)


def init_flight(p, shape=(), device="cuda"):
    """Zero flight ring ([K, FR_COLS] per instance; K=0 when off)."""
    k = p.flight_cap if p.telemetry else 0
    return torch.zeros(tuple(shape) + (k, FR_COLS), dtype=I32, device=device)


# ---------------------------------------------------------------------------
# Device-side updates of a [B, M] plane; each returns a new plane.
# ---------------------------------------------------------------------------


def _updated(metrics, off, size, fn):
    out = metrics.clone()
    out[:, off:off + size] = fn(metrics[:, off:off + size])
    return out


def bump(p, metrics, name: str, inc=1, when=None):
    """Add ``inc`` (a Python int or ``[B]``) to a size-1 slot, masked by
    ``when`` (``[B]``).  A Python int stays a kernel argument: copying it
    to the card would wait for the card's queue to drain."""
    off, size = slot(p, name)
    assert size == 1, name
    if when is not None:
        inc = torch.where(when, inc, 0)
    if isinstance(inc, torch.Tensor):
        inc = inc.reshape(-1, 1)
    return _updated(metrics, off, 1, lambda cur: cur + inc)


def bump_hist(p, metrics, name: str, samples, mask):
    """Accumulate latency ``samples`` ([B, L], masked by ``mask`` [B, L])
    into a histogram region: bucket = the number of edges <= the sample,
    clamped to the last bucket, as ``quantile.bucket_np`` buckets."""
    off, size = slot(p, name)
    edges = _edges(size, metrics.device)
    b = (samples.unsqueeze(-1) >= edges).sum(-1).clamp(max=size - 1)
    onehot = (b.unsqueeze(-1) == arange(size, metrics.device)) & mask.unsqueeze(-1)
    return _updated(metrics, off, size, lambda cur: cur + onehot.sum(1, dtype=I32))


@functools.lru_cache(maxsize=None)
def _edges(size, device):
    return torch.as_tensor(quantile.histogram_edges(size), device=device)


def region_max(p, metrics, name: str, values):
    """Elementwise max of a region against ``values`` ([B, size] or [B]):
    the high-water-mark update."""
    off, size = slot(p, name)
    values = values.to(I32).reshape(metrics.shape[0], -1)
    return _updated(metrics, off, size, lambda cur: torch.maximum(cur, values))


def read(p, metrics, name: str):
    """``[B]`` read of a size-1 slot."""
    off, size = slot(p, name)
    assert size == 1, name
    return metrics[:, off]


def commit_latency(p, store, ctx, startup, clock):
    """(found, latency) of the newest committed entry of each row's node.

    Rows: ``store`` and ``ctx`` hold one node per row, ``startup`` the
    row's instance startups ``[R, N]``, ``clock`` ``[R]``.  The proposal
    time is the committed block's ``time`` (proposer-local) plus its
    proposer's startup, found in the block window; ``found`` is False when
    the block has rotated out (callers tally ``commit_lat_miss``).  Variant
    ties resolve to the lowest valid variant (argmax's first index)."""
    pos = torch.remainder(ctx.commit_count - 1, p.commit_log)
    r_c = take(ctx.log_round, pos)
    sl = torch.remainder(r_c, p.window)
    cand = take(store.blk_valid, sl) & (take(store.blk_round, sl) == r_c.unsqueeze(1))
    found = cand.any(dim=1)
    v = cand.to(I32).argmax(dim=1)  # lowest valid variant
    author = take(store.blk_author, sl, v).clamp(0, p.n_nodes - 1)
    t_prop = take(store.blk_time, sl, v) + take(startup, author)
    return found, (clock - t_prop).clamp(min=0)


# ---------------------------------------------------------------------------
# Host side.
# ---------------------------------------------------------------------------


def ring_order(count: int, cap: int) -> list:
    """Chronological storage indices of a capacity-``cap`` append ring after
    ``count`` appends, oldest surviving entry first (the flight recorder
    here, the round-switch trace in analysis/data_writer.py).  An unused or
    disabled ring (``cap == 0``) decodes to no entries."""
    if cap <= 0:
        return []
    if count > cap:
        start = count % cap
        return [(start + i) % cap for i in range(cap)]
    return list(range(count))


def np_registry(p) -> dict:
    """Host view of the registry: name -> (offset, size, agg)."""
    return dict(registry(p.structural())[0])


def np_width(p) -> int:
    return int(registry(p.structural())[1])


def fold_planes(p, planes_np: np.ndarray, into=None) -> np.ndarray:
    """Reduce a ``[..., M]`` block of per-instance planes to one ``[M]``
    int64 partial (counters and histograms sum, high-water marks max),
    optionally folding into an existing partial.  All-zero rows are
    absorbing for both aggregations."""
    w = np_width(p)
    out = np.zeros((w,), np.int64) if into is None else into
    flat = np.asarray(planes_np, np.int64).reshape(-1, w) \
        if w else np.zeros((0, 0), np.int64)
    if flat.shape[0] == 0:
        return out
    for name, (off, size, agg) in np_registry(p).items():
        blk = flat[:, off:off + size]
        if agg == MAX:
            out[off:off + size] = np.maximum(out[off:off + size],
                                             blk.max(axis=0))
        else:
            out[off:off + size] += blk.sum(axis=0)
    return out


def decode(p, metrics_np: np.ndarray) -> dict:
    """One instance's plane -> {name: int | list}."""
    out = {}
    for name, (off, size, _) in np_registry(p).items():
        vals = metrics_np[off:off + size]
        out[name] = int(vals[0]) if size == 1 else [int(v) for v in vals]
    return out
