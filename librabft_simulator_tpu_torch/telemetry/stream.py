"""Live fleet health: the per-chunk digest, the consensus watchdog's plane,
and the host-side timeline.  The port of
``librabft_simulator_tpu/telemetry/stream.py`` (single device).

* **Digest**: a fixed ``[D]`` int32 vector summarizing a whole batch
  (halted count, events, commits, drops, overflow, live queue pressure,
  min/max committed round, watchdog trip counts), computed on the device
  at the end of every chunk.  ``run_to_completion(stream=)`` fetches this
  one vector per chunk instead of the ``[B]`` halted plane (slot 0 is the
  halt count), so watching a run adds no host sync.
* **Watchdog**: a ``[WD]`` int32 plane per instance (:data:`WD_SLOTS`),
  updated inside the step when ``SimParams.watchdog`` is on: liveness
  stall, queue saturation, sync jumps, conflicting commits at one height,
  and round regression inside a committed chain.  Off, the leaf is
  zero-width and the step skips it.
* **Timeline**: :class:`TimelineRecorder` collects the digests into a host
  time series and streams NDJSON that :func:`load_ndjson` (and the JAX
  package's readers) read back; :meth:`TimelineRecorder.record_ring` takes
  a device-wrap ring of digests fetched at once.

The slot maps are frozen behind :data:`REGISTRY_VERSION`; readers refuse a
stream of another version.  The digest of a sharded fleet
(parallel/sharded.py) reduces its shards' digests slot by slot on the
device of the first shard (:func:`merge_digests`), the JAX package's mesh
reduction.
"""

from __future__ import annotations

import functools
import json
import threading
import time

import numpy as np
import torch

from .schema import (DIGEST_SLOTS, DIGEST_WIDTH, MAX, REGISTRY_VERSION,  # noqa: F401
                     SUM, WD_DETECTORS, require_registry_version)

I32 = torch.int32

# Watchdog plane: per-instance [WD] int32 (zero-width when the watchdog is
# off).  Slot 0 is detector state; the rest are monotone trip counters.
WD_STALL_EV = 0         # events since the last pacemaker round advance
WD_STALL = 1            # liveness-stall trips (threshold crossings)
WD_QUEUE_SAT = 2        # steps/windows at queue/inbox saturation
WD_SYNC_JUMP = 3        # state-sync jump anomalies observed
WD_SAFETY_CONFLICT = 4  # conflicting commit at the same height
WD_ROUND_REGRESS = 5    # round regression inside a committed chain
WD_SLOTS = ("stall_ev", "stall", "queue_sat", "sync_jump",
            "safety_conflict", "round_regress")
WD_WIDTH = len(WD_SLOTS)


def wd_width(p) -> int:
    """Watchdog plane length (0 when the watchdog is off)."""
    return WD_WIDTH if p.watchdog else 0


def init_wd(p, shape=(), device="cuda"):
    """Zero watchdog plane ([WD] per instance; [0] when off)."""
    return torch.zeros(tuple(shape) + (wd_width(p),), dtype=I32, device=device)


def compute_digest(p, st) -> torch.Tensor:
    """The fleet-health digest of a batched engine state (serial
    ``SimState`` or lane ``PSimState``, or a sharded fleet of either): one
    ``[D]`` int32 tensor on the state's device (a sharded fleet's first
    shard's), slots as :data:`DIGEST_SLOTS`.  ``queue_depth_max`` is the
    current occupancy, not the high-water mark.  int32 throughout, as in the
    JAX package: the sums are taken wide and cast back, so a fleet summing
    past 2**31 wraps the same way."""
    shards = getattr(st, "shards", None)
    if shards is not None:
        return merge_digests([compute_digest(p, s) for s in shards])

    def s32(x):
        return x.sum(dtype=torch.int64).to(I32)

    if hasattr(st, "queue"):      # serial engine: shared [CM] message table
        occ = st.queue.valid.sum(dim=1, dtype=I32)
        overflow = st.n_queue_full
    else:                         # lane engine: [N, IC] per-receiver inboxes
        occ = st.in_valid.flatten(1).sum(dim=1, dtype=I32)
        overflow = st.n_inbox_full
    hcr = st.store.hcr
    parts = [s32(st.halted), s32(st.n_events), s32(st.ctx.commit_count),
             s32(st.n_msgs_dropped), s32(overflow), occ.max(), hcr.min(), hcr.max()]
    if p.watchdog:
        wd_tot = st.wd.sum(dim=0, dtype=torch.int64).to(I32)
        parts += [wd_tot[WD_SLOTS.index(name)] for name in WD_DETECTORS]
    else:
        parts += [torch.zeros((), dtype=I32, device=hcr.device)] * len(WD_DETECTORS)
    return torch.stack([x.to(I32) for x in parts])


@functools.lru_cache(maxsize=None)
def _agg_masks(device):
    """Which digest slots sum and which take the max, as bool tensors on
    ``device`` (made once: a host list sent per call would wait for the
    card's queue)."""
    aggs = [agg for _, agg in DIGEST_SLOTS]
    return (torch.tensor([a == SUM for a in aggs], device=device),
            torch.tensor([a == MAX for a in aggs], device=device))


def merge_digests(vecs) -> torch.Tensor:
    """Per-shard ``[D]`` digests folded into the fleet's, slot by slot as
    :data:`DIGEST_SLOTS` says (sum, max or min), on the device of the first:
    the JAX package's ``compute_digest(axis_names=)`` psum / pmax / pmin.
    The vectors cross devices without a host fetch."""
    dev = vecs[0].device
    if len(vecs) == 1:
        return vecs[0]
    m = torch.stack([v.to(dev, non_blocking=True) for v in vecs]).to(torch.int64)
    is_sum, is_max = _agg_masks(dev)
    out = torch.where(is_sum, m.sum(dim=0),
                      torch.where(is_max, m.max(dim=0).values, m.min(dim=0).values))
    return out.to(I32)


# ---------------------------------------------------------------------------
# Host-side decode / fold.
# ---------------------------------------------------------------------------


def _flags(d) -> int:
    return sum((1 << i) for i, det in enumerate(WD_DETECTORS) if d["wd_" + det] > 0)


def decode_digest(vec) -> dict:
    """A fetched ``[D]`` digest -> named dict, plus the ``watchdog_flags``
    bitmask (bit *i* set iff detector *i* of :data:`WD_DETECTORS` tripped)."""
    vec = np.asarray(vec).astype(np.int64)
    if vec.shape != (DIGEST_WIDTH,):
        raise ValueError(
            f"digest shape {vec.shape} != ({DIGEST_WIDTH},); artifact from "
            f"another registry version? (this build is v{REGISTRY_VERSION})")
    out = {name: int(vec[i]) for i, (name, _) in enumerate(DIGEST_SLOTS)}
    out["watchdog_flags"] = _flags(out)
    return out


def pad_digest() -> dict:
    """The digest contribution of one pre-halted padding instance: halted,
    everything else zero."""
    d = {name: 0 for name, _ in DIGEST_SLOTS}
    d["halted"] = 1
    return d


def fold_digests(rows) -> dict:
    """Fold per-instance digest dicts into one fleet digest with each
    slot's aggregation: the host twin of :func:`compute_digest`."""
    rows = list(rows)
    if not rows:
        raise ValueError("fold_digests needs at least one digest row")
    out = {}
    for name, agg in DIGEST_SLOTS:
        vals = [int(r[name]) for r in rows]
        out[name] = (sum(vals) if agg == SUM
                     else max(vals) if agg == MAX else min(vals))
    out["watchdog_flags"] = _flags(out)
    return out


# ---------------------------------------------------------------------------
# Host timeline.
# ---------------------------------------------------------------------------


class TimelineRecorder:
    """Collects per-chunk digests into a time series and (optionally)
    streams NDJSON.

    One :meth:`record` call per polled chunk: the row carries the decoded
    digest plus derived rates (events/s since the previous chunk, halt
    progress, a crude halted-rate ETA).  ``out`` (a path or a file-like
    object) additionally gets one JSON line per row, after a meta line
    carrying :data:`REGISTRY_VERSION`."""

    def __init__(self, p, total_instances=None, out=None, meta=None):
        self.p = p
        self.total_instances = total_instances
        self.rows = []
        self._owns_out = isinstance(out, str)
        self._out = open(out, "w") if self._owns_out else out
        # Lines are written under this lock, so a row that another thread
        # emits never interleaves with a digest row.
        self._wlock = threading.Lock()
        self._t0 = self._last_t = time.perf_counter()
        self._last_events = 0
        header = {
            "kind": "meta",
            "registry_version": REGISTRY_VERSION,
            "digest_slots": [name for name, _ in DIGEST_SLOTS],
            "n_nodes": p.n_nodes,
            "watchdog": bool(p.watchdog),
            "total_instances": total_instances,
        }
        if meta:
            header.update(meta)
        self._emit(header)

    def _emit(self, obj) -> None:
        if self._out is not None:
            with self._wlock:
                self._out.write(json.dumps(obj) + "\n")
                self._out.flush()

    def emit(self, obj: dict) -> None:
        """Append one extra NDJSON line (no-op without ``out``).  Its
        ``kind`` must not be meta, fleet or row: readers dispatch on it."""
        self._emit(obj)

    def set_fleet(self, total: int, n_valid: int) -> None:
        """Fleet geometry from the sharded runtime: ``total`` is the padded
        instance count, which the digest's ``halted`` slot counts (the
        pre-halted padding included), ``n_valid`` the real instances.  Rows
        stay as the device computed them.  Sets ``total_instances`` only
        when the constructor was given none."""
        if self.total_instances is None:
            self.total_instances = total
        self._emit({"kind": "fleet", "total_instances": total,
                    "n_valid": n_valid, "padding": total - n_valid})

    def _row(self, d, t, steps, per_s, **extra) -> dict:
        elapsed = t - self._t0
        row = {"kind": "row", "chunk": len(self.rows), "t_s": round(elapsed, 6),
               "steps": steps, **extra, **d,
               "ev_per_s": round((d["events"] - self._last_events) / per_s, 1)}
        if self.total_instances:
            row["halt_frac"] = round(d["halted"] / self.total_instances, 6)
            # Crude ETA from the mean halting rate so far.
            row["eta_s"] = (
                round(elapsed * (self.total_instances - d["halted"]) / d["halted"], 3)
                if d["halted"] > 0 and elapsed > 0 else None)
        self._last_events = d["events"]
        self.rows.append(row)
        self._emit(row)
        return row

    def record_ring(self, ring, retired, steps=None) -> list[dict]:
        """Append one outer call's retired ring rows (``wrap="device"``): the
        first ``retired`` rows of a fetched ``[ring_k, D]`` ring, oldest
        first.  They were fetched at once, so they share one timestamp and
        carry ``ring_i`` / ``ring_n`` (schema.RING_ROW_FIELDS); each keeps
        its own chunk's cumulative counters, and ``ev_per_s`` spreads the
        poll interval evenly over them.  ``steps``: one step count per row
        (at least ``retired``)."""
        ring = np.asarray(ring)
        n = int(retired)
        if not 1 <= n <= ring.shape[0]:
            raise ValueError(f"retired={n} outside the ring's [1, {ring.shape[0]}] rows")
        t = time.perf_counter()
        per = max(t - self._last_t, 1e-9) / n
        out = [self._row(decode_digest(ring[i]), t, None if steps is None else steps[i],
                         per, ring_i=i, ring_n=n) for i in range(n)]
        self._last_t = t
        return out

    def record(self, digest, steps=None) -> dict:
        """Append one chunk's digest (an already-fetched ``[D]`` vector);
        returns the derived row."""
        t = time.perf_counter()
        row = self._row(decode_digest(digest), t, steps, max(t - self._last_t, 1e-9))
        self._last_t = t
        return row

    def summary(self, tail: int = 8) -> dict:
        """The compact block run-reports and sweep rows attach: registry
        version, chunk count, final digest, mean throughput and the last
        ``tail`` rows."""
        if not self.rows:
            return {"registry_version": REGISTRY_VERSION, "chunks": 0}
        last = self.rows[-1]
        elapsed = max(last["t_s"], 1e-9)
        return {
            "registry_version": REGISTRY_VERSION,
            "chunks": len(self.rows),
            "elapsed_s": last["t_s"],
            "final": {name: last[name] for name, _ in DIGEST_SLOTS},
            "watchdog_flags": last["watchdog_flags"],
            "mean_ev_per_s": round(last["events"] / elapsed, 1),
            "timeline_tail": self.rows[-tail:],
        }

    def close(self) -> None:
        if self._owns_out and self._out is not None:
            self._out.close()
            self._out = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_ndjson(path: str) -> list[dict]:
    """Parse an NDJSON file into row dicts.  An unparseable final line (the
    tail of a writer still running, or killed) is ignored; a corrupt line
    anywhere else raises."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    lines = [ln for ln in lines if ln]
    rows = []
    for i, ln in enumerate(lines):
        try:
            rows.append(json.loads(ln))
        except ValueError:
            if i == len(lines) - 1:
                break
            raise
    return rows


def load_ndjson(path: str) -> tuple[dict, list[dict]]:
    """Read a stream file back: ``(meta, rows)``.  Refuses a file written
    under another :data:`REGISTRY_VERSION`, and a file with no meta line."""
    meta, rows = None, []
    for obj in read_ndjson(path):
        if obj.get("kind") == "meta":
            require_registry_version(obj.get("registry_version"),
                                     what=f"stream file {path}")
            meta = obj
        else:
            rows.append(obj)
    if meta is None:
        raise ValueError(
            f"stream file {path} has no meta line; not a fleet-stream "
            "NDJSON artifact (or written by a pre-stream build, or still "
            "empty — retry once the run has started)")
    return meta, rows
