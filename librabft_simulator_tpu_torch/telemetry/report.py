"""Host-side telemetry exporter: the port of
``librabft_simulator_tpu/telemetry/report.py`` (its single-device half).

The planes stay on the device during the run; this module decodes them
after it:

* :func:`metrics_dict`: one instance's ``[M]`` plane to named values;
* :func:`merged_metrics`: a batch's ``[B, M]`` planes folded per slot kind
  (counters and histograms sum, high-water marks max);
* :func:`decode_flight` / :func:`fleet_flight`: the flight rings in
  chronological order;
* :func:`telemetry_block`: the compact block the sweep rows attach;
* :func:`run_report`, :func:`save_report`, :func:`load_report`.

The port's states always carry the batch dim.  ``instance`` picks one
instance; ``instance=None`` on a batch of one reports that instance, as
the JAX package reports its unbatched state.  The fleet functions also take
a sharded fleet (parallel/mesh.py ``ShardedState``): its shards' rows in
instance order.  Histogram quantiles are ``(lo, hi)`` bucket bounds
(utils/quantile.py).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ..utils import quantile
from ..utils.quantile import histogram_quantile
from . import plane, stream as tstream
from .schema import REGISTRY_VERSION, require_registry_version  # noqa: F401


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _single(st, instance):
    """The row of ``instance``, or of the only instance of a batch of one;
    None for a whole fleet."""
    if instance is not None:
        return instance
    return 0 if st.clock.shape[0] == 1 else None


def _one(st, instance, what):
    i = _single(st, instance)
    if i is None:
        raise ValueError(
            f"{what}: batched fleet state needs instance=<i> to pick one "
            "instance (use merged_metrics/telemetry_block for fleet "
            "aggregates)")
    return i


def metrics_dict(p, st, instance: Optional[int] = None) -> dict:
    """One instance's metrics plane as {slot name: int | list}."""
    i = _one(st, instance, "metrics_dict")
    return plane.decode(p, _np(st.metrics[i]))


def _rows(st, name: str, stop: Optional[int] = None) -> np.ndarray:
    """Leaf ``name`` of a state or a sharded fleet on the host, its first
    ``stop`` instances (all by default), in instance order."""
    shards = getattr(st, "shards", None) or [st]
    out, n = [], 0
    for s in shards:
        if stop is not None and n >= stop:
            break
        x = getattr(s, name)
        k = x.shape[0] if stop is None else min(x.shape[0], stop - n)
        out.append(_np(x[:k]))
        n += k
    return np.concatenate(out, axis=0)


def merged_metrics(p, st) -> dict:
    """The batch's planes folded across instances: counters and histogram
    buckets sum, high-water marks max."""
    vec = plane.fold_planes(p, _rows(st, "metrics"))
    return plane.decode(p, vec)


def _flight_rows(p, fdat: np.ndarray, mdat: np.ndarray, i: int) -> list:
    fr_off, _ = plane.slot(p, "fr_count")
    return [{name: int(fdat[j, col]) for col, name in enumerate(plane.FR_NAMES)}
            for j in plane.ring_order(int(mdat[fr_off]), fdat.shape[0])]


def decode_flight(p, st, instance: Optional[int] = None) -> list[dict]:
    """The flight-recorder tail of one instance, oldest first.  Serial
    rows are chronological; lane rows are appended in (window, drain
    iteration, lane) order."""
    if not p.telemetry:
        return []
    i = _one(st, instance, "decode_flight")
    return _flight_rows(p, _np(st.flight[i]), _np(st.metrics[i]), i)


def fleet_flight(p, st, max_instances: Optional[int] = None) -> list[dict]:
    """Every instance's flight tail in instance order, each row tagged with
    its ``instance``; ``max_instances`` stops at the first k instances."""
    if not p.telemetry:
        return []
    fl, met = _rows(st, "flight", max_instances), _rows(st, "metrics", max_instances)
    return [dict(r, instance=i) for i in range(fl.shape[0])
            for r in _flight_rows(p, fl[i], met[i], i)]


def _quantile_block(counts) -> dict:
    p50 = histogram_quantile(counts, 0.50)
    p99 = histogram_quantile(counts, 0.99)
    return {"count": int(np.sum(counts)),
            "p50_bounds": list(p50), "p99_bounds": list(p99)}


def telemetry_block(p, st) -> dict:
    """The compact fleet-level block for sweep rows: event-kind counts, loss
    tallies, queue pressure and latency quantile bounds, merged across the
    batch (lane runs add the window-health counters)."""
    m = merged_metrics(p, st)
    block = {
        "events": {
            "notify": m["ev_notify"], "request": m["ev_request"],
            "response": m["ev_response"], "timer": m["ev_timer"],
        },
        "drops": m["drops"],
        "overflow": m["overflow"],
        "sync_jumps": m["sync_jumps"],
        "queue_hwm": m["queue_hwm"],
        "node_depth_hwm_max": max(m["node_depth_hwm"]) if m["node_depth_hwm"] else 0,
        "round_latency": _quantile_block(m["round_lat_hist"]),
        "commit_latency": _quantile_block(m["commit_lat_hist"]),
        "commit_lat_miss": m["commit_lat_miss"],
        "fr_count": m["fr_count"],
    }
    if m["windows"]:  # lane-engine window health
        block["windows"] = m["windows"]
        block["horizon_stall"] = m["horizon_stall"]
        block["lane_spill"] = m["lane_spill"]
    return block


def run_report(p, st, instance: Optional[int] = None,
               data_dir: Optional[str] = None, stream=None) -> dict:
    """The run report: the registry version and the final digest, the
    DataWriter summary of one instance (``data_dir`` also writes its
    files), and with telemetry on the telemetry block, the metrics (merged
    for a fleet, else the instance's) and the instance's flight tail.
    ``stream`` (the TimelineRecorder that watched the run) adds its
    summary."""
    from ..analysis import data_writer as dw

    report = {"registry_version": REGISTRY_VERSION}
    report["digest"] = tstream.decode_digest(_np(tstream.compute_digest(p, st)))
    i = _single(st, instance)
    if i is not None:
        if data_dir is not None:
            report["summary"] = dw.DataWriter(p, data_dir).write(st, i)
        else:
            report["summary"] = dw.summary_dict(p, st, i)
    if p.telemetry:
        report["telemetry"] = telemetry_block(p, st)
        if i is None:
            report["metrics"] = merged_metrics(p, st)
        else:
            report["metrics"] = metrics_dict(p, st, i)
            report["flight"] = decode_flight(p, st, i)
        report["histogram_edges"] = [int(e) for e in quantile.histogram_edges()]
    if stream is not None:
        report["stream"] = stream.summary()
    return report


def save_report(path: str, report: dict) -> None:
    """Write a :func:`run_report` dict as JSON (it carries its version)."""
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


def load_report(path: str) -> dict:
    """Read a saved run report, refusing one written under another
    slot-registry version."""
    with open(path) as f:
        report = json.load(f)
    require_registry_version(report.get("registry_version"),
                             what=f"run-report {path}")
    return report
