"""DataWriter: round-switch and message statistics, the port of
``librabft_simulator_tpu/analysis/data_writer.py``.

The engines record round switches in the state's ``trace_*`` ring on the
device; this module decodes the ring after the run.  Outputs match the
reference formats: ``round_switches.txt`` (CSV, one column per node, row r =
global time the node entered round r, empty if never),
``number_of_messages.txt``, and a JSON summary.  For equal state leaves the
files are byte for byte those of the JAX package.

The port's states always carry the batch dim: ``instance`` picks one
instance, and ``instance=None`` reports the only instance of a batch of one
(the JAX package's unbatched state).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Optional

import numpy as np

from ..core.types import SimParams


def ring_order(count: int, cap: int) -> list:
    """Chronological storage indices of a capacity-``cap`` append ring after
    ``count`` appends, oldest surviving entry first (a copy of the JAX
    package's ``telemetry/plane.py::ring_order``)."""
    if cap <= 0:
        return []
    if count > cap:
        start = count % cap
        return [(start + i) % cap for i in range(cap)]
    return list(range(count))


def _row(x, instance):
    a = x.detach().cpu().numpy()
    if instance is None:
        if a.shape[0] != 1:
            raise ValueError(
                f"instance=None needs a batch of one instance, got {a.shape[0]}")
        instance = 0
    return a[instance]


def round_switch_table(p: SimParams, st, instance: Optional[int] = None):
    """[max_round+1, N] global times; -1 = the node never entered that round."""
    node, rnd, time = (_row(st.trace_node, instance), _row(st.trace_round, instance),
                       _row(st.trace_time, instance))
    count = int(_row(st.trace_count, instance))
    # Chronological decode: after overflow only the last T switches survive,
    # rotated in storage, and the first write of a (round, node) cell wins.
    max_round = int(rnd.max(initial=0))
    out = np.full((max_round + 1, p.n_nodes), -1, np.int64)
    for i in ring_order(count, p.trace_cap):
        r, a, t = int(rnd[i]), int(node[i]), int(time[i])
        if out[r, a] < 0:
            out[r, a] = t
    return out


def summary_dict(p: SimParams, st, instance: Optional[int] = None,
                 table: Optional[np.ndarray] = None) -> dict:
    """The DataWriter summary as a plain dict (no files)."""
    if table is None:
        table = round_switch_table(p, st, instance)
    # The serial engine counts shared-queue overflow; the lane engine
    # counts per-receiver inbox overflow.
    full = st.n_queue_full if hasattr(st, "n_queue_full") else st.n_inbox_full
    return {
        "n_nodes": p.n_nodes,
        "clock": int(_row(st.clock, instance)),
        "n_events": int(_row(st.n_events, instance)),
        "n_msgs_sent": int(_row(st.n_msgs_sent, instance)),
        "n_msgs_dropped": int(_row(st.n_msgs_dropped, instance)),
        "n_queue_full": int(_row(full, instance)),
        "commit_count": _row(st.ctx.commit_count, instance).tolist(),
        "sync_jumps": _row(st.ctx.sync_jumps, instance).tolist(),
        "max_round": int(table.shape[0]) - 1,
    }


class DataWriter:
    """Host-side writer consuming a finished SimState or PSimState."""

    def __init__(self, p: SimParams, path: str):
        self.p = p
        self.path = path
        os.makedirs(path, exist_ok=True)

    def write(self, st, instance: Optional[int] = None) -> dict:
        p = self.p
        table = round_switch_table(p, st, instance)

        with open(os.path.join(self.path, "round_switches.txt"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow([f"node {i}" for i in range(p.n_nodes)])
            for row in table:
                w.writerow(["" if t < 0 else int(t) for t in row])

        summary = summary_dict(p, st, instance, table=table)
        with open(os.path.join(self.path, "number_of_messages.txt"), "w") as f:
            f.write(f"{summary['n_msgs_sent']}\n")

        with open(os.path.join(self.path, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        return summary
