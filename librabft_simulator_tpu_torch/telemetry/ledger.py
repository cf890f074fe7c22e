"""Runtime ledger: host-side span tracing with compile, dispatch and poll
attribution for the host loops.  The port of
``librabft_simulator_tpu/telemetry/ledger.py``.

The digest stream (telemetry/stream.py) says what the device did; this
ledger says what the host spent its time on.  It records no device work and
launches nothing, so an engine runs the same whether it records or not.

* **Spans**: :meth:`RuntimeLedger.span` is a context manager recording
  ``(kind, t0, dur)`` with monotonic-clock offsets from the ledger's epoch,
  thread-safe, nested (parent and depth from a per-thread stack).  Kinds:
  ``compile`` (a kernel build), ``dispatch`` (the host enqueueing one
  chunk), ``poll`` (the blocking fetch of a chunk's digest, or of a digest
  ring), ``halt_poll`` (the device wrap's lagged read of a chunk's
  ``halted`` slot), ``host_merge`` (post-run host folds), ``run`` (a timed
  section, e.g. a sweep config).  Chunk spans carry ``run=<id>`` and
  ``chunk=<i>``.
* **Compile ledger**: one entry per kernel build (:meth:`compile_attribution`).
  The port has no graph compiler; its one build is ``nvcc`` of the select
  kernel (ops/select_events.py), whose entry carries the nvcc seconds as
  ``compile_s`` and, as ``cache``, whether a current library was already in
  ``build/kernels/`` (``persistent-hit``) or had to be built
  (``persistent-miss``), the verdicts the JAX package takes from its
  compilation cache.
* **Exports**: NDJSON streaming (rows flushed as recorded, a summary row on
  :meth:`close`; the JAX package's ``load_ndjson`` reads these files), a
  Chrome-trace / Perfetto JSON (:meth:`RuntimeLedger.to_perfetto`), and
  :func:`pipeline_stats` / :func:`ring_stats`, the measured overlap,
  bubbles and time to first chunk of a chunked loop and the poll
  amortization of the device-wrap ring.

The port reads no environment variable: where the JAX package streams the
process ledger to ``LIBRABFT_LEDGER_OUT``, a caller here passes the path to
:func:`reset` or :meth:`RuntimeLedger.open_out`.

CLI (no torch import)::

    python -m librabft_simulator_tpu_torch.telemetry.ledger \\
        --attribution ledger.ndjson --out attribution.json
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import threading
import time

from . import schema

LEDGER_VERSION = schema.LEDGER_VERSION

# The span taxonomy (conventions: any string is a legal kind).
COMPILE = "compile"
DISPATCH = "dispatch"
POLL = "poll"
HOST_MERGE = "host_merge"
RUN = "run"
ADMIT = "admit"
EGRESS = "egress"
HANDSHAKE = "handshake"
#: The port's device wrap (parallel/sharded.py), which JAX's in-graph ring
#: loop has no need of: the host's read of a lagged ``halted`` slot before
#: it dispatches another chunk of an outer call.  Attrs: ``lag`` (chunks
#: back; 0 when no copy had landed and nothing was read) and ``waited``
#: (the host waited on the device for the copy).
HALT_POLL = "halt_poll"

#: A poll that returns faster than this found the chunk's digest already on
#: the host: the device finished and idled while the host was still
#: dispatching (a dispatch-queue bubble).
BUBBLE_FLOOR_S = 1e-4


@dataclasses.dataclass
class Span:
    seq: int
    kind: str
    t0_s: float                    # offset from the ledger epoch
    dur_s: float = 0.0
    thread: int = 0
    parent: int | None = None      # seq of the enclosing span, same thread
    depth: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {"kind": "span", "seq": self.seq, "name": self.kind,
                "t0_s": round(self.t0_s, 6), "dur_s": round(self.dur_s, 6),
                "thread": self.thread, "parent": self.parent,
                "depth": self.depth, **self.attrs}


def params_key(p) -> str:
    """Stable short key of a params object (or any value with a stable
    repr): the sha1 prefix of its repr."""
    return hashlib.sha1(repr(p).encode()).hexdigest()[:12]


class RuntimeLedger:
    """Thread-safe host-side span and compile ledger.

    ``clock`` defaults to ``time.perf_counter``; tests pass a fake one.
    ``enabled=False`` stops recording, but spans still time (callers read
    ``sp.dur_s``).  Past ``max_spans`` recorded spans, ``dropped`` counts
    instead."""

    def __init__(self, clock=None, max_spans: int = 250_000, out=None,
                 meta: dict | None = None):
        self._clock = clock if clock is not None else time.perf_counter
        self._lock = threading.RLock()
        self._local = threading.local()
        self._seq = 0
        self._run_seq = 0
        self.enabled = True
        self.max_spans = max_spans
        self.spans: list[Span] = []
        self.dropped = 0
        self.compiles: list[dict] = []   # the compile ledger, append order
        self.unattributed: dict = {}     # kept for the JAX summary schema
        self._out = None
        self._owns_out = False
        self.epoch = self._clock()
        if out is not None:
            self.open_out(out, meta)

    def now(self) -> float:
        """Seconds since the ledger epoch."""
        return self._clock() - self.epoch

    # -- NDJSON streaming ----------------------------------------------

    def open_out(self, out, meta: dict | None = None) -> None:
        """Attach an NDJSON sink (a path or a file-like object): a meta line
        now, then every recorded span and compile row as it lands."""
        self._owns_out = isinstance(out, str)
        self._out = open(out, "w") if self._owns_out else out
        header = {"kind": "meta", "schema": "runtime_ledger",
                  "ledger_version": LEDGER_VERSION, "pid": os.getpid()}
        if meta:
            header.update(meta)
        self._emit(header)

    def _emit(self, obj: dict) -> None:
        if self._out is not None:
            self._out.write(json.dumps(obj) + "\n")
            self._out.flush()

    def close(self) -> None:
        """Emit the summary row and release a sink the ledger opened."""
        with self._lock:
            self._emit({"kind": "summary", **self.summary()})
            if self._owns_out and self._out is not None:
                self._out.close()
            self._out = None

    # -- spans ----------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, kind: str, **attrs):
        """Record one host span; yields the :class:`Span` (``attrs`` may be
        added to inside the block, ``dur_s`` is set after it)."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        with self._lock:
            seq = self._seq
            self._seq += 1
        sp = Span(seq=seq, kind=kind, t0_s=self.now(),
                  thread=threading.get_ident() & 0xFFFFFFFF,
                  parent=parent.seq if parent is not None else None,
                  depth=len(stack), attrs=attrs)
        stack.append(sp)
        try:
            yield sp
        finally:
            stack.pop()
            sp.dur_s = self.now() - sp.t0_s
            if self.enabled:
                with self._lock:
                    if len(self.spans) < self.max_spans:
                        self.spans.append(sp)
                        self._emit(sp.to_json())
                    else:
                        self.dropped += 1

    def new_run(self, label: str, **attrs) -> int:
        """A fresh run id for one host loop; its chunk spans carry it."""
        with self._lock:
            self._run_seq += 1
            rid = self._run_seq
            if self.enabled:
                self._emit({"kind": "run", "run": rid, "label": label,
                            "t0_s": round(self.now(), 6), **attrs})
        return rid

    # -- compile ledger --------------------------------------------------

    @contextlib.contextmanager
    def compile_attribution(self, key: str, **meta):
        """Record one build as a compile-ledger entry inside a ``compile``
        span.  The block fills the yielded entry: ``compile_s`` (the
        compiler's seconds) and ``cache_hits`` / ``cache_misses`` (1 when a
        current build was found / had to be made).  ``first_call_s`` is the
        span's duration; ``cache`` is classified as in the JAX package."""
        entry = {"key": key, **meta, "trace_s": 0.0, "lower_s": 0.0,
                 "compile_s": 0.0, "cache_retrieve_s": 0.0,
                 "cache_hits": 0, "cache_misses": 0}
        sp = None
        try:
            with self.span(COMPILE, key=key) as sp:
                yield entry
        finally:
            entry["first_call_s"] = round(sp.dur_s, 6) if sp is not None else 0.0
            for f in ("trace_s", "lower_s", "compile_s", "cache_retrieve_s"):
                entry[f] = round(entry[f], 6)
            if entry["cache_hits"] and not entry["cache_misses"]:
                entry["cache"] = "persistent-hit"
            elif entry["cache_misses"]:
                entry["cache"] = "persistent-miss"
            elif entry["compile_s"] > 0:
                entry["cache"] = "uncached"
            else:
                entry["cache"] = "memory"
            if self.enabled:
                with self._lock:
                    self.compiles.append(entry)
                    self._emit({"kind": "compile", **entry})

    # -- summaries -------------------------------------------------------

    def _rows(self) -> list[dict]:
        with self._lock:
            return [sp.to_json() for sp in self.spans]

    def span_totals(self) -> dict:
        """{kind: {"count": n, "total_s": s}} over recorded spans."""
        out: dict = {}
        with self._lock:
            spans = list(self.spans)
        for sp in spans:
            row = out.setdefault(sp.kind, {"count": 0, "total_s": 0.0})
            row["count"] += 1
            row["total_s"] += sp.dur_s
        for row in out.values():
            row["total_s"] = round(row["total_s"], 6)
        return out

    def pipeline_stats(self, run: int | None = None) -> dict:
        """:func:`pipeline_stats` of the recorded spans."""
        return pipeline_stats(self._rows(), run=run)

    def ring_stats(self, run: int | None = None) -> dict | None:
        """:func:`ring_stats` of the recorded spans (None for a host-wrap
        loop)."""
        return ring_stats(self._rows(), run=run)

    def summary(self) -> dict:
        comp_s = sum(e["compile_s"] for e in self.compiles)
        return {
            "ledger_version": LEDGER_VERSION,
            "spans": self.span_totals(),
            "spans_dropped": self.dropped,
            "compile_entries": len(self.compiles),
            "compile_s_total": round(comp_s, 3),
            "persistent_cache": {
                "hits": sum(e["cache_hits"] for e in self.compiles),
                "misses": sum(e["cache_misses"] for e in self.compiles),
            },
            "aot": _aot_tally(self.compiles),
            "unattributed": {k: {"count": v[0], "total_s": round(v[1], 6)}
                             for k, v in self.unattributed.items()},
        }

    def to_perfetto(self, path: str | None = None) -> dict:
        """Chrome-trace JSON ('X' complete events, µs timestamps) of the
        recorded spans, for ui.perfetto.dev beside a torch.profiler trace."""
        with self._lock:
            spans = list(self.spans)
        events = [{
            "name": sp.kind,
            "cat": "librabft_host",
            "ph": "X",
            "ts": round(sp.t0_s * 1e6, 3),
            "dur": round(sp.dur_s * 1e6, 3),
            "pid": os.getpid(),
            "tid": sp.thread,
            "args": dict(sp.attrs, seq=sp.seq),
        } for sp in spans]
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"schema": "runtime_ledger",
                          "ledger_version": LEDGER_VERSION},
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def _aot_tally(compiles) -> dict:
    """Prebuilt-executable verdict counts and load seconds (the JAX
    package's AOT store; always zero here, kept for the summary schema)."""
    return {
        "hits": sum(1 for e in compiles if e.get("cache") == "aot-hit"),
        "stale": sum(1 for e in compiles if e.get("cache") == "aot-stale"),
        "load_s": round(sum(e.get("aot_load_s", 0.0) for e in compiles), 3),
    }


# ---------------------------------------------------------------------------
# Pipeline analysis: pure functions of span rows (dicts, as recorded or read
# back from NDJSON).
# ---------------------------------------------------------------------------


def _select_run(spans, run):
    if run is None:
        runs = [r.get("run") for r in spans if r.get("run") is not None]
        run = runs[-1] if runs else None
    if run is not None:
        spans = [r for r in spans if r.get("run") == run]
    return spans, run


def pipeline_stats(rows, run: int | None = None,
                   bubble_floor_s: float = BUBBLE_FLOOR_S) -> dict:
    """The double-buffered loop's measured health, from the ``dispatch`` and
    ``poll`` spans of one run (``run=None``: the last run id present).
    Chunk 0 carries the cold start and is left out of the steady state.

    * ``overlap_fraction`` = poll_s / (poll_s + dispatch_s) over the steady
      chunks: near 1, the host waits on the device with the next chunk
      already queued; near 0, the host (dispatch) is the bottleneck.
    * ``bubbles``: chunks whose poll took under ``bubble_floor_s`` (the
      digest was already on the host: the device sat idle).
    * ``time_to_first_chunk_s``: first dispatch start to first poll end.
    """
    spans = [r for r in rows if r.get("kind") == "span"
             and r.get("name") in (DISPATCH, POLL) and "chunk" in r]
    spans, run = _select_run(spans, run)
    chunks: dict = {}
    for r in spans:
        row = chunks.setdefault(int(r["chunk"]),
                                {"chunk": int(r["chunk"]),
                                 "dispatch_s": 0.0, "poll_s": 0.0})
        row[r["name"] + "_s"] = round(row[r["name"] + "_s"] + float(r["dur_s"]), 6)
    ordered = [chunks[c] for c in sorted(chunks)]
    out = {"run": run, "chunks": len(ordered), "rows": ordered}
    firsts_d = [r for r in spans if r["name"] == DISPATCH]
    firsts_p = [r for r in spans if r["name"] == POLL]
    if firsts_d and firsts_p:
        d0 = min(firsts_d, key=lambda r: r["t0_s"])
        p0 = min(firsts_p, key=lambda r: r["t0_s"])
        out["time_to_first_chunk_s"] = round(p0["t0_s"] + p0["dur_s"] - d0["t0_s"], 6)
    steady = [r for r in ordered if r["chunk"] > 0]
    polled = [r for r in steady if r["poll_s"] > 0 or r["dispatch_s"] > 0]
    dispatch_s = sum(r["dispatch_s"] for r in polled)
    poll_s = sum(r["poll_s"] for r in polled)
    out["dispatch_s"] = round(dispatch_s, 6)
    out["poll_s"] = round(poll_s, 6)
    out["overlap_fraction"] = (round(poll_s / (poll_s + dispatch_s), 4)
                               if poll_s + dispatch_s > 0 else None)
    bubbles = [r["chunk"] for r in polled if r["poll_s"] < bubble_floor_s]
    out["bubbles"] = bubbles
    out["bubble_count"] = len(bubbles)
    return out


def ring_stats(rows, run: int | None = None) -> dict | None:
    """The device-wrap loop's poll amortization, from its ring ``poll``
    spans (one per outer call, carrying ``retired`` and ``cap``) and its
    ``halt_poll`` spans; None when the run has no ring poll (a host-wrap
    loop).

    * ``retired_per_dispatch``: mean chunks retired per outer call;
    * ``polls_per_retired_chunk``: ring fetches (outer calls) / retired
      chunks (1.0 on the host wrap, down to 1/ring_k here);
    * ``ring_full`` / ``early_exit``: outer calls that retired their whole
      budget / stopped short because the fleet halted;
    * ``halt_polls`` / ``halt_waits``: the port's lagged halt reads, and
      those that waited on the device (JAX's in-graph ring has neither);
    * ``fetches_per_retired_chunk``: (ring fetches + halt reads) / retired
      chunks, every host read of device data;
    * ``waits_per_retired_chunk``: (ring fetches + halt reads that waited)
      / retired chunks, the host's waits on the device.
    The keys before ``halt_polls`` are JAX's, computed as JAX computes them.
    """
    spans = [r for r in rows if r.get("kind") == "span"
             and r.get("name") == POLL and "retired" in r]
    spans, run = _select_run(spans, run)
    if not spans:
        return None
    retired = sum(int(r["retired"]) for r in spans)
    full = sum(1 for r in spans if "cap" in r and int(r["retired"]) >= int(r["cap"]))
    halts = [r for r in rows if r.get("kind") == "span" and r.get("name") == HALT_POLL
             and r.get("run") == run]
    reads = sum(1 for r in halts if int(r.get("lag", 0)) > 0)
    waits = sum(1 for r in halts if r.get("waited"))

    def per_retired(n):
        return round(n / retired, 4) if retired else None

    return {
        "run": run,
        "dispatches": len(spans),
        "retired_chunks": retired,
        "retired_per_dispatch": round(retired / len(spans), 4),
        "polls_per_retired_chunk": per_retired(len(spans)),
        "ring_full": full,
        "early_exit": len(spans) - full,
        "halt_polls": reads,
        "halt_waits": waits,
        "fetches_per_retired_chunk": per_retired(len(spans) + reads),
        "waits_per_retired_chunk": per_retired(len(spans) + waits),
    }


def _run_seconds(spans) -> float:
    """Dispatched-work wall time with nesting counted once: dispatch and
    poll spans, less compile time nested inside them, plus each ``run``
    span's time outside its recorded dispatch, poll and compile spans."""
    by_seq = {r["seq"]: r for r in spans if "seq" in r}

    def ancestors(r):
        seen = set()
        while r.get("parent") is not None and r["parent"] not in seen:
            seen.add(r["parent"])
            r = by_seq.get(r["parent"])
            if r is None:
                return
            yield r

    disp_poll = [r for r in spans if r.get("name") in (DISPATCH, POLL)]
    nested_compile = 0.0
    run_children: dict = {}
    for r in spans:
        if r.get("name") not in (DISPATCH, POLL, COMPILE):
            continue
        anc = list(ancestors(r))
        if r["name"] == COMPILE:
            if any(a.get("name") in (DISPATCH, POLL) for a in anc):
                nested_compile += float(r["dur_s"])
                continue
        elif any(a.get("name") in (DISPATCH, POLL) for a in anc):
            continue
        for a in anc:
            if a.get("name") == RUN:
                run_children[a["seq"]] = run_children.get(a["seq"], 0.0) + float(r["dur_s"])
                break
    run_exclusive = sum(
        max(0.0, float(r["dur_s"]) - run_children.get(r.get("seq"), 0.0))
        for r in spans if r.get("name") == RUN)
    total = sum(float(r["dur_s"]) for r in disp_poll)
    return max(0.0, total - nested_compile) + run_exclusive


def compile_attribution_summary(rows, top: int = 10) -> dict:
    """Compile-vs-run wall-time attribution of loaded ledger rows: the
    builds (per key, with their cache verdicts) against dispatched work."""
    compiles = [r for r in rows if r.get("kind") == "compile"]
    spans = [r for r in rows if r.get("kind") == "span"]
    span_totals: dict = {}
    for r in spans:
        t = span_totals.setdefault(r["name"], {"count": 0, "total_s": 0.0})
        t["count"] += 1
        t["total_s"] = round(t["total_s"] + float(r["dur_s"]), 6)
    compile_s = sum(e.get("compile_s", 0.0) for e in compiles)
    trace_s = sum(e.get("trace_s", 0.0) + e.get("lower_s", 0.0) for e in compiles)
    first_call_s = sum(e.get("first_call_s", 0.0) for e in compiles)
    run_s = _run_seconds(spans)
    summaries = [r for r in rows if r.get("kind") == "summary"]
    unattributed = summaries[-1].get("unattributed", {}) if summaries else {}
    by_key: dict = {}
    for e in compiles:
        k = by_key.setdefault(e.get("key", "?"), {
            "key": e.get("key", "?"), "builds": 0, "compile_s": 0.0,
            "cache": {}, "meta": {kk: e[kk] for kk in ("engine", "n_nodes") if kk in e}})
        k["builds"] += 1
        k["compile_s"] = round(k["compile_s"] + e.get("compile_s", 0.0), 6)
        verdict = e.get("cache", "?")
        k["cache"][verdict] = k["cache"].get(verdict, 0) + 1
    ranked = sorted(by_key.values(), key=lambda k: -k["compile_s"])
    return {
        "ledger_version": LEDGER_VERSION,
        "compile": {
            "entries": len(compiles),
            "distinct_keys": len(by_key),
            "compile_s": round(compile_s, 3),
            "trace_lower_s": round(trace_s, 3),
            "first_call_s": round(first_call_s, 3),
            "persistent_cache": {
                "hits": sum(e.get("cache_hits", 0) for e in compiles),
                "misses": sum(e.get("cache_misses", 0) for e in compiles),
            },
            "aot": _aot_tally(compiles),
            "top": ranked[:top],
        },
        "spans": span_totals,
        "unattributed": unattributed,
        "compile_vs_run": {
            "compile_s": round(compile_s, 3),
            "run_s": round(run_s, 3),
            "compile_fraction": (round(compile_s / (compile_s + run_s), 4)
                                 if compile_s + run_s > 0 else None),
        },
    }


# ---------------------------------------------------------------------------
# NDJSON loading (an unparseable final line, a writer's mid-write tail, is
# ignored).
# ---------------------------------------------------------------------------


def read_ndjson(path: str, tolerant: bool = True) -> list[dict]:
    """Parse an NDJSON file into row dicts; with ``tolerant`` an
    unparseable final line is skipped, a corrupt line elsewhere raises."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    lines = [ln for ln in lines if ln]
    rows = []
    for i, ln in enumerate(lines):
        try:
            rows.append(json.loads(ln))
        except ValueError:
            if tolerant and i == len(lines) - 1:
                break
            raise
    return rows


def load_ndjson(path: str) -> tuple[dict, list[dict]]:
    """Read a ledger stream back: ``(meta, rows)``.  Refuses a file of
    another :data:`LEDGER_VERSION` and a file that is not a ledger."""
    rows = read_ndjson(path)
    metas = [r for r in rows if r.get("kind") == "meta"]
    if not metas or metas[0].get("schema") != "runtime_ledger":
        raise ValueError(
            f"{path}: no runtime_ledger meta line; not a ledger NDJSON "
            "artifact (fleet digest streams are read by fleet_watch "
            "without --ledger)")
    meta = metas[0]
    schema.require_ledger_version(meta.get("ledger_version"), what=path)
    return meta, [r for r in rows if r.get("kind") != "meta"]


# ---------------------------------------------------------------------------
# The process ledger.
# ---------------------------------------------------------------------------

_PROCESS: RuntimeLedger | None = None
_PROCESS_LOCK = threading.Lock()


def get() -> RuntimeLedger:
    """The process-wide ledger (created in memory, with no sink, at first
    use; :func:`reset` replaces it)."""
    global _PROCESS
    if _PROCESS is None:
        with _PROCESS_LOCK:
            if _PROCESS is None:
                _PROCESS = RuntimeLedger()
    return _PROCESS


def reset(clock=None, out=None, meta: dict | None = None) -> RuntimeLedger:
    """Replace the process ledger with a fresh one: an optional clock, and
    an optional NDJSON sink ``out`` (a path or a file-like object; the
    caller closes it with ``get().close()``)."""
    global _PROCESS
    with _PROCESS_LOCK:
        _PROCESS = RuntimeLedger(clock=clock, out=out, meta=meta)
    return _PROCESS


# ---------------------------------------------------------------------------
# CLI: compile-vs-run attribution of a streamed ledger file.
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Summarize a streamed runtime-ledger NDJSON file")
    ap.add_argument("--attribution", metavar="NDJSON", required=True,
                    help="ledger stream (a path given to reset(out=) or open_out)")
    ap.add_argument("--out", default=None,
                    help="write the attribution JSON here too")
    ap.add_argument("--perfetto", default=None, metavar="PATH",
                    help="additionally re-export the spans as a "
                         "Chrome-trace/Perfetto JSON")
    args = ap.parse_args(argv)
    try:
        meta, rows = load_ndjson(args.attribution)
    except (OSError, ValueError) as e:
        print(f"ledger: {e}", file=sys.stderr)
        return 1
    summary = compile_attribution_summary(rows)
    summary["source"] = args.attribution
    summary["pid"] = meta.get("pid")
    # The overlap headline means something only for a double-buffered loop
    # (run rows with pipeline=True); a loop that polls the chunk it just
    # dispatched would read ~1.0 without meaning it.
    pipelined = [r["run"] for r in rows if r.get("kind") == "run" and r.get("pipeline")]
    pipe = pipeline_stats(rows, run=pipelined[-1]) if pipelined else None
    if pipe and pipe["chunks"]:
        summary["pipeline"] = {k: pipe[k] for k in
                               ("run", "chunks", "overlap_fraction",
                                "bubble_count", "time_to_first_chunk_s")
                               if k in pipe}
    if args.perfetto:
        spans = [r for r in rows if r.get("kind") == "span"]
        doc = {"traceEvents": [{
            "name": r["name"], "cat": "librabft_host", "ph": "X",
            "ts": round(float(r["t0_s"]) * 1e6, 3),
            "dur": round(float(r["dur_s"]) * 1e6, 3),
            "pid": meta.get("pid", 0), "tid": r.get("thread", 0),
            "args": {k: v for k, v in r.items()
                     if k not in ("kind", "name", "t0_s", "dur_s",
                                  "thread", "parent", "depth")},
        } for r in spans], "displayTimeUnit": "ms"}
        with open(args.perfetto, "w") as f:
            json.dump(doc, f)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
