"""The port's runtime ledger (librabft_simulator_tpu_torch/telemetry/
ledger.py) against the JAX package's on the CPU.

(a) the same calls under the same deterministic clock give the same spans,
    ``span_totals``, ``summary`` and Perfetto export in both packages;
(b) the module functions (``pipeline_stats``, ``ring_stats``,
    ``_run_seconds``, ``compile_attribution_summary``) give JAX's results on
    the same synthetic rows;
(c) JAX's ``load_ndjson`` reads the port's NDJSON, and the ``--attribution``
    CLIs agree on it;
(d) the compile ledger records the kernel build: a current library is a
    ``persistent-hit``, a build a ``persistent-miss`` with its nvcc seconds;
(e) both engines' host loops record one dispatch and one poll span per
    chunk; the stream's ring rows and fleet line are JAX's.

No JAX executable is built: the JAX ledger and stream helpers are host-only.
"""

import json

import numpy as np
import pytest

from fleet_shapes import FLEET_B, FLEET_CHUNK, FLEET_SER_KW
from librabft_simulator_tpu.telemetry import ledger as jledger
from librabft_simulator_tpu.telemetry import schema as jschema
from librabft_simulator_tpu.telemetry import stream as jstream
from tests.port_support import import_torch


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, ledger, stream, schema, SimParams, S, P, sel
    torch = import_torch()
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.ops import select_events as sel
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S
    from librabft_simulator_tpu_torch.telemetry import ledger, schema, stream


class FakeClock:
    """Deterministic monotonic clock: every read advances by ``tick``."""

    def __init__(self, tick=0.5):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        t = self.t
        self.t += self.tick
        return t


def drive(mod, out=None):
    """One script of ledger calls (runs, nested spans, a compile entry of
    each verdict, a ring poll) on ``mod``'s RuntimeLedger."""
    lg = mod.RuntimeLedger(clock=FakeClock(0.25), out=out, meta={"argv0": "test"})
    rid = lg.new_run("run_sharded", devices=2, pipeline=True, chunk_steps=8)
    with lg.span(mod.RUN, what="sweep_config"):
        for c in range(3):
            with lg.span(mod.DISPATCH, run=rid, chunk=c):
                if c == 0:
                    with lg.compile_attribution("k-miss", engine="select_events") as e:
                        e["cache_misses"], e["compile_s"] = 1, 2.5
            with lg.span(mod.POLL, run=rid, chunk=c):
                pass
    with lg.compile_attribution("k-hit", engine="select_events") as e:
        e["cache_hits"] = 1
    with lg.compile_attribution("k-memory"):
        pass
    rid2 = lg.new_run("run_sharded", dispatch_wrap="device", ring_k=4)
    with lg.span(mod.POLL, run=rid2, chunk=0, cap=4) as sp:
        sp.attrs["retired"] = 3
    with lg.span(mod.HOST_MERGE, run=rid2):
        pass
    return lg


def rows_of(lg):
    return [sp.to_json() for sp in lg.spans]


def test_ledger_objects_match_jax(tmp_path, monkeypatch):
    """(a), (c): spans, totals, summary, Perfetto, NDJSON and the compile
    entries of one script equal JAX's; JAX reads the port's stream."""
    from librabft_simulator_tpu.utils import cache as jcache

    # A JAX compilation cache stamped by another toolchain would make JAX's
    # miss a "stale-toolchain" miss; the port has no such cache.
    monkeypatch.setattr(jcache, "stale_toolchain", lambda: None)
    paths = {m: str(tmp_path / f"{m}.ndjson") for m in ("jax", "port")}
    got, want = drive(ledger, paths["port"]), drive(jledger, paths["jax"])
    assert rows_of(got) == rows_of(want)
    assert got.span_totals() == want.span_totals()
    assert got.summary() == want.summary()
    assert got.compiles == want.compiles
    assert [e["cache"] for e in got.compiles] == ["persistent-miss", "persistent-hit", "memory"]
    assert got.pipeline_stats() == want.pipeline_stats()
    assert jax_keys_equal(got.ring_stats(), want.ring_stats())
    assert got.pipeline_stats(run=1) == want.pipeline_stats(run=1)
    assert got.to_perfetto(str(tmp_path / "p.json")) == want.to_perfetto()
    with open(tmp_path / "p.json") as f:
        assert json.load(f) == want.to_perfetto()
    got.close(), want.close()
    for path in paths.values():   # JAX's reader on both files
        jledger.load_ndjson(path)
    assert jledger.load_ndjson(paths["port"]) == jledger.load_ndjson(paths["jax"])
    assert ledger.load_ndjson(paths["port"]) == jledger.load_ndjson(paths["port"])
    out = {m: str(tmp_path / f"{m}.json") for m in paths}
    assert ledger.main(["--attribution", paths["port"], "--out", out["port"]]) == 0
    assert jledger.main(["--attribution", paths["port"], "--out", out["jax"]]) == 0
    with open(out["port"]) as a, open(out["jax"]) as b:
        assert json.load(a) == json.load(b)
    with pytest.raises(ValueError, match="ledger_version"):
        bad = tmp_path / "bad.ndjson"
        bad.write_text(json.dumps({"kind": "meta", "schema": "runtime_ledger",
                                   "ledger_version": 99}) + "\n")
        ledger.load_ndjson(str(bad))
    assert ledger.main(["--attribution", str(tmp_path / "missing.ndjson")]) == 1


def jax_keys_equal(got, want):
    """The port's ring_stats against JAX's: JAX's keys equal (the port adds
    its halt-read counts after them)."""
    if want is None:
        return got is None
    return {k: got[k] for k in want} == want and list(got)[:len(want)] == list(want)


def _row(name, run, chunk, t0, dur, seq=0, parent=None, **kw):
    return {"kind": "span", "name": name, "run": run, "chunk": chunk, "t0_s": t0,
            "dur_s": dur, "thread": 1, "parent": parent, "depth": 0, "seq": seq, **kw}


def test_module_functions_match_jax():
    """(b): the pure row functions on synthetic rows, JAX's results."""
    rows = [
        _row("dispatch", 7, 0, 0.0, 4.0), _row("poll", 7, 0, 4.0, 1.0),
        _row("dispatch", 7, 1, 5.0, 0.1), _row("poll", 7, 1, 5.1, 0.9),
        _row("dispatch", 7, 2, 6.0, 0.3), _row("poll", 7, 2, 6.3, 0.00001),
        _row("dispatch", 8, 1, 9.0, 5.0),
        _row("poll", 3, 0, 0.1, 0.5, retired=4, cap=4),
        _row("poll", 3, 1, 0.7, 0.5, retired=2, cap=4),
        _row("poll", 4, 0, 9.0, 0.5, retired=1, cap=4),
        _row("halt_poll", 3, 1, 0.2, 0.01, lag=1, waited=False),
        _row("halt_poll", 3, 2, 0.3, 0.2, lag=2, waited=True),
        _row("halt_poll", 3, 3, 0.6, 0.001, lag=0, waited=False),
        _row("run", None, 0, 0.0, 9.0, seq=1),
        _row("dispatch", None, 5, 1.0, 3.0, seq=2, parent=1),
        _row("compile", None, 5, 1.5, 1.0, seq=3, parent=2),
        {"kind": "compile", "key": "k", "engine": "select_events", "compile_s": 2.0,
         "cache": "persistent-miss", "cache_misses": 1, "first_call_s": 2.1},
        {"kind": "summary", "unattributed": {}},
    ]
    for run in (None, 7, 8, 3, 4, 99):
        assert ledger.pipeline_stats(rows, run=run) == jledger.pipeline_stats(rows, run=run)
        assert jax_keys_equal(ledger.ring_stats(rows, run=run), jledger.ring_stats(rows, run=run))
    # The port's halt reads: run 3 read two lagged halted slots (one waited)
    # and retired 6 chunks in 2 ring fetches; run 4 read none.
    extra = ("halt_polls", "halt_waits", "fetches_per_retired_chunk", "waits_per_retired_chunk")
    assert [ledger.ring_stats(rows, run=3)[k] for k in extra] == [2, 1, 0.6667, 0.5]
    assert [ledger.ring_stats(rows, run=4)[k] for k in extra] == [0, 0, 1.0, 1.0]
    assert ledger.pipeline_stats(rows, run=7, bubble_floor_s=0.5) == \
        jledger.pipeline_stats(rows, run=7, bubble_floor_s=0.5)
    assert ledger.BUBBLE_FLOOR_S == jledger.BUBBLE_FLOOR_S
    spans = [r for r in rows if r["kind"] == "span"]
    assert ledger._run_seconds(spans) == pytest.approx(jledger._run_seconds(spans))
    assert ledger.compile_attribution_summary(rows) == jledger.compile_attribution_summary(rows)
    assert ledger.LEDGER_VERSION == jledger.LEDGER_VERSION
    for kind in ("COMPILE", "DISPATCH", "POLL", "HOST_MERGE", "RUN", "ADMIT", "EGRESS",
                 "HANDSHAKE"):
        assert getattr(ledger, kind) == getattr(jledger, kind)
    assert schema.RING_ROW_FIELDS == jschema.RING_ROW_FIELDS
    lg = ledger.RuntimeLedger(clock=FakeClock(), max_spans=2)
    for _ in range(4):
        with lg.span("poll", chunk=0):
            pass
    assert len(lg.spans) == 2 and lg.dropped == 2
    lg.enabled = False
    with lg.span("run") as sp:
        pass
    assert sp.dur_s == 0.5 and len(lg.spans) == 2


def test_kernel_build_is_a_compile_entry(tmp_path, monkeypatch):
    """(d): ops/select_events.build records the nvcc build on the process
    ledger: a miss with its seconds, then a hit."""
    lib = tmp_path / "libselect_events.so"
    monkeypatch.setattr(sel, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(sel, "LIB_PATH", str(lib))

    class Done:
        returncode, stdout, stderr = 0, "", ""

    def fake_nvcc(cmd, **kw):
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("built")
        return Done()

    monkeypatch.setattr(sel.subprocess, "run", fake_nvcc)
    lg = ledger.reset(clock=FakeClock(1.0))
    assert sel.build() == str(lib) and sel.build() == str(lib)
    miss, hit = lg.compiles
    assert miss["cache"] == "persistent-miss" and miss["cache_misses"] == 1
    assert miss["compile_s"] > 0 and miss["engine"] == "select_events"
    assert hit["cache"] == "persistent-hit" and hit["compile_s"] == 0.0
    assert miss["key"] == hit["key"] and hit["first_call_s"] == 1.0
    assert [sp.kind for sp in lg.spans] == ["compile", "compile"]


def test_host_loops_record_chunk_spans(tmp_path):
    """(e): run_to_completion on both engines (plain and stream loops)
    records one dispatch and one poll span per chunk under its run id; the
    recorder's ring rows and fleet line are JAX's recorder's."""
    lg = ledger.reset(out=str(tmp_path / "l.ndjson"))
    p = SimParams(max_clock=30, **FLEET_SER_KW)
    seeds = np.arange(FLEET_B)
    S.run_to_completion(p, S.init_batch(p, seeds, device="cpu"), chunk=FLEET_CHUNK // 4)
    chunks = S.run_to_completion.last_steps // (FLEET_CHUNK // 4)
    assert chunks > 1
    pipe = lg.pipeline_stats()
    assert [r["chunk"] for r in pipe["rows"]] == list(range(chunks))
    assert all(r["dispatch_s"] > 0 and r["poll_s"] > 0 for r in pipe["rows"])
    pl = SimParams(n_nodes=4, delay_kind="uniform", max_clock=20)
    with stream.TimelineRecorder(pl) as rec:
        P.run_to_completion(pl, P.init_batch(pl, seeds[:2], device="cpu"), stream=rec)
    assert lg.pipeline_stats()["chunks"] == len(rec.rows)
    runs = [r for r in ledger.read_ndjson(str(tmp_path / "l.ndjson")) if r["kind"] == "run"]
    assert [r["label"] for r in runs] == ["run_to_completion", "stream_completion"]
    lg.close()
    ledger.reset()
    ring = np.arange(3 * 13, dtype=np.int32).reshape(3, 13)
    out = {}
    for name, mod in (("port", stream), ("jax", jstream)):
        path = str(tmp_path / f"{name}.ndjson")
        with mod.TimelineRecorder(p, out=path) as r:
            r.set_fleet(total=6, n_valid=5)
            r.record_ring(ring, 2, steps=[32, 64])
            r.emit({"kind": "note", "x": 1})
        out[name] = [{k: v for k, v in row.items() if k not in ("t_s", "ev_per_s", "eta_s")}
                     for row in jledger.read_ndjson(path)]
    assert out["port"] == out["jax"]
    with pytest.raises(ValueError, match="retired"):
        stream.TimelineRecorder(p).record_ring(ring, 0)
