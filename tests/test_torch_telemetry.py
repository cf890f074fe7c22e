"""The port's telemetry plane, consensus watchdog, digest stream and
checkpoints (librabft_simulator_tpu_torch/telemetry/, sim/checkpoint.py)
against the references on the CPU.

One serial Byzantine micro fleet and one lane fleet, the ones
tests/test_stream.py runs (``FLEET_WD_*_KW``, ``FLEET_B`` seeds, one
instance with enough silent nodes to stall, one with a doctored committed
log that trips the safety detectors), each through the port's
``run_to_completion(stream=)``:

(a) serial: the watchdog and the final digest against the oracle; the
    decoded plane against the oracle's telemetry mirror (kind counts, queue
    high-water marks, latency histograms bucketed with the JAX package's
    ``bucket_np``, commit-latency misses, the flight tail).  Every leaf
    against the JAX engine's run of the fleet is a ``slow`` case in
    tests/test_torch_wide.py: its executable costs 30-60 s to load here;
(b) lane: the oracle's sync-jump, round-regression and conflict counts
    (the stall and saturation detectors count at window granularity there),
    the plane's counters against the state's, the NDJSON round trip;
(c) the host helpers against JAX's on the same numpy inputs;
(d) checkpoints: a JAX checkpoint of an initial state loads into the port
    and runs on, through a save, load and resume, to the uninterrupted
    run's leaves; the port's loads into JAX's ``checkpoint.load``; the
    lane engine's save, load and resume equals its uninterrupted run;
(e) with both planes off the protocol leaves are those of the run with
    them on, and the plane leaves are zero-width;
(f) the sweeps' telemetry rows and stream summaries.
"""

import json
import types

import jax
import numpy as np
import pytest

from fleet_shapes import FLEET_B, FLEET_CHUNK, FLEET_WD_LANE_KW, FLEET_WD_SER_KW
from librabft_simulator_tpu.sim import checkpoint as jckpt
from librabft_simulator_tpu.sim import simulator as JS
from librabft_simulator_tpu.telemetry import plane as jplane
from librabft_simulator_tpu.telemetry import report as jreport
from librabft_simulator_tpu.telemetry import schema as jschema
from librabft_simulator_tpu.telemetry import stream as jstream
from librabft_simulator_tpu.utils import quantile as JQ
from tests.port_support import import_torch, port_byz_fleet
from tests.test_stream import (DOCTOR_I, P_WD_LANE, P_WD_SER, SEEDS, SILENT_I,
                               oracle_fleet, silent_nodes)

PLANES = ("metrics", "flight", "wd")


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, convert, SimParams, S, P, ckpt, plane, report, schema, stream, quantile
    torch = import_torch()
    from librabft_simulator_tpu_torch import convert
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.sim import checkpoint as ckpt
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S
    from librabft_simulator_tpu_torch.telemetry import plane, report, schema, stream
    from librabft_simulator_tpu_torch.utils import quantile


def port_params(kw, **extra):
    return SimParams(**{**kw, **extra})


def ser_params(**extra):
    """P_WD_SER of tests/test_stream.py on the port."""
    return port_params(FLEET_WD_SER_KW, **{"max_clock": P_WD_SER.max_clock, **extra})


def lane_params(**extra):
    """P_WD_LANE of tests/test_stream.py on the port."""
    return port_params(FLEET_WD_LANE_KW, **{"max_clock": P_WD_LANE.max_clock, **extra})


def port_fleet(p, engine):
    """tests/test_stream.py's byz_fleet_state on the port."""
    return port_byz_fleet(engine, p, SEEDS, SILENT_I, silent_nodes(p), DOCTOR_I)


def leaves(jst):
    return {jax.tree_util.keystr(k).lstrip("."): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(jst)}


def assert_leaves_equal(got, want, skip=()):
    assert list(got) == list(want)
    for k in want:
        if k in skip:
            continue
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def digest_slots(row):
    return {name: row[name] for name, _ in jschema.DIGEST_SLOTS}


@pytest.fixture(scope="module")
def port_ser(tmp_path_factory):
    p = ser_params()
    path = str(tmp_path_factory.mktemp("port") / "ser.ndjson")
    with stream.TimelineRecorder(p, total_instances=FLEET_B, out=path) as rec:
        st = S.run_to_completion(p, port_fleet(p, S), chunk=FLEET_CHUNK, stream=rec)
    return dict(p=p, st=st, rec=rec, path=path, steps=S.run_to_completion.last_steps)


@pytest.fixture(scope="module")
def port_lane(tmp_path_factory):
    p = lane_params()
    path = str(tmp_path_factory.mktemp("port") / "lane.ndjson")
    with stream.TimelineRecorder(p, total_instances=FLEET_B, out=path) as rec:
        st = P.run_to_completion(p, port_fleet(p, P), stream=rec)
    return dict(p=p, st=st, rec=rec, path=path)


def test_serial_watchdog_and_plane_against_oracle(port_ser):
    p, st = port_ser["p"], port_ser["st"]
    assert port_ser["steps"] == len(port_ser["rec"].rows) * FLEET_CHUNK
    orcs = oracle_fleet(P_WD_SER)
    dev = stream.decode_digest(stream.compute_digest(p, st).numpy())
    assert dev == jstream.fold_digests(o.digest() for o in orcs)
    assert dev["wd_stall"] >= 1 and dev["wd_safety_conflict"] >= 1
    assert dev["wd_round_regress"] >= 1 and dev["halted"] == FLEET_B
    assert digest_slots(port_ser["rec"].rows[-1]) == digest_slots(dev)
    wd = st.wd.numpy()
    for i, orc in enumerate(orcs):
        assert wd[i].tolist() == [orc.wd[k] for k in stream.WD_SLOTS], i
        md = report.metrics_dict(p, st, i)
        ev = [md["ev_notify"], md["ev_request"], md["ev_response"], md["ev_timer"]]
        assert ev == orc.tel["ev_kind"] and sum(ev) == orc.n_events == md["fr_count"]
        assert md["drops"] == orc.n_msgs_dropped and md["overflow"] == orc.n_queue_full
        assert md["sync_jumps"] == sum(c.sync_jumps for c in orc.ctxs)
        assert md["queue_hwm"] == orc.tel["queue_hwm"] > 0
        assert md["node_depth_hwm"] == orc.tel["node_depth_hwm"]
        assert md["commit_lat_miss"] == orc.tel["commit_lat_miss"]
        for name, lats in (("round_lat_hist", orc.tel["round_lats"]),
                           ("commit_lat_hist", orc.tel["commit_lats"])):
            want = np.bincount(JQ.bucket_np(lats), minlength=JQ.HIST_BUCKETS) \
                if lats else np.zeros(JQ.HIST_BUCKETS, np.int64)
            assert md[name] == want.tolist(), (i, name)
        assert report.decode_flight(p, st, i) == orc.tel["flight"][-p.flight_cap:]
    assert any(o.tel["commit_lats"] for o in orcs)
    # Clean instances trip nothing.
    for i in (0, 1, 4):
        assert not wd[i, 1:].any(), i


def test_lane_watchdog_counters_and_stream(port_lane):
    p, st = port_lane["p"], port_lane["st"]
    orcs = oracle_fleet(P_WD_LANE)
    wd = st.wd.numpy()
    # The per-event detectors match the oracle on every instance; stall and
    # queue_sat count at window granularity on the lane engine.
    for i, orc in enumerate(orcs):
        for det in ("sync_jump", "safety_conflict", "round_regress"):
            assert wd[i, stream.WD_SLOTS.index(det)] == orc.wd[det], (i, det)
    assert wd[DOCTOR_I, stream.WD_SAFETY_CONFLICT] >= 1
    assert wd[DOCTOR_I, stream.WD_ROUND_REGRESS] >= 1
    assert wd[SILENT_I, stream.WD_STALL] >= 1
    for i in (0, 1, 4):
        assert not wd[i, 1:].any(), i
    ref = convert.to_reference(st)
    for i in range(FLEET_B):
        md = report.metrics_dict(p, st, i)
        ev = md["ev_notify"] + md["ev_request"] + md["ev_response"] + md["ev_timer"]
        assert ev == md["fr_count"] == ref["n_events"][i]
        assert md["drops"] == ref["n_msgs_dropped"][i]
        assert md["overflow"] == ref["n_inbox_full"][i]
        assert md["sync_jumps"] == ref["ctx.sync_jumps"][i].sum()
        assert md["windows"] > 0
        depth = ref["in_valid"][i].sum(axis=1)
        assert (np.asarray(md["node_depth_hwm"]) >= depth).all()
        assert md["queue_hwm"] >= depth.sum()
    block = report.telemetry_block(p, st)
    assert block["windows"] > 0 and block["fr_count"] == int(ref["n_events"].sum())
    # Stream: the last row is the final state's digest; both packages read
    # the file back row for row.
    rows = port_lane["rec"].rows
    dev = stream.decode_digest(stream.compute_digest(p, st).numpy())
    assert digest_slots(rows[-1]) == digest_slots(dev) and rows[-1]["halt_frac"] == 1.0
    for load in (stream.load_ndjson, jstream.load_ndjson):
        meta, back = load(port_lane["path"])
        assert meta["registry_version"] == 1 and meta["watchdog"] is True
        assert back == rows


def test_host_helpers_match_jax(port_ser, tmp_path):
    jp, p = P_WD_SER, port_ser["p"]
    rng = np.random.default_rng(3)
    m = port_ser["st"].metrics.numpy()
    assert plane.np_registry(p) == jplane.np_registry(jp)
    assert plane.width(p) == jplane.width(jp) == m.shape[1]
    for i in range(FLEET_B):
        assert plane.decode(p, m[i]) == jplane.decode(jp, m[i])
    noise = rng.integers(0, 1000, m.shape).astype(np.int32)
    for planes in (m, noise, noise[:0]):
        np.testing.assert_array_equal(plane.fold_planes(p, planes),
                                      jplane.fold_planes(jp, planes))
    jst = types.SimpleNamespace(metrics=m)
    assert report.merged_metrics(p, port_ser["st"]) == jreport.merged_metrics(jp, jst)
    assert report.telemetry_block(p, port_ser["st"]) == jreport.telemetry_block(jp, jst)
    for count, cap in ((0, 4), (3, 4), (4, 4), (11, 4), (5, 0)):
        assert plane.ring_order(count, cap) == jplane.ring_order(count, cap)
    # Histogram helpers, ties at the edges included.
    x = np.concatenate([rng.integers(-3, 40000, 200), JQ.histogram_edges(),
                        JQ.histogram_edges() - 1])
    np.testing.assert_array_equal(quantile.histogram_edges(), JQ.histogram_edges())
    np.testing.assert_array_equal(quantile.bucket_np(x), JQ.bucket_np(x))
    counts = np.bincount(JQ.bucket_np(x).clip(0, 15), minlength=16)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert quantile.histogram_quantile(counts, q) == JQ.histogram_quantile(counts, q)
    assert quantile.histogram_quantile(np.zeros(16), 0.5) == (-1, -1)
    # The schema and the digest helpers.
    for name in ("VERSIONS", "DIGEST_SLOTS", "WD_DETECTORS", "COUNTER_SLOTS",
                 "REGISTRY_VERSION"):
        assert getattr(schema, name) == getattr(jschema, name), name
    assert stream.WD_SLOTS == jstream.WD_SLOTS
    vecs = rng.integers(0, 50, (4, schema.DIGEST_WIDTH)).astype(np.int32)
    dicts = [stream.decode_digest(v) for v in vecs]
    assert dicts == [jstream.decode_digest(v) for v in vecs]
    assert stream.fold_digests(dicts) == jstream.fold_digests(dicts)
    assert stream.fold_digests(dicts + [stream.pad_digest()]) == \
        jstream.fold_digests(dicts + [jstream.pad_digest()])
    for fn, arg, match in ((stream.decode_digest, np.zeros(14), "digest shape"),
                           (stream.fold_digests, [], "at least one"),
                           (schema.require_registry_version, 2, "registry version"),
                           (schema.require_ledger_version, 2, "ledger_version"),
                           (schema.require_serve_version, 2, "serve_version")):
        with pytest.raises(ValueError, match=match):
            fn(arg)
    # Each package reads the other's stream file; a foreign version and a
    # meta-less file are refused; a truncated last line is tolerated.
    rows = port_ser["rec"].rows
    jpath = str(tmp_path / "jax.ndjson")
    with open(jpath, "w") as f:
        jrec = jstream.TimelineRecorder(p=jp, total_instances=FLEET_B, out=f)
        for r in rows:
            jrec.record([r[name] for name, _ in jschema.DIGEST_SLOTS], steps=r["steps"])
    back = stream.load_ndjson(jpath)[1]
    assert [digest_slots(r) for r in back] == [digest_slots(r) for r in rows]
    assert [r["halt_frac"] for r in back] == [r["halt_frac"] for r in rows]
    assert jstream.load_ndjson(port_ser["path"]) == stream.load_ndjson(port_ser["path"])
    with open(jpath, "a") as f:
        f.write('{"kind": "row", "trunc')
    assert len(stream.load_ndjson(jpath)[1]) == len(rows)
    bad, raw = tmp_path / "bad.ndjson", tmp_path / "raw.ndjson"
    bad.write_text(json.dumps({"kind": "meta", "registry_version": 999}) + "\n")
    raw.write_text(json.dumps({"kind": "row", "halted": 1}) + "\n")
    with pytest.raises(ValueError, match="registry version"):
        stream.load_ndjson(str(bad))
    with pytest.raises(ValueError, match="meta line"):
        stream.load_ndjson(str(raw))
    # The run report: saved by the port, read by both packages.
    rep = report.run_report(p, port_ser["st"], stream=port_ser["rec"])
    assert rep["digest"] == stream.decode_digest(
        stream.compute_digest(p, port_ser["st"]).numpy())
    assert rep["metrics"] == report.merged_metrics(p, port_ser["st"])
    assert rep["stream"]["chunks"] == len(port_ser["rec"].rows)
    one = report.run_report(p, port_ser["st"], instance=SILENT_I)
    assert one["flight"] == report.decode_flight(p, port_ser["st"], SILENT_I)
    assert one["summary"]["n_events"] == int(port_ser["st"].n_events[SILENT_I])
    path = str(tmp_path / "report.json")
    report.save_report(path, rep)
    assert report.load_report(path) == jreport.load_report(path) == json.loads(json.dumps(rep))
    fl = report.fleet_flight(p, port_ser["st"])
    assert [r for r in fl if r["instance"] == 1] == [
        dict(r, instance=1) for r in report.decode_flight(p, port_ser["st"], 1)]


def test_checkpoints_cross_load_and_resume(port_ser, tmp_path):
    """JAX's checkpoints of instance 0's initial state, unbatched and as a
    batch of one (what ``init_batch`` of that seed gives), load into the
    port as a batch of one; one chunk on, the port saves, loads and resumes
    to the fleet run's instance 0 in every leaf.  The port's checkpoint of
    that state loads into JAX's checkpoint.load."""
    p, jp = port_ser["p"], P_WD_SER
    # One jitted call (op by op, init_state is ~50 small XLA compiles).
    jst = jax.tree_util.tree_map(
        np.asarray, jax.jit(JS.init_state, static_argnums=0)(jp, int(SEEDS[0])))
    like = jax.tree_util.tree_map(lambda x: x[None], jst)   # init_batch of one seed
    want = leaves(like)
    for i, state in enumerate((jst, like)):   # unbatched and batched checkpoints
        path = str(tmp_path / f"jax{i}.npz")
        jckpt.save(path, state)
        st = ckpt.load(path, p, device="cpu")
        assert_leaves_equal(convert.to_reference(st), want)
    mid = S.run_to_completion(p, st, chunk=FLEET_CHUNK, max_chunks=1)
    path = str(tmp_path / "port.npz")
    ckpt.save(path, mid)
    resumed = S.run_to_completion(p, ckpt.load(path, p, device="cpu"), chunk=FLEET_CHUNK)
    assert_leaves_equal(convert.to_reference(resumed),
                        convert.to_reference(S.select_instances(port_ser["st"], [0])))
    # Loading under other plane settings restarts the planes empty.
    off = ckpt.load(path, ser_params(telemetry=False, watchdog=False), device="cpu")
    assert off.metrics.shape == (1, 0) and off.wd.shape == (1, 0)
    assert torch.equal(off.n_events, mid.n_events)
    ckpt.save(path, st)
    assert_leaves_equal(leaves(jckpt.load(path, jp, like=like)), want)


def test_lane_checkpoint_resume(tmp_path):
    p = lane_params(max_clock=60)
    seeds = SEEDS[:2]
    whole = P.run_to_completion(p, P.init_batch(p, seeds, device="cpu"))
    mid = P.run_to_completion(p, P.init_batch(p, seeds, device="cpu"), max_chunks=2)
    path = str(tmp_path / "lane.npz")
    ckpt.save(path, mid)
    back = ckpt.load(path, p, device="cpu")
    assert isinstance(back, P.PSimState)
    resumed = convert.to_reference(P.run_to_completion(p, back))
    assert_leaves_equal(resumed, convert.to_reference(whole))
    assert int(resumed["n_events"].min()) > int(mid.n_events.max()) > 0


@pytest.mark.parametrize("engine", ["serial", "lane"])
def test_planes_off_are_inert(engine, port_ser, port_lane):
    run = port_ser if engine == "serial" else port_lane
    eng = S if engine == "serial" else P
    p_off = (ser_params if engine == "serial" else lane_params)(
        telemetry=False, watchdog=False)
    off = convert.to_reference(eng.run_to_completion(p_off, port_fleet(p_off, eng)))
    on = convert.to_reference(run["st"])
    assert_leaves_equal(off, on, skip=PLANES)
    for k in PLANES:
        assert off[k].shape[1] == 0 and on[k].shape[1] > 0, k


def test_sweep_rows_carry_telemetry_and_stream(tmp_path, monkeypatch):
    """``run_all`` with --telemetry --watchdog --stream-out, over tiny
    stand-ins for the BASELINE configs: a serial fleet and a lane fleet."""
    from librabft_simulator_tpu_torch.analysis import sweeps

    base = dict(FLEET_WD_SER_KW, telemetry=False, watchdog=False, max_clock=15)
    configs = {
        "ser": (SimParams(**base), 2, 0),
        "lane": (SimParams(**{**base, "n_nodes": 4, "delay_kind": "uniform"}), 2, "parallel"),
    }
    monkeypatch.setattr(sweeps, "baseline_configs", lambda scale: configs)
    out = sweeps.run_all(1.0, telemetry=True, watchdog=True,
                         stream_out=str(tmp_path / "s.ndjson"), device="cpu")
    for name in ("ser", "lane"):
        row = out[name]
        meta, rows = stream.load_ndjson(str(tmp_path / f"s.{name}.ndjson"))
        assert meta["config"] == name and meta["watchdog"] is True
        assert rows == row["stream"]["timeline_tail"][-len(rows):]
        assert row["stream"]["final"]["halted"] == 2
        assert row["stream"]["final"]["events"] == row["telemetry"]["fr_count"] > 0
    assert out["lane"]["telemetry"]["windows"] > 0
    assert sorted(f.name for f in tmp_path.iterdir()) == ["s.lane.ndjson", "s.ser.ndjson"]
