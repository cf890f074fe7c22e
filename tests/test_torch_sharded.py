"""The port's sharded fleet runtime (librabft_simulator_tpu_torch/parallel/,
the macro-steps and chunk runner of sim/simulator.py, sim/checkpoint.py's
load_sharded, the sweeps' --dp) against the references on the CPU.

The micro fleets of tests/test_multichip.py (``FLEET_SER_KW`` and
``FLEET_LANE_KW``, ``FLEET_B`` = 5 instances seeded by ``fleet_seeds(0,
5)``; horizons 90 and 70, where both fleets commit, so that the file stays
inside its tier-1 time) on a 2-shard mesh whose two cells are the CPU, so
B=5 pads to 6:

(a) ``run_sharded`` in every loop and wrap (pipelined, non-pipelined,
    ``wrap="jit"``, the device ring) equals the port's
    ``run_to_completion`` in every leaf, on both engines (the port's
    ``run_to_completion`` is held to JAX's elsewhere in tier-1);
(b) ``macro_k=4`` equals ``macro_k=1``, and the stream's steps are event
    steps, on the plain loop and the ring;
(c) the padding adds nothing: the padded fleet's merged metrics and flight
    rows against the pure-Python oracle's tallies, as
    tests/test_multichip.py pins JAX's;
(d) the host wrap fetches one [13] digest per dispatched chunk, the ring
    fewer times than it retires chunks;
(e) fleet_seeds, the padding seeds and unpad against JAX's;
(f) mp_authors: at n_mp = 1 the armed quorum sites equal the plain ones,
    outside a mesh they raise as JAX's unbound axis does, the standalone
    author-sharded sums give JAX's values, and JAX's refusals hold;
(g) load_sharded of a JAX-saved and a port-saved checkpoint resumes to the
    uninterrupted run; (h) run_config(dp=2) on the CPU.

No JAX executable is built: JAX is used through its jax-free oracle, its
eager ``init_state``, ``fleet_seeds`` and ``count_votes`` and its
checkpoint writer.  The JAX runtime on its virtual 8-device mesh is the
``slow`` referee at the end of this file.
"""

import dataclasses

import jax
import numpy as np
import pytest

from fleet_shapes import (FLEET_B, FLEET_CHUNK, FLEET_LANE_KW, FLEET_MACRO_K,
                          FLEET_RING_K, FLEET_SER_KW)
from librabft_simulator_tpu.core import config as jconfig
from librabft_simulator_tpu.core.types import SimParams as JParams
from librabft_simulator_tpu.parallel import sharded as jsharded
from librabft_simulator_tpu.sim import checkpoint as jckpt
from librabft_simulator_tpu.sim import simulator as JS
from tests.port_support import import_torch

SER_CLOCK, LANE_CLOCK = 90, 70
SER_CHUNK, LANE_CHUNK = FLEET_CHUNK // 2, 8
SEEDS = np.asarray(jsharded.fleet_seeds(0, FLEET_B))
LOOPS = {"pipelined": {}, "non-pipelined": {"pipeline": False}, "jit": {"wrap": "jit"},
         "ring": {"ring": True}}


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, convert, SimParams, S, P, M, SH, ckpt, config, ledger, report, stream
    global sweeps
    torch = import_torch()
    from librabft_simulator_tpu_torch import convert
    from librabft_simulator_tpu_torch.analysis import sweeps
    from librabft_simulator_tpu_torch.core import config
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.parallel import mesh as M
    from librabft_simulator_tpu_torch.parallel import sharded as SH
    from librabft_simulator_tpu_torch.sim import checkpoint as ckpt
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S
    from librabft_simulator_tpu_torch.telemetry import ledger, report, stream


def engine_of(name):
    return (S, SimParams(max_clock=SER_CLOCK, **FLEET_SER_KW), SER_CHUNK) if name == "serial" \
        else (P, SimParams(max_clock=LANE_CLOCK, **FLEET_LANE_KW), LANE_CHUNK)


def mesh2():
    return M.make_mesh(2, 1, devices=["cpu"] * 2)


def assert_leaves_equal(got, want):
    got, want = convert.to_reference(got), convert.to_reference(want)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def refs():
    """The port's run_to_completion of both micro fleets."""
    out = {}
    for name in ("serial", "lanes"):
        eng, p, chunk = engine_of(name)
        out[name] = eng.run_to_completion(p, eng.init_batch(p, SEEDS, device="cpu"), chunk=chunk)
    assert int(out["serial"].ctx.commit_count.sum()) > 0
    assert int(out["lanes"].ctx.commit_count.sum()) > 0
    return out


@pytest.fixture(scope="module")
def runs():
    """run_sharded of both fleets in every loop, with the polls counted."""
    return {}


def loop_config(name, loop):
    """(engine, SimParams fields, chunk, run_sharded keywords) of one loop."""
    eng, p, chunk = engine_of(name)
    fields = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    kw = dict(LOOPS[loop])
    if kw.pop("mp", False) and eng is S:
        fields["mp_authors"] = True
    if kw.pop("ring", False):
        # The serial ring runs K-event macro-steps, as the card's phase does.
        fields.update(wrap="device", ring_k=FLEET_RING_K)
        if eng is S:
            fields["macro_k"] = FLEET_MACRO_K
            chunk //= FLEET_MACRO_K
    return eng, fields, chunk, kw


def run_loop(runs, name, loop):
    key = (name, loop)
    if key in runs:
        return runs[key]
    eng, fields, chunk, kw = loop_config(name, loop)
    p = SimParams(**fields)
    polls = {"digest": [], "ring": 0, "halt": []}
    real_digest, real_ring, real_halt = SH._poll_digest, SH._poll_ring, SH._poll_halt

    def digest(copy):
        d = real_digest(copy)
        polls["digest"].append(d.shape)
        return d

    def ring(*a):
        polls["ring"] += 1
        return real_ring(*a)

    def halt(seen):
        got = real_halt(seen)
        polls["halt"].append(got[1:])
        return got

    SH._poll_digest, SH._poll_ring, SH._poll_halt = digest, ring, halt
    rec = stream.TimelineRecorder(p)
    try:
        st = SH.run_sharded(p, mesh2(), eng.init_batch(p, SEEDS, device="cpu"),
                            num_steps=chunk * 200, chunk=chunk, engine=eng, stream=rec, **kw)
    finally:
        SH._poll_digest, SH._poll_ring, SH._poll_halt = real_digest, real_ring, real_halt
    runs[key] = dict(st=st, polls=polls, chunks=SH.run_sharded.last_chunks,
                     ring=ledger.get().ring_stats(), pipe=ledger.get().pipeline_stats(),
                     rows=rec.rows, steps=[r["steps"] for r in rec.rows],
                     last={k: rec.rows[-1][k] for k in stream.pad_digest()})
    return runs[key]


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("name", ["serial", "lanes"])
def test_run_sharded_equals_run_to_completion(refs, runs, name, loop):
    """(a), (d): every loop and wrap on the padded 2-shard mesh equals the
    unsharded run; the host wrap polls one [13] digest per dispatched chunk.
    The ring fetches its digests fewer times than it retires chunks, and
    reads a lagged halted slot before each further chunk of an outer call:
    every host fetch goes through _poll_digest, _poll_ring or _poll_halt,
    and the ledger's ring_stats counts each of them.  On the CPU a copy has
    always landed, so each halt read reads the newest chunk without waiting
    and the ring never dispatches a chunk past the halt."""
    got = run_loop(runs, name, loop)
    st = got["st"]
    assert not isinstance(st, M.ShardedState) and st.clock.device.type == "cpu"
    assert_leaves_equal(st, refs[name])
    polls = got["polls"]
    if loop == "ring":
        ring = got["ring"]
        assert polls["digest"] == [] and polls["ring"] == ring["dispatches"]
        assert ring["retired_chunks"] > ring["dispatches"]
        assert ring["polls_per_retired_chunk"] < 1
        # One halt read before each chunk after an outer call's first, and
        # one more in the call that saw the halt before its budget ran out.
        assert polls["halt"] == [(1, False)] * ring["halt_polls"]
        assert ring["halt_polls"] == got["chunks"] - ring["dispatches"] + ring["early_exit"]
        assert got["chunks"] == ring["retired_chunks"] and ring["halt_waits"] == 0
        assert ring["fetches_per_retired_chunk"] == round(
            (ring["dispatches"] + ring["halt_polls"]) / ring["retired_chunks"], 4)
        assert ring["waits_per_retired_chunk"] == ring["polls_per_retired_chunk"]
    else:
        assert polls["ring"] == 0 and polls["halt"] == []
        assert polls["digest"] == [(13,)] * got["chunks"]
        assert [r["chunk"] for r in got["pipe"]["rows"]] == list(range(got["chunks"]))


def test_macro_steps_equal_single_steps(refs, runs):
    """(b): macro_k=4 chunks equal macro_k=1 on run_to_completion (and on
    the serial ring, above), and the streams' steps count event steps."""
    _, p, chunk1 = engine_of("serial")
    pm = dataclasses.replace(p, macro_k=FLEET_MACRO_K)
    chunk = chunk1 // FLEET_MACRO_K
    with stream.TimelineRecorder(pm) as rec:
        st = S.run_to_completion(pm, S.init_batch(pm, SEEDS, device="cpu"), chunk=chunk,
                                 stream=rec)
    assert_leaves_equal(st, refs["serial"])
    assert [r["steps"] for r in rec.rows] == [(i + 1) * chunk1 for i in range(len(rec.rows))]
    assert S.run_to_completion.last_steps == len(rec.rows) * chunk1
    ring = run_loop(runs, "serial", "ring")
    assert ring["steps"] == [(i + 1) * chunk1 for i in range(len(ring["steps"]))]
    assert [r["ring_i"] for r in ring["rows"]] == list(range(len(ring["rows"])))


def test_padding_contributes_zero_oracle_pinned(runs):
    """(c): the padded 2-shard fleet's merged counters equal the sums of the
    oracle's per-instance tallies, and its flight rows are the oracle's
    event-log tails, instance-major, with no padding row."""
    from librabft_simulator_tpu.oracle.sim import OracleSim

    _, p, _ = engine_of("serial")
    jp = JParams(max_clock=SER_CLOCK, **FLEET_SER_KW)
    orcs = [OracleSim(jp, int(s)).run() for s in SEEDS]
    st = run_loop(runs, "serial", "pipelined")["st"]
    md = report.merged_metrics(p, st)
    ev = [md["ev_notify"], md["ev_request"], md["ev_response"], md["ev_timer"]]
    assert ev == [sum(o.tel["ev_kind"][k] for o in orcs) for k in range(4)]
    assert md["fr_count"] == sum(o.n_events for o in orcs)
    assert md["drops"] == sum(o.n_msgs_dropped for o in orcs)
    assert md["overflow"] == sum(o.n_queue_full for o in orcs)
    assert md["sync_jumps"] == sum(sum(c.sync_jumps for c in o.ctxs) for o in orcs)
    assert md["queue_hwm"] == max(o.tel["queue_hwm"] for o in orcs) > 0
    assert md["node_depth_hwm"] == [max(o.tel["node_depth_hwm"][a] for o in orcs)
                                    for a in range(p.n_nodes)]
    assert md["commit_lat_miss"] == sum(o.tel["commit_lat_miss"] for o in orcs)
    expected = []
    for i, orc in enumerate(orcs):
        tail = orc.tel["flight"][-min(p.flight_cap, orc.n_events):]
        expected += [dict(r, instance=i) for r in tail]
    assert report.fleet_flight(p, st) == expected


def test_sharded_state_reports_and_digest(refs, runs):
    """The report functions and the digest take a ShardedState: rows in
    instance order, a limit cutting mid-shard, the digest folded across
    shards as the padded fleet's ring folds the padding."""
    _, p, _ = engine_of("serial")
    flat = S.select_instances(refs["serial"], [0, 1, 2, 3])
    st = M.shard_batch(mesh2(), flat)
    assert [s.clock.shape[0] for s in st.shards] == [2, 2]
    assert report.merged_metrics(p, st) == report.merged_metrics(p, flat)
    full = report.fleet_flight(p, flat)
    assert report.fleet_flight(p, st) == full
    for k in (2, 3):
        assert report.fleet_flight(p, st, max_instances=k) == [
            r for r in full if r["instance"] < k]
    assert torch.equal(stream.compute_digest(p, st), stream.compute_digest(p, flat))
    assert_leaves_equal(SH.unpad(st, 3), S.select_instances(flat, [0, 1, 2]))
    final = stream.decode_digest(stream.compute_digest(p, refs["serial"]).numpy())
    want = stream.fold_digests([final, stream.pad_digest()])
    assert run_loop(runs, "serial", "ring")["last"] == {k: want[k] for k in stream.pad_digest()}


def test_seeds_pad_and_unpad_against_jax():
    """(e): fleet_seeds is JAX's for every start; the padding instances are
    init_batch rows of JAX's salted seeds, pre-halted; unpad gives the
    state back, a lane state with its routing buffers."""
    np.testing.assert_array_equal(SH.fleet_seeds(0, FLEET_B), SEEDS)
    salted = np.asarray(jsharded.fleet_seeds(jsharded._PAD_SALT, FLEET_B, FLEET_B))
    np.testing.assert_array_equal(SH.fleet_seeds(SH._PAD_SALT, FLEET_B, FLEET_B), salted)
    np.testing.assert_array_equal(SH.fleet_seeds(7, 16)[4:9], SH.fleet_seeds(7, 5, 4))
    for eng, kw in ((S, FLEET_SER_KW), (P, FLEET_LANE_KW)):
        p = SimParams(max_clock=60, **kw)
        st = eng.init_batch(p, SEEDS, device="cpu")
        padded, n_valid = SH.pad_to_multiple(p, st, 10)
        assert n_valid == FLEET_B and SH.batch_size(padded) == 10
        assert padded.halted.tolist() == [False] * FLEET_B + [True] * FLEET_B
        filler = eng.init_batch(p, salted, device="cpu")
        filler = filler.replace(halted=torch.ones(FLEET_B, dtype=torch.bool))
        assert_leaves_equal(S.select_instances(padded, range(FLEET_B, 10)), filler)
        back = SH.unpad(padded, n_valid)
        assert_leaves_equal(back, st)
        dt, du = S.tables(p, "cpu")
        if eng is P:   # its own inbox buffers: a window routes in place
            P.step(p, dt, du, P.d_min_of(p), back)
        assert SH.pad_to_multiple(p, back, 5)[0] is back


def test_mp_authors_quorum_wiring(refs, runs):
    """(f): mp_authors at n_mp = 1 equals the plain run (the serial
    non-pipelined loop above runs it: each shard's chunk binds the sums);
    outside a mesh the armed sites raise as JAX's unbound axis does; the
    author-sharded sums give JAX's values; JAX's refusals hold."""
    _, p, chunk = engine_of("serial")
    pm = dataclasses.replace(p, mp_authors=True)
    mesh_1x1 = M.make_mesh(1, 1, devices=["cpu"])
    st = run_loop(runs, "serial", "non-pipelined")["st"]
    assert_leaves_equal(st, refs["serial"])
    assert int(st.ctx.commit_count.sum()) > 0   # the quorum sites ran
    with pytest.raises(NameError):
        config.count_votes(torch.ones(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
                           axis_name=config.MP_AXIS)
    with pytest.raises(NameError):
        S.run_to_completion(pm, S.init_batch(pm, SEEDS, device="cpu"), chunk=chunk)
    mesh_1x4 = M.make_mesh(1, 4, devices=["cpu"] * 4)
    w = np.asarray([1, 2, 1, 3, 1, 1, 2, 1, 1, 1, 4, 1, 1, 2, 1, 1], np.int32)
    for cut in (9, 10, 11, 13):
        mask = np.arange(16) < cut
        got = SH.sharded_count_votes(mesh_1x4, torch.as_tensor(w), torch.as_tensor(mask))
        assert int(got) == int(jconfig.count_votes(w, mask))
        reached = SH.sharded_quorum_reached(mesh_1x4, torch.as_tensor(w), torch.as_tensor(mask))
        assert bool(reached) == bool(jconfig.count_votes(w, mask)
                                     >= jconfig.quorum_threshold(w))
    mesh_1x2 = M.make_mesh(1, 2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="mp_authors"):
        SH.make_sharded_run_fn(pm, mesh_1x2, 4)
    with pytest.raises(ValueError, match="shard_map"):
        SH.make_sharded_run_fn(pm, mesh_1x1, 4, wrap="jit")
    pr = dataclasses.replace(p, wrap="device", ring_k=FLEET_RING_K)
    with pytest.raises(ValueError, match="shard_map"):
        SH.run_sharded(pr, mesh2(), S.init_batch(pr, SEEDS, device="cpu"),
                       num_steps=chunk * 4, chunk=chunk, wrap="jit")
    with pytest.raises(ValueError, match="unknown wrap"):
        SH.make_sharded_run_fn(p, mesh2(), 4, wrap="gspmd")
    with pytest.raises(ValueError, match="devices"):
        M.make_mesh(n_dp=3, n_mp=1, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="n_mp"):
        M.make_mesh(n_dp=1, n_mp=0, devices=["cpu"])
    with pytest.raises(ValueError, match="serial-engine knob"):
        SH.run_sharded(dataclasses.replace(p, macro_k=4), mesh2(),
                       P.init_batch(SimParams(**FLEET_LANE_KW), SEEDS, device="cpu"),
                       num_steps=8, chunk=8, engine=P)


def test_load_sharded_resumes(refs, tmp_path):
    """(g): the fleet after one chunk, saved by JAX's checkpoint writer and
    by the port's, restores onto the 2-shard mesh padded to 6 (each shard
    its own rows, the filler pre-halted), the same from both files, and
    resumes to the uninterrupted run."""
    _, p, chunk = engine_of("serial")
    jp = JParams(max_clock=SER_CLOCK, **FLEET_SER_KW)
    mid = S.run_to_completion(p, S.init_batch(p, SEEDS, device="cpu"), chunk=chunk,
                              max_chunks=1)
    # JAX's SimState structure (traced, not run) around the port's leaves.
    shape = jax.eval_shape(lambda: JS.init_batch(jp, np.zeros(FLEET_B, np.uint32)))
    jst = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shape),
                                       list(convert.to_reference(mid).values()))
    paths = [str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")]
    jckpt.save(paths[0], jst)
    ckpt.save(paths[1], mid)
    (st, n_valid), (st2, n2) = [ckpt.load_sharded(path, p, mesh2()) for path in paths]
    assert n_valid == n2 == FLEET_B and isinstance(st, M.ShardedState)
    assert [s.clock.shape[0] for s in st.shards] == [3, 3]
    assert st.shards[1].halted.tolist()[-1] and not mid.halted.any()
    for a, b in zip(st.shards, st2.shards):
        assert_leaves_equal(a, b)
    st = SH.run_sharded(p, mesh2(), st, num_steps=chunk * 200, chunk=chunk)
    assert isinstance(st, M.ShardedState)     # the padded batch, on the mesh
    assert_leaves_equal(SH.unpad(st, n_valid), refs["serial"])


def test_run_config_dp_on_the_cpu():
    """(h): the sweeps' dp path runs a lane config on a 2-shard CPU mesh
    (B=3 pads to 4) and gives the one-device row's stats, inside a RUN
    span."""
    p = SimParams(n_nodes=4, delay_kind="uniform", max_clock=40)
    one = sweeps.run_config(p, 3, engine=P, device="cpu")
    dp = sweeps.run_config(p, 3, engine=P, dp=2, device="cpu")
    assert dp.pop("dp") == 2
    for row in (one, dp):
        row.pop("elapsed_s"), row.pop("rounds_per_sec")
    assert dp == one and one["total_rounds"] > 0
    runs = [sp.to_json() for sp in ledger.get().spans if sp.kind == "run"]
    assert runs[-1]["what"] == "sweep_config" and runs[-1]["dp"] == 2


@pytest.mark.slow
@pytest.mark.parametrize("loop", ["pipelined", "ring"])
@pytest.mark.parametrize("name", ["serial", "lanes"])
def test_run_sharded_against_jax(runs, name, loop):
    """JAX's run_sharded on its virtual CPU mesh (two devices, the
    tests/test_multichip.py mesh2 form) and the port's on two CPU shards:
    every leaf equal, and the same digest rows at the same steps (the ring's
    rows with the same ring positions)."""
    from librabft_simulator_tpu.parallel import mesh as jmesh
    from librabft_simulator_tpu.sim import parallel_sim as JPE
    from librabft_simulator_tpu.telemetry import stream as jstream

    assert len(jax.devices()) >= 2, "conftest must force 8 CPU devices"
    eng, fields, chunk, kw = loop_config(name, loop)
    jeng = JS if eng is S else JPE
    jp = JParams(**fields)
    rec = jstream.TimelineRecorder(jp)
    jst = jsharded.run_sharded(jp, jmesh.make_mesh(n_dp=2, n_mp=1, devices=jax.devices()[:2]),
                               jeng.init_batch(jp, SEEDS), num_steps=chunk * 200, chunk=chunk,
                               engine=jeng, stream=rec, **kw)
    want = {jax.tree_util.keystr(k).lstrip("."): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(jst)}
    port = run_loop(runs, name, loop)
    got = convert.to_reference(port["st"])
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    keys = [n for n, _ in jstream.DIGEST_SLOTS] + ["steps", "ring_i", "ring_n"]
    assert [{k: r.get(k) for k in keys} for r in port["rows"]] == \
        [{k: r.get(k) for k in keys} for r in rec.rows]
