"""Wide committees on the port, against the referees on the CPU.

(a) the serial engine at n=16 against the C++ engine (``native.run``;
    ctypes and g++, no JAX executable): two instances at the CLI's
    ``queue_cap = max(32, 16n)``, the horizon cut to where every node of
    both has committed;
(b) ``slow``: the serial engine at n=64 against the C++ engine, which
    reaches the ``votes_hi`` word and ``authors_known`` at n >= 32, and
    forged QCs from authors 41 and 62 (leaders of early rounds) against the
    oracle (the C++ engine has no forge payload), which reach the forged
    QC's author bits above 31;
(c) ``slow``: the lane engine at n=16 (config #5's shape: 2-chain, uniform,
    8 lanes, drain 4) against the JAX lane engine, leaf for leaf;
(d) ``slow``: the telemetry and watchdog planes against JAX, leaf for leaf,
    at the fleets and executables that tests/test_stream.py's ``ser_wd_run``
    (serial, through the digest stream, whose per-chunk digests must match
    too) and ``lane_wd_run`` (lanes) build.

The ``slow`` cases build JAX executables the tier-1 suite does not, or run
for minutes on the CPU; run them with ``-m slow``.
"""

import jax
import numpy as np
import pytest

from fleet_shapes import FLEET_B, FLEET_CHUNK, FLEET_WD_LANE_KW, FLEET_WD_SER_KW
from librabft_simulator_tpu import native
from librabft_simulator_tpu.core.types import SimParams as JParams
from librabft_simulator_tpu.oracle.sim import OracleSim
from librabft_simulator_tpu.sim import parallel_sim as JP
from librabft_simulator_tpu.sim import simulator as JS
from librabft_simulator_tpu.sim.simulator import dedupe_buffers
from librabft_simulator_tpu.telemetry import stream as jstream
from tests.port_support import import_torch, port_byz_fleet, release_jax_memory
from tests.test_stream import (DOCTOR_I, P_WD_LANE, P_WD_SER, SEEDS, SILENT_I,
                               byz_fleet_state, silent_nodes)


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, convert, SimParams, S, P, stream
    torch = import_torch()
    from librabft_simulator_tpu_torch import convert
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S
    from librabft_simulator_tpu_torch.telemetry import stream


def wide_kw(n, max_clock):
    return dict(n_nodes=n, queue_cap=max(32, 16 * n), max_clock=max_clock)


def run_serial(kw, seeds, **masks):
    p = SimParams(**kw)
    st = S.init_batch(p, seeds, device="cpu", **masks)
    return convert.to_reference(S.run_to_completion(p, st, chunk=32))


def chain(ref, b, a):
    cc = int(ref["ctx.commit_count"][b, a])
    h = ref["ctx.log_depth"].shape[-1]
    return [(int(ref["ctx.log_depth"][b, a, i % h]), int(ref["ctx.log_tag"][b, a, i % h]))
            for i in range(max(cc - h, 0), cc)]


def assert_against_native(ref, b, res, n):
    for name in ("n_events", "clock", "stamp_ctr", "n_msgs_sent", "n_msgs_dropped",
                 "n_queue_full"):
        assert int(ref[name][b]) == getattr(res, name), name
    for a in range(n):
        assert chain(ref, b, a) == res.committed_chain(a), f"node {a}"
        assert int(ref["ctx.commit_count"][b, a]) == res.commit_count(a), a
        assert int(ref["store.hcr"][b, a]) == res.hcr(a), a
        assert int(ref["store.hqc_round"][b, a]) == res.hqc_round(a), a
        assert int(ref["store.current_round"][b, a]) == res.current_round(a), a
        assert int(ref["ctx.sync_jumps"][b, a]) == res.sync_jumps(a), a


def test_serial_n16_against_native():
    # Two seeds whose every node commits by max_clock 100 (lognormal delays,
    # the CLI's default), picked for the fewest events to get there.
    kw, seeds = wide_kw(16, 100), [32, 18]
    ref = run_serial(kw, seeds)
    for b, seed in enumerate(seeds):
        assert_against_native(ref, b, native.run(JParams(**kw), seed), 16)
    assert int(ref["ctx.commit_count"].min()) >= 1
    assert int(ref["n_queue_full"].min()) > 0


@pytest.mark.slow
def test_serial_n64_against_native_and_forged_qc_against_oracle():
    kw, seeds = wide_kw(64, 100), [0, 5]
    ref = run_serial(kw, seeds)
    for b, seed in enumerate(seeds):
        assert_against_native(ref, b, native.run(JParams(**kw), seed), 64)
    assert int(ref["ctx.commit_count"].min()) >= 1
    # Forged QCs from authors 62 and 41, the leaders of rounds 1 and 4: their
    # author bits live in the high vote word.
    forge = np.zeros(64, bool)
    forge[[41, 62]] = True
    ref = run_serial(kw, [0], byz_forge_qc=forge[None])
    orc = OracleSim(JParams(**kw), 0, byz_forge_qc=forge.tolist()).run()
    for name in ("n_events", "clock", "stamp_ctr", "n_msgs_sent", "n_msgs_dropped",
                 "n_queue_full"):
        assert int(ref[name][0]) == getattr(orc, name), name
    for a in range(64):
        assert chain(ref, 0, a) == orc.committed_chain(a), f"node {a}"
        assert int(ref["store.hcr"][0, a]) == orc.stores[a].hcr
        assert int(ref["store.current_round"][0, a]) == orc.stores[a].current_round
        assert int(ref["ctx.sync_jumps"][0, a]) == orc.ctxs[a].sync_jumps


def jax_lane_leaves(p, st, chunk):
    """The JAX lane engine's final leaves, in a released heap."""
    release_jax_memory()
    st = dedupe_buffers(st)
    run = JP.make_run_fn(p, chunk)
    for _ in range(200):
        st = run(st)
        if bool(np.all(np.asarray(st.halted))):
            break
    out = {jax.tree_util.keystr(k).lstrip("."): np.asarray(v)
           for k, v in jax.tree_util.tree_leaves_with_path(st)}
    del st, run
    release_jax_memory()
    return out


def assert_leaves_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.slow
def test_lane_n16_against_jax():
    kw = dict(n_nodes=16, delay_kind="uniform", commit_chain=2, inbox_cap=256,
              active_lanes=8, drain_k=4, max_clock=120)
    seeds = np.arange(2, dtype=np.uint32)
    want = jax_lane_leaves(JParams(**kw), JP.init_batch(JParams(**kw), seeds), 64)
    p = SimParams(**kw)
    got = convert.to_reference(P.run_to_completion(p, P.init_batch(p, seeds, device="cpu")))
    assert_leaves_equal(got, want)
    assert int(got["ctx.commit_count"].min()) >= 1


@pytest.mark.slow
def test_lane_planes_against_jax():
    """tests/test_stream.py's lane_wd_run fleet (silent and doctored
    instances), both planes on, every leaf."""
    want = jax_lane_leaves(P_WD_LANE, byz_fleet_state(P_WD_LANE, JP), FLEET_CHUNK)
    p = SimParams(**{**FLEET_WD_LANE_KW, "max_clock": P_WD_LANE.max_clock})
    fleet = port_byz_fleet(P, p, SEEDS, SILENT_I, silent_nodes(p), DOCTOR_I)
    got = convert.to_reference(P.run_to_completion(p, fleet))
    assert_leaves_equal(got, want)
    assert got["metrics"].shape[1] > 0 and got["wd"].shape[1] == 6
    assert FLEET_WD_LANE_KW["telemetry"] and FLEET_WD_LANE_KW["watchdog"]


@pytest.mark.slow
def test_serial_planes_and_digests_against_jax():
    """tests/test_stream.py's ser_wd_run: the same params, fleet, chunk and
    executable, through the digest stream on both sides."""
    release_jax_memory()
    rec = jstream.TimelineRecorder(p=P_WD_SER, total_instances=FLEET_B)
    st = JS.run_to_completion(P_WD_SER, byz_fleet_state(P_WD_SER, JS), chunk=FLEET_CHUNK,
                              batched=True, stream=rec)
    want = {jax.tree_util.keystr(k).lstrip("."): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(st)}
    del st
    release_jax_memory()
    p = SimParams(**{**FLEET_WD_SER_KW, "max_clock": P_WD_SER.max_clock})
    fleet = port_byz_fleet(S, p, SEEDS, SILENT_I, silent_nodes(p), DOCTOR_I)
    port_rec = stream.TimelineRecorder(p, total_instances=FLEET_B)
    got = convert.to_reference(S.run_to_completion(p, fleet, chunk=FLEET_CHUNK, stream=port_rec))
    assert_leaves_equal(got, want)
    assert got["metrics"].shape[1] > 0 and got["wd"].shape[1] == 6

    def digests(rows):
        return [({name: r[name] for name, _ in jstream.DIGEST_SLOTS}, r["steps"]) for r in rows]

    assert digests(port_rec.rows) == digests(rec.rows)
