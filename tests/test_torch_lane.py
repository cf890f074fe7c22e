"""The port's lane engine (librabft_simulator_tpu_torch/sim/parallel_sim.py)
and sweeps (analysis/sweeps.py) against the JAX package on the CPU:

(a) leaf for leaf against the JAX lane engine, through the one executable
    tests/test_parallel_sim.py::test_window_composition_invariance builds
    (``_small_kw()`` params, 4 seeds, 256-window chunks, batched; the delay
    table, drop rate, horizon and fault masks are runtime data): uniform
    delays with per-instance honest / equivocate / silent / forge-QC masks,
    Pareto delays with 5% drop, and slow uniform delays that overflow the
    16-slot inboxes;
(b) window composition: A=1/K=1, A=2/K=3 and d_min=1 give the auto shape's
    state (all but the inbox layout) at commit_chain 3 and 2, port only;
(c) ``_earliest`` and its kernel route ``earliest`` against JAX ``_earliest``
    eagerly on random rows (ties, all-invalid rows, NEVER timers);
(d) skipping masked work on the CPU is exact; ``convert`` carries a lane
    state across; the later slices raise;
(e) the sweeps: ``baseline_configs`` and the parser match JAX's, and
    ``run_config`` runs a tiny fleet on each engine.

``max_clock`` is cut for speed (it is runtime data), not below what the
assertions on commits and inbox overflow need."""

import argparse
import dataclasses

import jax
import numpy as np
import pytest

from librabft_simulator_tpu.analysis import sweeps as jax_sweeps
from librabft_simulator_tpu.core.types import SimParams as JParams
from librabft_simulator_tpu.sim import parallel_sim as JP
from librabft_simulator_tpu.sim.simulator import dedupe_buffers
from tests.port_support import import_torch, release_jax_memory
from tests.test_parallel_sim import _small_kw

SEEDS = np.arange(4, dtype=np.uint32)
NONE = [0, 0, 0, 0]
#: Per instance (seed = row): honest, equivocate, silent, forge-QC.
MASKS = {
    "byz_equivocate": np.asarray([NONE, [0, 0, 0, 1], NONE, NONE], bool),
    "byz_silent": np.asarray([NONE, NONE, [0, 0, 0, 1], NONE], bool),
    "byz_forge_qc": np.asarray([NONE, NONE, NONE, [1, 0, 0, 0]], bool),
}
CASES = {
    "uniform_byzantine": (dict(max_clock=150), MASKS),
    "pareto_drop": (dict(max_clock=200, delay_kind="pareto", drop_prob=0.05), {}),
    "slow_overflow": (dict(max_clock=400, delay_mean=100, delay_variance=900), {}),
}


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, convert, SimParams, P, S, sweeps
    torch = import_torch()
    from librabft_simulator_tpu_torch import convert
    from librabft_simulator_tpu_torch.analysis import sweeps
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S


@pytest.fixture(scope="module")
def jax_lane_runs():
    """The JAX lane engine's final leaves for every case.  Only runtime data
    differs between the cases, so they share one executable; it is built
    into a released heap and released again before the port runs.  Each
    initial state is one jitted call (op by op, ~35 small XLA compiles)."""
    release_jax_memory()
    out = {}
    for name, (kw, masks) in CASES.items():
        p = JParams(**_small_kw(**kw))
        if masks:
            st = jax.jit(jax.vmap(lambda s, eq, sil, fq: JP.init_state(
                p, s, byz_equivocate=eq, byz_silent=sil, byz_forge_qc=fq)))(
                SEEDS, masks["byz_equivocate"], masks["byz_silent"],
                masks["byz_forge_qc"])
        else:
            st = jax.jit(JP.init_batch, static_argnums=0)(p, SEEDS)
        st = dedupe_buffers(st)
        run = JP.make_run_fn(p, 256)
        for _ in range(120):
            st = run(st)
            if bool(np.all(np.asarray(st.halted))):
                break
        assert bool(np.all(np.asarray(st.halted)))
        out[name] = {jax.tree_util.keystr(path).lstrip("."): np.asarray(leaf)
                     for path, leaf in jax.tree_util.tree_leaves_with_path(st)}
        del st, run
    release_jax_memory()
    return out


def assert_leaves_equal(got, want, skip=()):
    assert list(got) == list(want)
    for k in want:
        if k in skip:
            continue
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_lane_leaf_for_leaf_against_jax(case, jax_lane_runs):
    kw, masks = CASES[case]
    p = SimParams(**_small_kw(**kw))
    got = convert.to_reference(P.run_to_completion(
        p, P.init_batch(p, SEEDS, device="cpu", **masks)))
    assert_leaves_equal(got, jax_lane_runs[case])
    if case == "slow_overflow":
        assert int(got["n_inbox_full"].sum()) > 0
    else:
        assert (got["ctx.commit_count"].max(axis=1) > 0).all()


@pytest.mark.parametrize("chain, max_clock", [(3, 100), (2, 60)])
def test_lane_composition_invariance(chain, max_clock):
    """Window shape only decides how much work lands in each window: absent
    inbox overflow every leaf equals the auto shape's, except the inbox
    layout and the clock (the start of the last window).  Config #5's
    2-chain rule runs with a 64-slot inbox so nothing overflows."""
    base = _small_kw(max_clock=max_clock, commit_chain=chain,
                     inbox_cap=64 if chain == 2 else 0)
    seeds = [0]

    def run(d_min=None, **kw):
        p = SimParams(**{**base, **kw})
        return convert.to_reference(P.run_to_completion(
            p, P.init_batch(p, seeds, device="cpu"), d_min=d_min))

    ref = run()
    assert int(ref["n_inbox_full"].sum()) == 0
    assert int(ref["ctx.commit_count"].sum()) > 0
    for kw in (dict(active_lanes=1, drain_k=1), dict(active_lanes=2, drain_k=3),
               dict(d_min=1)):
        assert_leaves_equal(run(**kw), ref, skip=P.INBOX + ("clock",))


def test_earliest_against_jax():
    rng = np.random.default_rng(11)
    rows, ic = 64, 16
    valid = rng.random((rows, ic)) < 0.6
    time = rng.integers(0, 6, (rows, ic)).astype(np.int32)
    kind = rng.integers(0, 3, (rows, ic)).astype(np.int32)
    stamp = rng.integers(0, 4, (rows, ic)).astype(np.int32)
    timer = rng.integers(0, 8, rows).astype(np.int32)
    valid[:8] = False                       # all-invalid rows ...
    timer[4:12] = 2**31 - 1                 # ... some with NEVER timers
    time[16:24], kind[16:24], timer[16:24] = 3, 2, 3   # timer/message ties
    want = [np.asarray(x) for x in JP._earliest(valid, time, kind, stamp, timer)]
    args = [torch.as_tensor(x) for x in (valid, time, kind, stamp, timer)]
    for fn in (P._earliest, P.earliest):
        got = [x.numpy() for x in fn(*args)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=fn.__name__)
    assert want[3].any() and not want[3].all()


def test_lane_skipping_masked_work_is_exact(monkeypatch):
    """On the CPU the lane engine skips work that a mask turns off for every
    lane (a drain iteration, a handler); on the card it queues all of it.
    Run the card's form on the CPU and compare leaf for leaf."""
    p = SimParams(**_small_kw(max_clock=100))
    init = dict(byz_equivocate=np.asarray([0, 0, 1, 0], bool))
    want = convert.to_reference(P.run_to_completion(
        p, P.init_batch(p, [0], device="cpu", **init)))
    from librabft_simulator_tpu_torch.core import node, store
    for mod in (P, S, node, store):
        monkeypatch.setattr(mod, "needed", lambda mask: True)
    got = convert.to_reference(P.run_to_completion(
        p, P.init_batch(p, [0], device="cpu", **init)))
    assert_leaves_equal(got, want)
    assert int(want["ctx.commit_count"].max()) > 0


def test_lane_state_round_trip():
    """convert carries a lane state across: from_reference gives inbox
    leaves with the routing pad, so the rebuilt state steps on as the
    original does."""
    p = SimParams(**_small_kw(max_clock=60))
    dt, du, dm = *S.tables(p, "cpu"), P.d_min_of(p)
    st = P.init_batch(p, [3, 4], device="cpu")
    for _ in range(6):
        st = P.step(p, dt, du, dm, st)
    ref = convert.to_reference(st)
    back = convert.from_reference(ref, device="cpu")
    assert isinstance(back, P.PSimState)
    assert_leaves_equal(convert.to_reference(back), ref)
    for _ in range(6):
        st = P.step(p, dt, du, dm, st)
        back = P.step(p, dt, du, dm, back)
    assert_leaves_equal(convert.to_reference(back), convert.to_reference(st))
    assert int(st.n_msgs_sent.sum()) > 0


def test_lane_rejects_what_it_does_not_run():
    with pytest.raises(NotImplementedError):
        P.init_batch(SimParams(shuffle_receivers=True), [0], device="cpu")
    # The device wrap and mp_authors are ported (tests/test_torch_sharded.py).
    for kw in (dict(wrap="device"), dict(mp_authors=True)):
        assert P.init_batch(SimParams(**kw), [0], device="cpu").in_valid.shape == (1, 3, 16)
    with pytest.raises(ValueError, match="serial-engine knob"):
        P.init_batch(SimParams(macro_k=4), [0], device="cpu")
    st = P.init_batch(SimParams(), [0], device="cpu")
    with pytest.raises(ValueError, match="serial-engine knob"):
        P.run_to_completion(SimParams(macro_k=4), st)
    # The telemetry and watchdog planes are ported (tests/test_torch_telemetry.py).
    st = P.init_batch(SimParams(telemetry=True, watchdog=True), [0], device="cpu")
    assert st.metrics.shape[1] > 0 and st.wd.shape == (1, 6)
    # So are the scenario and adversary planes (tests/test_torch_scenario.py).
    st = P.init_batch(SimParams(scenario=True, adversary=True), [0], device="cpu")
    assert st.sc_delay.shape == (1, 1024) and st.sc_commit.tolist() == [[3]]
    assert st.adv_sched.shape == (1, 4, 7) and st.adv_link.shape == (1, 3, 3)
    assert st.adv_group.shape == (1, 3) and st.adv_heal.shape == (1, 1)
    assert P.d_min_of(SimParams(scenario=True)) == 1


def _jax_sweep_parser():
    """The parser JAX ``sweeps.main`` builds (it has no builder of its own)."""
    class Got(Exception):
        pass

    def grab(self, argv=None):
        raise Got(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        jax_sweeps.main([])
    except Got as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("sweeps.main parsed no arguments")


def test_sweep_configs_and_flags_match_jax():
    for scale in (1.0, 0.1, 0.01):
        want = {k: (dataclasses.asdict(p), n, m)
                for k, (p, n, m) in jax_sweeps.baseline_configs(scale).items()}
        got = {k: (dataclasses.asdict(p), n, m)
               for k, (p, n, m) in sweeps.baseline_configs(scale).items()}
        assert got == want

    def flags(parser, drop):
        return {a.dest: (a.default, tuple(a.choices or ()))
                for a in parser._actions if a.dest not in drop}

    assert flags(sweeps.build_parser(), {"help", "device"}) == flags(
        _jax_sweep_parser(), {"help", "platform"})
    assert sweeps.build_parser().parse_args([]).device == "cuda"
    # --dp and --macro-k are ported (tests/test_torch_sharded.py runs the dp
    # path): run_all hands dp to the fleet configs and macro_k to the serial
    # ones, as JAX's does.
    args = sweeps.build_parser().parse_args(["--dp", "2", "--macro-k", "4"])
    assert (args.dp, args.macro_k) == (2, 4)
    seen = []

    def fake_run_config(p, n, engine=None, dp=0, stream=None, device="cuda"):
        seen.append((p.n_nodes, p.macro_k, engine is P, dp))
        return {}

    def fake_f_sweep(p, n, f_values, device="cuda"):
        seen.append((p.n_nodes, p.macro_k, "sweep", 0))
        return []

    from librabft_simulator_tpu_torch.sim import byzantine
    orig = sweeps.run_config, byzantine.f_sweep
    sweeps.run_config, byzantine.f_sweep = fake_run_config, fake_f_sweep
    try:
        sweeps.run_all(0.001, dp=2, macro_k=4, device="cpu")
    finally:
        sweeps.run_config, byzantine.f_sweep = orig
    assert seen == [(3, 4, False, 2), (4, 4, False, 2), (64, None, True, 2),
                    (4, 4, "sweep", 0), (16, None, True, 2)]
    # The plane and stream flags are ported (tests/test_torch_telemetry.py).
    args = sweeps.build_parser().parse_args(
        ["--telemetry", "--watchdog", "--stream-out", "x.ndjson"])
    assert args.telemetry and args.watchdog and args.stream_out == "x.ndjson"


def test_sweep_run_config_on_each_engine():
    small = SimParams(**_small_kw(max_clock=60))
    lane = sweeps.run_config(small, 2, engine=P, device="cpu")
    serial = sweeps.run_config(SimParams(n_nodes=4, max_clock=60), 2, device="cpu")
    byz = sweeps.run_config(SimParams(n_nodes=4, max_clock=60), 2, f=1,
                            device="cpu")
    for row in (lane, serial, byz):
        assert row["instances"] == 2 and row["total_rounds"] > 0
    assert byz["f"] == 1 and byz["safe_fraction"] == 1.0
    with pytest.raises(NotImplementedError):
        sweeps.run_config(small, 2, f=1, engine=P, device="cpu")
