"""The port's scenario plane (librabft_simulator_tpu_torch/serve/scenario.py
and its use in both engines) on the CPU, bit for bit:

(c) ``ScenarioSpec.plane_row`` against JAX's over 3 delay families x 2
    commit chains x 4 Byzantine schedules, with and without an attack, and
    the wire form's refusals;
(e) on both engines, a fresh heterogeneous scenario + adversary fleet of 8
    specs (three delay families, both chains, a drop rate, a static
    schedule, windows of every mode, a partition, link matrices): each slot
    equals its dedicated static run in every leaf but ``sc_*``:
    ``ScenarioSpec.to_params`` with its program installed, or, for the
    first group, the plane off with static masks in place of the open
    windows (so a quiet plane equals the plane off, and a ``[0, NEVER)``
    equivocate or forge-QC window on author X the static mask on X; the
    fleet's own static masks are clear there, so this also fails if the
    skip flags miss windowed behaviors); the ``adv_*`` leaves keep what was
    installed;
(f) four of those specs installed by ``install_rows`` into a running fleet
    of other scenarios (the install replaces the masked slots only; the
    unmasked slot already runs its spec) and run: each slot equals the
    fresh fleet's.  The lane engine runs this in the card's form, nothing
    skipped and both Byzantine payloads built every step, so the windowed
    equivocation and forged QCs, which no static mask turns on, are not
    skipped on the CPU either; the lane fleet at one lane and one drain
    step (its link matrices widen the horizon) keeps the auto shape's
    protocol state;
(g) a scenario- and adversary-armed state of each engine round-trips
    through ``convert`` and ``checkpoint.save`` / ``load(like=None)`` and
    steps on as the original; ``check_safety`` takes per-instance masks.

No JAX executable is built here: the referees are JAX's ``plane_row``
(eager ``jnp``) and the port's own static runs, which the other port files
hold against JAX and the oracle."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from fleet_shapes import FLEET_ADV_KW
from librabft_simulator_tpu.core.types import SimParams as JParams
from librabft_simulator_tpu.serve import scenario as jsc
from librabft_simulator_tpu.sim import byzantine as jbyz
from test_adversary import ATTACKS
from tests.port_support import import_torch, install_each

FAMILIES = {"uniform": {}, "lognormal": {"delay_mean": 12.0, "delay_variance": 9.0},
            "pareto": {}}


def spec_kw(family, chain, drop, max_clock):
    return dict(delay_kind=family, commit_chain=chain, drop_prob=drop,
                max_clock=max_clock, **FAMILIES[family])


#: Dedicated groups: the specs of a group share their static params.  The
#: 2-chain rule makes about twice the events per unit of time, so its
#: horizon is shorter.
GROUPS = {
    "uniform": spec_kw("uniform", 3, 0.0, 100),
    "lognormal": spec_kw("lognormal", 2, 0.05, 70),
    "pareto": spec_kw("pareto", 3, 0.0, 100),
}
#: (group, seed, schedule, authors, attack) per slot.  The static masks of
#: the fleet are clear but for one silent author; equivocation and forged
#: QCs come from windows only.
FLEET = [
    ("uniform", 7, "honest", None, None),
    ("uniform", 8, "honest", None, {"windows": [{"behavior": "equivocate", "targets": [3]}]}),
    ("uniform", 9, "honest", None, {"windows": [{"behavior": "forge_qc", "targets": [0]}]}),
    ("uniform", 10, "silent", (1,), None),
    ("lognormal", 11, "honest", None, {"windows": [
        {"behavior": "equivocate", "start": 20, "end": 60, "targets": [2]},
        {"behavior": "forge_qc", "start": 10, "end": 70, "targets": [1]}]}),
    ("lognormal", 12, "honest", None, {
        "windows": [{"behavior": "delay_leader", "start": 0, "end": 50, "arg": 6}],
        "partition": {"groups": [[0, 1], [2, 3]], "heal": 40},
        "link_delay": [[0, 2, 3, 4], [1, 0, 1, 1], [2, 2, 0, 2], [5, 1, 1, 0]]}),
    ("pareto", 13, "honest", None, {"windows": [
        {"behavior": "delay", "mode": "epoch", "start": 0, "end": 1, "targets": [2], "arg": 1},
        {"behavior": "silent", "mode": "events", "start": 60, "end": 80, "targets": [3]}]}),
    ("pareto", 14, "honest", None, {
        "windows": [{"behavior": "delay", "start": 10, "end": 40, "targets": [1], "arg": 2}],
        "link_delay": [[0, 1, 2, 1], [1, 0, 1, 2], [2, 1, 0, 1], [1, 2, 1, 0]]}),
]
#: (f): the FLEET slots installed into a running fleet of other scenarios,
#: whose last slot already runs FLEET[6] (a run continued is the same run).
INSTALLED = [1, 2, 4, 6]
BEFORE_STEPS = 8


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, convert, SimParams, P, S, sc, dsl, aplane, byzantine, ckpt
    torch = import_torch()
    from librabft_simulator_tpu_torch import convert
    from librabft_simulator_tpu_torch.adversary import dsl, plane as aplane
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.serve import scenario as sc
    from librabft_simulator_tpu_torch.sim import byzantine
    from librabft_simulator_tpu_torch.sim import checkpoint as ckpt
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S


def base():
    """The fleet's params: the JAX adversary suite's micro shape with the
    scenario plane on and telemetry off (tests/test_torch_telemetry.py
    holds the planes; off, each step here is ~15% shorter)."""
    return SimParams(**dict(FLEET_ADV_KW, scenario=True, telemetry=False, max_clock=100))


def specs():
    return [sc.ScenarioSpec(**GROUPS[g], seed=seed, byz_kind=kind,
                            byz_f=len(authors or ()), byz_authors=authors, attack=atk)
            for g, seed, kind, authors, atk in FLEET]


def engine(name):
    return {"serial": S, "lane": P}[name]


def run(eng, p, st):
    """run_to_completion; the serial engine reads ``halted`` every 16 steps
    (halted instances are exact no-ops, so the state does not depend on
    it)."""
    return eng.run_to_completion(p, st, **({"chunk": 16} if eng is S else {}))


def assert_leaves_equal(got, want, skip=()):
    assert list(got) == list(want)
    for k in want:
        if k.startswith(skip):
            continue
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def row(ref, i):
    return {k: v[i:i + 1] for k, v in ref.items()}


# ---------------------------------------------------------------------------
# (c) plane rows against JAX.
# ---------------------------------------------------------------------------


def test_plane_row_against_jax():
    kw = dict(FLEET_ADV_KW, scenario=True)
    p, jp = SimParams(**kw), JParams(**kw)
    n = 0
    for family in ("uniform", "lognormal", "pareto"):
        for chain in (2, 3):
            for kind in ("honest", "equivocate", "silent", "forge_qc"):
                for atk in (None, ATTACKS[(n // 2) % len(ATTACKS)]):
                    d = dict(delay_kind=family, commit_chain=chain, byz_kind=kind, byz_f=1,
                             drop_prob=0.05 * (n % 3), max_clock=50 + n,
                             seed=(2**32 - 1 - n) if n % 2 else n, attack=atk)
                    got = sc.ScenarioSpec.from_dict(d).plane_row(p)
                    want = jsc.ScenarioSpec.from_dict(d).plane_row(jp)
                    for name, leaf in zip(("seed", "delay_table", "drop_u32", "max_clock",
                                           "commit_chain", "byz_equivocate", "byz_silent",
                                           "byz_forge_qc", "adv_sched", "adv_link",
                                           "adv_group", "adv_heal"), (
                                               got.seed, got.delay_table, got.drop_u32,
                                               got.max_clock, got.commit_chain,
                                               got.byz_equivocate, got.byz_silent,
                                               got.byz_forge_qc, got.adv_sched, got.adv_link,
                                               got.adv_group, got.adv_heal)):
                        w = np.asarray(getattr(want, name))
                        g = leaf.numpy()
                        if name in got.U32:
                            g = g.view(np.uint32)
                        assert g.dtype == w.dtype and g.shape == w.shape, name
                        np.testing.assert_array_equal(g, w, err_msg=f"{d} {name}")
                    n += 1
    assert n == 48
    default = sc.default_row(p, seed=5)
    jdefault = jsc.default_row(jp, seed=5)
    np.testing.assert_array_equal(default.delay_table.numpy(), np.asarray(jdefault.delay_table))
    assert int(default.commit_chain) == int(jdefault.commit_chain) == 3
    # One slot from its row is the fleet's batch of one.
    spec = sc.ScenarioSpec(delay_kind="pareto", commit_chain=2, seed=9, attack=ATTACKS[2])
    assert_leaves_equal(convert.to_reference(sc.init_slot(p, spec.plane_row(p), device="cpu")),
                        convert.to_reference(sc.init_specs(p, [spec], device="cpu")))


def test_spec_refusals_match_jax():
    cases = [
        ("unknown scenario field", dict(delay_kindd="pareto")),
        ("unknown Byzantine schedule", dict(byz_kind="crash")),
        ("commit_chain must be 2 or 3", dict(commit_chain=4)),
        ("unknown attack field", dict(attack={"windoes": []})),
    ]
    for match, d in cases:
        for mod in (sc, jsc):
            with pytest.raises(ValueError, match=match):
                mod.ScenarioSpec.from_dict(d)
    spec = sc.ScenarioSpec(attack=ATTACKS[0])
    assert sc.ScenarioSpec.from_dict(spec.to_dict()) == spec
    assert spec.to_dict() == jsc.ScenarioSpec(attack=ATTACKS[0]).to_dict()
    off = SimParams(**dict(FLEET_ADV_KW, adversary=False, scenario=True))
    with pytest.raises(ValueError, match="adversary=False"):
        spec.plane_row(off)
    with pytest.raises(ValueError, match="scenario=True"):
        sc.init_specs(dataclasses.replace(off, scenario=False), [sc.ScenarioSpec()],
                      device="cpu")


# ---------------------------------------------------------------------------
# (e), (f) the fleet on both engines.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_run():
    """``fleet_run(name)``: the fresh fleet of FLEET run to the end on one
    engine, with the CPU's skipping and the flags ``byz_flags`` reads; each
    engine's run is made once and shared by the tests below."""
    runs = {}

    def get(name):
        if name not in runs:
            eng, p = engine(name), base()
            st = sc.init_specs(p, specs(), engine=eng, device="cpu")
            assert S.byz_flags(p, st) == (True, True)
            assert not (st.byz_equivocate.any() or st.byz_forge_qc.any())
            runs[name] = convert.to_reference(run(eng, p, st))
        return runs[name]

    return get


@pytest.mark.parametrize("name", ["serial", "lane"])
def test_fleet_slots_equal_their_dedicated_runs(name, fleet_run):
    eng, p, fleet = engine(name), base(), specs()
    final = fleet_run(name)
    for group in GROUPS:
        idx = [i for i, f in enumerate(FLEET) if f[0] == group]
        members = [fleet[i] for i in idx]
        pg = members[0].to_params(p)
        progs = [s.attack_program() for s in members]
        masks = [np.stack(m) for m in zip(*(s.byz_masks(p) for s in members))]
        if group == "uniform":
            # The plane off; the open windows become static masks.
            pg = dataclasses.replace(pg, adversary=False)
            for j, s in enumerate(members):
                for pr in progs[j].windows if progs[j] else ():
                    m = {"equivocate": 0, "silent": 1, "forge_qc": 2}[pr.behavior]
                    masks[m][j, list(pr.targets)] = True
        st = eng.init_batch(pg, [s.seed for s in members], device="cpu", **dict(zip(
            ("byz_equivocate", "byz_silent", "byz_forge_qc"), masks)))
        if pg.adversary:
            st = install_each(pg, st, progs)
        ded = convert.to_reference(run(eng, pg, st))
        skip = ("sc_", "adv_", "byz_") if group == "uniform" else ("sc_",)
        for j, i in enumerate(idx):
            assert_leaves_equal(row(final, i), row(ded, j), skip=skip)
        assert int(ded["ctx.commit_count"].max()) > 0, group
    # The adversary rows are read only; the per-slot knobs are the specs'.
    for i, s in enumerate(fleet):
        for k, v in s.adv_rows(p).items():
            np.testing.assert_array_equal(final[k][i], v, err_msg=k)
        assert int(final["sc_commit"][i, 0]) == s.commit_chain
        assert int(final["max_clock"][i]) == s.max_clock
    assert int(final["n_msgs_dropped"][5]) > 0


@pytest.mark.parametrize("name", ["serial", "lane"])
def test_installed_slots_run_as_the_fresh_fleet(name, monkeypatch, fleet_run):
    eng, p, fleet = engine(name), base(), specs()
    final = fleet_run(name)
    chosen = [fleet[i] for i in INSTALLED]
    other = [sc.ScenarioSpec(delay_kind="uniform", max_clock=40, seed=30 + i)
             for i in range(len(chosen) - 1)] + chosen[-1:]
    st = sc.init_specs(p, other, engine=eng, device="cpu")
    dt, du = S.tables(p, "cpu")

    def step(x, *flags):
        with torch.inference_mode():
            return (S.step(p, dt, du, x, *flags) if eng is S
                    else P.step(p, dt, du, P.d_min_of(p), x, *flags))

    for _ in range(BEFORE_STEPS):
        st = step(st)
    before = convert.to_reference(st)
    donor = sc.init_specs(p, chosen, engine=eng, device="cpu")
    fresh = convert.to_reference(donor)
    mask = np.arange(len(chosen)) < len(chosen) - 1
    st = sc.install_rows(st, mask, donor)
    after = convert.to_reference(st)
    for i in range(len(chosen)):
        assert_leaves_equal(row(after, i), row(fresh if mask[i] else before, i))
    if eng is S:
        st = run(eng, p, st)
    else:
        # The card's form: nothing skipped, both Byzantine payloads built.
        from librabft_simulator_tpu_torch.core import node, store
        for mod in (P, S, node, store):
            monkeypatch.setattr(mod, "needed", lambda mask: True)
        while not bool(st.halted.all()):
            st = step(st, True, True)
    assert_leaves_equal(convert.to_reference(st), {k: v[INSTALLED] for k, v in final.items()})


def test_lane_window_shape_under_link_matrices(fleet_run):
    """Slots 5 and 7 carry link matrices, which widen their lanes' horizon
    by the least off-diagonal entry (tests/test_adversary.py::
    test_per_link_horizon_composition_invariance on the port): at one lane
    and one drain step every slot keeps the auto shape's protocol state
    (window shape moves only the inbox layout, the clock and the order of
    the round-switch trace ring)."""
    p = dataclasses.replace(base(), active_lanes=1, drain_k=1)
    linked = [5, 7]
    got = convert.to_reference(run(
        P, p, sc.init_specs(p, [specs()[i] for i in linked], engine=P, device="cpu")))
    want = {k: v[linked] for k, v in fleet_run("lane").items()}
    assert int(want["n_inbox_full"].sum()) == 0
    assert aplane.link_lookahead(torch.as_tensor(got["adv_link"]), 4).tolist() == [1, 1]
    assert_leaves_equal(got, want, skip=P.INBOX + (
        "clock", "trace_node", "trace_round", "trace_time"))


# ---------------------------------------------------------------------------
# (g) checkpoints, convert, per-instance safety masks.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["serial", "lane"])
def test_armed_state_round_trips(name, tmp_path):
    eng, p = engine(name), base()
    st = sc.init_specs(p, specs(), engine=eng, device="cpu")
    dt, du = S.tables(p, "cpu")

    def step(x):
        with torch.inference_mode():
            return (S.step(p, dt, du, x) if eng is S
                    else P.step(p, dt, du, P.d_min_of(p), x))

    for _ in range(4):
        st = step(st)
    ref = convert.to_reference(st)
    path = str(tmp_path / "armed.npz")
    ckpt.save(path, st)
    copies = [convert.from_reference(ref, device="cpu"), ckpt.load(path, p, device="cpu")]
    for c in copies:
        assert_leaves_equal(convert.to_reference(c), ref)
        assert c.adv_sched.shape == (len(FLEET), p.adv_windows, 7)
        assert c.sc_delay.shape == (len(FLEET), 1024)
    for _ in range(3):
        st = step(st)
        copies = [step(c) for c in copies]
    want = convert.to_reference(st)
    for c in copies:
        assert_leaves_equal(convert.to_reference(c), want)


def test_check_safety_takes_per_instance_masks():
    p = base()
    fleet = specs()
    honest = sc.honest_masks(p, fleet)
    jhonest = np.stack([~(np.asarray(jsc.ScenarioSpec(**dataclasses.asdict(s)).byz_masks(
        JParams(**dict(FLEET_ADV_KW, scenario=True))))).any(axis=0) for s in fleet])
    for i, s in enumerate(fleet):   # the windows' Byzantine targets leave too
        prog = s.attack_program()
        for t in (dsl.byz_targets(prog) if prog else ()):
            jhonest[i, t] = False
    np.testing.assert_array_equal(honest, jhonest)
    assert honest.tolist()[1] == [True, True, True, False]
    st = sc.init_specs(p, fleet, device="cpu")
    cc = torch.full_like(st.ctx.commit_count, 1)
    depth = torch.ones_like(st.ctx.log_depth)
    tag = torch.zeros_like(st.ctx.log_tag)
    tag[:, 3, 0] = 9      # node 3 disagrees at depth 1 in every instance
    planted = SimpleNamespace(ctx=SimpleNamespace(log_depth=depth, log_tag=tag, commit_count=cc))
    safe = byzantine.check_safety(planted, honest)
    assert safe.tolist() == [not h[3] for h in honest.tolist()] == \
        byzantine.check_safety_reference(planted, honest).tolist()
    assert byzantine.check_safety(planted).tolist() == [False] * len(fleet)
    assert jbyz.SCHEDULES == byzantine.SCHEDULES


# ---------------------------------------------------------------------------
# slow: the serial engine against JAX init_specs + run_to_completion.
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_serial_scenario_fleet_against_jax():
    """The fleet of FLEET on the serial engine against JAX ``init_specs`` +
    ``run_to_completion``, every leaf, at FLEET_ADV_SERVE_KW (scenario,
    adversary and watchdog on), as tests/test_adversary.py::
    test_adversarial_fleet_bit_identical_per_slot runs its fleet (builds a
    JAX serial executable)."""
    import jax
    from fleet_shapes import FLEET_ADV_SERVE_KW, SERVE_CHUNK
    from librabft_simulator_tpu.sim import simulator as JS
    from tests.port_support import release_jax_memory

    kw = dict(FLEET_ADV_SERVE_KW, max_clock=300)
    jp, p = JParams(**kw), SimParams(**kw)
    fleet = specs()
    release_jax_memory()
    st = jsc.init_specs(jp, [jsc.ScenarioSpec(**s.to_dict()) for s in fleet])
    st = JS.run_to_completion(jp, st, batched=True, chunk=SERVE_CHUNK)
    want = {jax.tree_util.keystr(k).lstrip("."): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(st)}
    del st
    release_jax_memory()
    got = convert.to_reference(S.run_to_completion(p, sc.init_specs(p, fleet, device="cpu")))
    assert_leaves_equal(got, want)
    assert int(got["ctx.commit_count"].max()) > 0
