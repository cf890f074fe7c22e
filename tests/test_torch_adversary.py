"""The port's adversary plane (librabft_simulator_tpu_torch/adversary/ and
its use in both engines) against the JAX package on the CPU, bit for bit:

(a) the batched decode (``active_windows``, ``node_masks``,
    ``delay_extra``, ``link_lookahead``) against JAX ``adversary/plane.py``
    called eagerly (vmapped over rows) on random schedules: n=4 and n=64,
    targets above 31, the all-ones ``-1`` mask, keys at ``lo`` / ``hi`` and
    at NEVER, and ``link_lookahead`` at n=1;
(b) the DSL against JAX's: ``lower`` on ``tests/test_adversary.py::
    ATTACKS``, 200 ``sample_program`` draws per committee size from equal
    ``random.Random`` seeds, the wire form, ``describe()`` and the
    validation errors;
(d) the serial engine against ``OracleSim(attack=...)`` under the three
    programs of JAX's oracle tests, pinned as ``oracle_pin`` pins them.

The fleet identities of both engines (a quiet plane equals the plane off,
open windows equal static masks, each slot equals its dedicated static run,
skipping stays exact, installs, the lane horizon under link matrices) are
in tests/test_torch_scenario.py.

No JAX executable is built here: the referees are eager ``jnp`` calls,
numpy lowering and the oracle."""

import random

import jax
import numpy as np
import pytest

from fleet_shapes import FLEET_ADV_KW
from librabft_simulator_tpu.adversary import dsl as jdsl, plane as jplane
from librabft_simulator_tpu.core.types import SimParams as JParams
from librabft_simulator_tpu.oracle.sim import OracleSim
from test_adversary import ATTACKS
from tests.port_support import import_torch, install_each

NEVER = 2**31 - 1
#: The JAX oracle tests' three programs (tests/test_adversary.py) with
#: their seeds.
ORACLE_PROGRAMS = {
    "composed": (11, {
        "windows": [{"behavior": "equivocate", "start": 50, "end": 200, "targets": [1]},
                    {"behavior": "delay_leader", "start": 0, "end": 250, "arg": 15}],
        "partition": {"groups": [[0, 1], [2, 3]], "heal": 120},
        "link_delay": [[0, 2, 3, 4], [1, 0, 1, 1], [2, 2, 0, 2], [5, 1, 1, 0]]}),
    "silence_heals": (23, {
        "windows": [{"behavior": "silent", "start": 0, "end": 150, "targets": [0]}]}),
    "epoch_and_events": (31, {
        "windows": [{"behavior": "forge_qc", "mode": "epoch", "start": 1, "end": 2,
                     "targets": [2]},
                    {"behavior": "delay", "mode": "events", "start": 40, "end": 160,
                     "targets": [0, 3], "arg": 11}]}),
}


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, convert, SimParams, P, S, dsl, aplane, byzantine
    torch = import_torch()
    from librabft_simulator_tpu_torch import convert
    from librabft_simulator_tpu_torch.adversary import dsl, plane as aplane
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.sim import byzantine
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S


def assert_leaves_equal(got, want, rows=None, skip=()):
    for k, v in want.items():
        if k.startswith(skip):
            continue
        g = got[k] if rows is None else got[k][rows]
        w = v if rows is None else v[rows]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# ---------------------------------------------------------------------------
# (a) the decode.
# ---------------------------------------------------------------------------


def random_schedules(rng, rows, w, n):
    """``[rows, w, 7]`` int32 schedules: every mode and behavior, bounds in
    [0, 40) with some rows open to NEVER, random 64-bit target masks (some
    all ones, some with only bits above 31), args around [0, DELAY_CAP]."""
    s = np.zeros((rows, w, 7), np.int64)
    s[..., 0] = rng.integers(0, 3, (rows, w))
    s[..., 1] = rng.integers(0, 40, (rows, w))
    s[..., 2] = s[..., 1] + rng.integers(-2, 20, (rows, w))
    s[..., 2][rng.random((rows, w)) < 0.15] = NEVER
    s[..., 3] = rng.integers(0, 6, (rows, w))
    s[..., 4] = rng.integers(-2**31, 2**31, (rows, w))
    s[..., 5] = rng.integers(-2**31, 2**31, (rows, w))
    s[..., 4:6][rng.random((rows, w)) < 0.15] = -1
    high = rng.random((rows, w)) < 0.15
    s[..., 4][high] = 0
    s[..., 6] = rng.integers(-5, jplane.DELAY_CAP + 6, (rows, w))
    if n < 64:
        s[..., 4:6] &= (1 << n) - 1 if n < 32 else -1
    return s.astype(np.int32)


@pytest.mark.parametrize("n", [4, 64])
def test_decode_against_jax(n):
    rng = np.random.default_rng(n)
    rows, w, c = 96, 5, 9
    sched = random_schedules(rng, rows, w, n)
    t = rng.integers(0, 45, rows).astype(np.int32)
    ev = rng.integers(0, 45, rows).astype(np.int32)
    ep = rng.integers(0, 45, rows).astype(np.int32)
    # Keys on the window edges: at lo, at hi - 1, at hi, and NEVER.
    edge = np.arange(rows) % 4
    for i in range(rows):
        lo, hi = sched[i, 0, 1], sched[i, 0, 2]
        key = [lo, hi - 1, hi, NEVER][edge[i]]
        t[i] = ev[i] = ep[i] = np.int32(key)
    node = rng.integers(0, n, rows).astype(np.int32)
    node[:8] = np.arange(8) % n if n < 32 else np.arange(32, 40)
    recvs = rng.integers(0, n, (rows, c)).astype(np.int32)
    leader = rng.integers(0, n, rows).astype(np.int32)
    link = rng.integers(-4, jplane.DELAY_CAP + 4, (rows, n, n)).astype(np.int32)
    link[:4] = rng.integers(0, 3, (4, n, n))

    # Each JAX decode as one jitted call (op by op, ~45 small XLA compiles).
    want_act = np.asarray(jax.jit(jax.vmap(jplane.active_windows))(sched, t, ev, ep))
    want_masks = [np.asarray(m)
                  for m in jax.jit(jax.vmap(jplane.node_masks))(sched, want_act, node)]
    want_extra = np.asarray(jax.jit(jax.vmap(jplane.delay_extra))(sched, want_act, recvs, leader))
    want_look = np.asarray(jax.jit(jax.vmap(lambda lk: jplane.link_lookahead(lk, n)))(link))

    T = torch.as_tensor
    act = aplane.active_windows(T(sched), T(t), T(ev), T(ep))
    np.testing.assert_array_equal(act.numpy(), want_act)
    assert want_act.any() and not want_act.all()
    for got, want in zip(aplane.node_masks(T(sched), act, T(node)), want_masks):
        np.testing.assert_array_equal(got.numpy(), want)
    extra = aplane.delay_extra(T(sched), act, T(recvs), T(leader))
    assert extra.dtype == torch.int32
    np.testing.assert_array_equal(extra.numpy(), want_extra)
    assert want_extra.any()
    look = aplane.link_lookahead(T(link), n)
    np.testing.assert_array_equal(look.numpy(), want_look)


def test_link_lookahead_single_node_and_host_plane():
    one = np.asarray([[[7]], [[-3]]], np.int32)
    want = [int(jplane.link_lookahead(x, 1)) for x in one]
    got = aplane.link_lookahead(torch.as_tensor(one), 1).tolist()
    assert got == want == [jplane.DELAY_CAP] * 2
    # The host decode mirrors JAX's on a hand-built schedule.
    rng = np.random.default_rng(5)
    sched = random_schedules(rng, 1, 6, 40)[0]
    link = rng.integers(-2, 30, (40, 40)).astype(np.int32)
    group = rng.integers(0, 2, 40).astype(np.int32)
    hp, jp = aplane.HostPlane(sched, link, group, [17]), jplane.HostPlane(sched, link, group, [17])
    for t, node, recv in [(0, 0, 1), (5, 33, 39), (20, 12, 35), (39, 39, 0)]:
        assert hp.node_masks(t, t, t, node) == jp.node_masks(t, t, t, node)
        assert hp.delay_extra(t, t, t, recv, node) == jp.delay_extra(t, t, t, recv, node)
        assert hp.link_extra(node, recv) == jp.link_extra(node, recv)
        assert hp.cut(node, recv, t) == jp.cut(node, recv, t)
    assert hp.describe() == jp.describe()


# ---------------------------------------------------------------------------
# (b) the DSL.
# ---------------------------------------------------------------------------


def rows_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("i", range(len(ATTACKS)))
def test_lower_against_jax(i):
    p, jp = SimParams(**FLEET_ADV_KW), JParams(**FLEET_ADV_KW)
    prog, jprog = dsl.AttackProgram.from_dict(ATTACKS[i]), jdsl.AttackProgram.from_dict(ATTACKS[i])
    rows_equal(prog.lower(p), jprog.lower(jp))
    assert prog.to_dict() == jprog.to_dict()
    assert sorted(dsl.byz_targets(prog)) == sorted(jdsl.byz_targets(jprog))
    assert prog.host_plane(p).describe() == jprog.host_plane(jp).describe()
    st = prog.install(p, S.init_batch(p, [1, 2], device="cpu"))
    for k, v in prog.lower(p).items():
        np.testing.assert_array_equal(getattr(st, k).numpy(), np.broadcast_to(v, (2,) + v.shape))


@pytest.mark.parametrize("n", [4, 16])
def test_sample_program_against_jax(n):
    kw = dict(FLEET_ADV_KW, n_nodes=n)
    p, jp = SimParams(**kw), JParams(**kw)
    for seed in range(200):
        prog = dsl.sample_program(p, random.Random(seed), horizon=300)
        jprog = jdsl.sample_program(jp, random.Random(seed), horizon=300)
        assert prog.to_dict() == jprog.to_dict(), seed
        rows_equal(prog.lower(p), jprog.lower(jp))
        assert prog.host_plane(p).describe() == jprog.host_plane(jp).describe()
        assert dsl.byz_targets(prog) == jdsl.byz_targets(jprog)
    grid = list(dsl.sweep(p, starts=(0, 100), durations=(50,), targets=((0,), (1,))))
    jgrid = list(jdsl.sweep(jp, starts=(0, 100), durations=(50,), targets=((0,), (1,))))
    assert [g.to_dict() for g in grid] == [g.to_dict() for g in jgrid] and len(grid) == 8


def test_dsl_round_trip_and_validation():
    """tests/test_adversary.py::test_dsl_validation and
    ::test_dsl_round_trip_and_unknown_fields, case for case, on the port:
    every case raises the JAX package's ValueError."""
    p = SimParams(**FLEET_ADV_KW)
    p_off = SimParams(**{k: v for k, v in FLEET_ADV_KW.items()
                         if k not in ("adversary", "adv_windows")})
    silent0 = dsl.AttackProgram(windows=(dsl.Window(behavior="silent", targets=(0,)),))
    cases = [
        ("unknown behavior", lambda: dsl.Window(behavior="omission")),
        ("unknown window mode", lambda: dsl.Window(behavior="silent", mode="rounds")),
        ("bounds", lambda: dsl.Window(behavior="silent", start=10, end=5)),
        ("arg", lambda: dsl.Window(behavior="delay", arg=-1)),
        ("target 9", lambda: dsl.AttackProgram(
            windows=(dsl.Window(behavior="silent", targets=(9,)),)).validate(p)),
        ("adversary=True", lambda: silent0.validate(p_off)),
        ("exceed the plane capacity", lambda: dsl.AttackProgram(windows=tuple(
            dsl.Window(behavior="silent", targets=(0,))
            for _ in range(p.adv_windows + 1))).validate(p)),
        ("two partition groups", lambda: dsl.Partition(groups=((0, 1), (1, 2)))),
        ("4x4", lambda: dsl.AttackProgram(link_delay=((0, 1), (1, 0))).validate(p)),
        ("link delay", lambda: dsl.AttackProgram(link_delay=tuple(
            tuple(aplane.DELAY_CAP + 1 for _ in range(4)) for _ in range(4))).validate(p)),
        ("unknown attack field", lambda: dsl.AttackProgram.from_dict({"window": []})),
        ("unknown field", lambda: dsl.AttackProgram.from_dict(
            {"windows": [{"behavior": "silent", "targett": [0]}]})),
    ]
    for match, fn in cases:
        with pytest.raises(ValueError, match=match):
            fn()
    for atk in ATTACKS:
        prog = dsl.AttackProgram.from_dict(atk)
        assert dsl.AttackProgram.from_dict(prog.to_dict()) == prog
    rows = aplane.default_rows(p)
    assert aplane.HostPlane(*rows.values()).describe() == jplane.HostPlane(
        *jplane.default_rows(JParams(**FLEET_ADV_KW)).values()).describe()
    rows_equal(aplane.default_rows(p_off), jplane.default_rows(JParams(**{
        k: v for k, v in FLEET_ADV_KW.items() if k not in ("adversary", "adv_windows")})))


# ---------------------------------------------------------------------------
# (d) the serial engine against the oracle.
# ---------------------------------------------------------------------------


def oracle_pin(ref, b, orc, n):
    """tests/test_adversary.py::oracle_pin for instance ``b`` of a batch."""
    for name in ("n_events", "clock", "stamp_ctr", "n_msgs_sent", "n_msgs_dropped"):
        assert int(ref[name][b]) == getattr(orc, name), name
    h = ref["ctx.log_depth"].shape[-1]
    for a in range(n):
        cc = int(ref["ctx.commit_count"][b, a])
        chain = [(int(ref["ctx.log_depth"][b, a, i % h]), int(ref["ctx.log_tag"][b, a, i % h]))
                 for i in range(max(cc - h, 0), cc)]
        assert chain == orc.committed_chain(a), a


@pytest.fixture(scope="module")
def oracle_batch():
    """The three programs as one batch, a row each, at commands_per_epoch
    6 (the window program's; the other two run at it too, and the oracle
    with them) to tests/test_adversary.py's horizon of 300: (params, final
    leaves)."""
    kw = dict(FLEET_ADV_KW, max_clock=300, commands_per_epoch=6)
    p = SimParams(**kw)
    seeds = [seed for seed, _ in ORACLE_PROGRAMS.values()]
    progs = [dsl.AttackProgram.from_dict(d) for _, d in ORACLE_PROGRAMS.values()]
    st = install_each(p, S.init_batch(p, seeds, device="cpu"), progs)
    return kw, convert.to_reference(S.run_to_completion(p, st, chunk=32))


@pytest.mark.parametrize("name", list(ORACLE_PROGRAMS))
def test_serial_against_oracle(name, oracle_batch):
    kw, ref = oracle_batch
    b = list(ORACLE_PROGRAMS).index(name)
    seed, attack = ORACLE_PROGRAMS[name]
    orc = OracleSim(JParams(**kw), seed, attack=attack).run()
    oracle_pin(ref, b, orc, kw["n_nodes"])
    if name == "composed":
        assert orc.n_msgs_dropped > 0   # the partition cut traffic
        prog = dsl.AttackProgram.from_dict(attack)
        honest = ~np.isin(np.arange(4), sorted(dsl.byz_targets(prog)))
        st1 = S.select_instances(convert.from_reference(ref, device="cpu"), [b])
        assert byzantine.check_safety_reference(st1, honest)[0]
    elif name == "silence_heals":   # node 0 speaks again after the window
        assert int(ref["n_msgs_sent"][b]) > 0 and int(ref["ctx.commit_count"][b].sum()) > 0


# ---------------------------------------------------------------------------
# slow: the lane engine against the JAX lane engine.
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_lane_attacks_against_jax():
    """The lane engine with the adversary plane against the JAX lane engine,
    leaf for leaf, at FLEET_ADV_LANE_KW: one instance per program of
    ``ATTACKS``, each with its own rows (builds a JAX lane executable)."""
    import jax.numpy as jnp
    from fleet_shapes import FLEET_ADV_LANE_KW
    from librabft_simulator_tpu.sim import parallel_sim as JP
    from librabft_simulator_tpu.sim.simulator import dedupe_buffers
    from tests.port_support import release_jax_memory

    kw = dict(FLEET_ADV_LANE_KW, max_clock=300)
    jp, p = JParams(**kw), SimParams(**kw)
    seeds = np.arange(200, 200 + len(ATTACKS), dtype=np.uint32)
    rows = [jdsl.AttackProgram.from_dict(a).lower(jp) for a in ATTACKS]
    release_jax_memory()
    st = JP.init_batch(jp, seeds)
    st = dedupe_buffers(st.replace(**{k: jnp.stack([r[k] for r in rows]) for k in rows[0]}))
    run = JP.make_run_fn(jp, 64)
    for _ in range(100):
        st = run(st)
        if bool(np.all(np.asarray(st.halted))):
            break
    want = {jax.tree_util.keystr(k).lstrip("."): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(st)}
    del st, run
    release_jax_memory()
    st = install_each(p, P.init_batch(p, seeds, device="cpu"),
                      [dsl.AttackProgram.from_dict(a) for a in ATTACKS])
    got = convert.to_reference(P.run_to_completion(p, st))
    assert_leaves_equal(got, want)
    assert list(got) == list(want)
    assert int(got["n_msgs_dropped"].sum()) > 0 and int(got["ctx.commit_count"].max()) > 0
