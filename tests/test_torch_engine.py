"""The port's serial engine as a whole (librabft_simulator_tpu_torch/sim/
simulator.py) against the references on the CPU:

(a) leaf for leaf against JAX ``run_to_completion`` at the two calls the
    parity and packing suites already make (the persistent compile cache
    holds their executables);
(b) one batched BASELINE config #2 run (n=4, uniform, queue_cap=64) against
    ``OracleSim`` per instance: honest, equivocating, silent and forge-QC;
(c) an overflow-heavy queue (queue_cap=8) whose queue-full count matches;
(d) an epoch-crossing run (commands_per_epoch=6) with the epoch handoff on.

Port runs use a 32-event chunk: halted instances are exact no-ops, so the
final state does not depend on the chunk."""

import jax
import numpy as np
import pytest

from librabft_simulator_tpu.core.types import SimParams as JParams
from librabft_simulator_tpu.oracle.sim import OracleSim
from librabft_simulator_tpu.sim import simulator as JS
from tests.port_support import import_torch, release_jax_memory

CHUNK = 32


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, convert, SimParams, S
    torch = import_torch()
    from librabft_simulator_tpu_torch import convert
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.sim import simulator as S


def run_port(p, seeds, **init_kw):
    st = S.init_batch(p, seeds, device="cpu", **init_kw)
    return S.run_to_completion(p, st, chunk=CHUNK)


def jax_final_leaves(jp, seed):
    """JAX ``run_to_completion`` of one instance as ``{path: [1, ...] array}``.
    The engine's trace and executable hold about 2 GB that no later port test
    needs, so they are built into a released heap and released again before
    the port runs."""
    release_jax_memory()
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            JS.run_to_completion(jp, JS.init_state(jp, seed))):
        want[jax.tree_util.keystr(path).lstrip(".")] = np.asarray(leaf)[None]
    release_jax_memory()
    return want


@pytest.mark.parametrize("kw,seed", [
    (dict(n_nodes=4, max_clock=800, delay_kind="uniform"), 7),   # test_parity.py
    (dict(n_nodes=3, max_clock=400), 0),                          # test_packing.py
])
def test_leaf_for_leaf_against_jax(kw, seed):
    want = jax_final_leaves(JParams(**kw), seed)
    got = convert.to_reference(run_port(SimParams(**kw), [seed]))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["ctx.commit_count"].min()) > 0


def committed_chain(ref, b, node):
    cc = int(ref["ctx.commit_count"][b, node])
    h = ref["ctx.log_depth"].shape[-1]
    return [(int(ref["ctx.log_depth"][b, node, i % h]), int(ref["ctx.log_tag"][b, node, i % h]))
            for i in range(max(cc - h, 0), cc)]


def assert_instance_parity(ref, b, orc, n):
    """tests/test_parity.py::assert_parity for instance ``b`` of a batch."""
    for name in ("n_events", "clock", "stamp_ctr", "n_msgs_sent", "n_msgs_dropped",
                 "n_queue_full"):
        assert int(ref[name][b]) == getattr(orc, name), name
    for a in range(n):
        assert committed_chain(ref, b, a) == orc.committed_chain(a), f"node {a}"
        assert int(ref["ctx.last_depth"][b, a]) == orc.ctxs[a].last_depth
        assert int(ref["ctx.last_tag"][b, a]) == orc.ctxs[a].last_tag
        assert int(ref["store.current_round"][b, a]) == orc.stores[a].current_round
        assert int(ref["store.hqc_round"][b, a]) == orc.stores[a].hqc_round
        assert int(ref["store.hcr"][b, a]) == orc.stores[a].hcr
        assert int(ref["node.locked_round"][b, a]) == orc.nxs[a].locked_round


def test_config2_fleet_with_byzantine_instances_against_oracle():
    kw = dict(n_nodes=4, delay_kind="uniform", queue_cap=64, max_clock=300)
    none = [0, 0, 0, 0]
    masks = {  # per instance (seed = row): honest, equivocate, silent, forge-QC
        "byz_equivocate": [none, [0, 0, 0, 1], none, none],
        "byz_silent": [none, none, [0, 0, 0, 1], none],
        "byz_forge_qc": [none, none, none, [1, 0, 0, 0]],
    }
    init = {k: np.asarray(v, bool) for k, v in masks.items()}
    ref = convert.to_reference(run_port(SimParams(**kw), np.arange(4), **init))
    for b in range(4):
        orc = OracleSim(JParams(**kw), b, **{k: v[b] for k, v in masks.items()}).run()
        assert_instance_parity(ref, b, orc, 4)
        assert int(ref["ctx.commit_count"][b].max()) > 0


@pytest.mark.parametrize("case", ["queue_overflow", "epoch_crossing"])
def test_against_oracle_edge_shapes(case):
    if case == "queue_overflow":
        kw, seed = dict(n_nodes=4, delay_kind="uniform", queue_cap=8, max_clock=200), 0
    else:  # tests/test_epoch_handoff.py::boundary_params, horizon cut
        kw, seed = dict(n_nodes=3, commands_per_epoch=6, max_clock=700,
                        drop_prob=0.15), 3
    ref = convert.to_reference(run_port(SimParams(**kw), [seed]))
    orc = OracleSim(JParams(**kw), seed).run()
    assert_instance_parity(ref, 0, orc, kw["n_nodes"])
    if case == "queue_overflow":
        assert int(ref["n_queue_full"][0]) == orc.n_queue_full > 0
    else:
        assert max(int(e) for e in ref["store.epoch_id"][0]) >= 1
        assert orc.n_handoff_served > 0
        assert (ref["ho_epoch"][0] >= 0).any()


def test_later_slices_raise():
    for kw in (dict(telemetry=True), dict(adversary=True), dict(macro_k=4),
               dict(wrap="device")):
        with pytest.raises(NotImplementedError):
            S.init_batch(SimParams(**kw), [0], device="cpu")
    st = S.init_batch(SimParams(), [0], device="cpu")
    with pytest.raises(NotImplementedError):
        S.run_to_completion(SimParams(), st, stream=object())


def test_skipping_masked_work_is_exact(monkeypatch):
    """On the CPU the port skips work that a mask turns off for every
    instance; on the card it always queues it.  Both must give the same
    trajectory: run the card's form (nothing skipped, every Byzantine
    payload built) on the CPU and compare leaf for leaf."""
    kw = dict(n_nodes=4, delay_kind="uniform", queue_cap=64, max_clock=100)
    p = SimParams(**kw)
    init = dict(byz_equivocate=np.asarray([[0, 0, 0, 0], [0, 0, 1, 0]], bool))
    want = convert.to_reference(run_port(p, [5, 6], **init))
    assert int(want["ctx.commit_count"].max()) > 0
    from librabft_simulator_tpu_torch.core import node, store
    for mod in (S, node, store):
        monkeypatch.setattr(mod, "needed", lambda mask: True)
    dt, du = S.tables(p, "cpu")
    st = S.init_batch(p, [5, 6], device="cpu", **init)
    with torch.inference_mode():
        while not bool(st.halted.all()):
            for _ in range(CHUNK):
                st = S.step(p, dt, du, st, True, True)
    got = convert.to_reference(st)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cli_flags_match_jax(tmp_path):
    from librabft_simulator_tpu import main as jax_main
    from librabft_simulator_tpu_torch import main as port_main

    def flags(parser, drop):
        return {a.dest: (a.default, tuple(a.choices or ()))
                for a in parser._actions if a.dest not in drop}

    jf = flags(jax_main.build_parser(), {"help", "platform", "no_compile_cache"})
    pf = flags(port_main.build_parser(), {"help", "device"})
    assert pf == jf
    assert port_main.build_parser().parse_args([]).device == "cuda"
    short = ["--device", "cpu", "--nodes", "4", "--max_clock", "40"]
    assert port_main.main(short + ["--byzantine_f", "1"])["safe_fraction"] == 1.0
    out = tmp_path / "out"
    port_main.main(short + ["--output_data_files", str(out)])
    assert sorted(f.name for f in out.iterdir()) == [
        "number_of_messages.txt", "round_switches.txt", "summary.json"]
