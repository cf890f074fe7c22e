"""The port's Byzantine slice against the references on the CPU:

(d) the safety check (librabft_simulator_tpu_torch/sim/byzantine.py):
    ``check_safety`` (the device reduction) and ``check_safety_reference``
    against JAX ``check_safety_reference`` (numpy only) on crafted logs with
    conflicts, ring wrap past ``commit_log`` and masked-out dishonest nodes;
    ``byz_masks`` and ``schedule_masks`` against JAX;
(e) the serial engine's ``shuffle_receivers`` against ``OracleSim``;
(f) the CLI: ``--byzantine_f`` gives the summary of ``init_fault_batch`` +
    ``run_to_completion`` + ``check_safety``, ``--output_data_files`` writes
    the files JAX ``DataWriter`` writes from the same leaves, and the serial
    trace ring (``trace_cap`` 4096) equals ``OracleSim``'s."""

import json
import types

import numpy as np
import pytest

from librabft_simulator_tpu.analysis.data_writer import DataWriter as JaxDataWriter
from librabft_simulator_tpu.core.types import SimParams as JParams
from librabft_simulator_tpu.oracle.sim import OracleSim
from librabft_simulator_tpu.sim import byzantine as JB
from tests.port_support import import_torch
from tests.test_torch_engine import assert_instance_parity

CHUNK = 32


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, convert, SimParams, B, S, port_main, data_writer
    torch = import_torch()
    from librabft_simulator_tpu_torch import convert
    from librabft_simulator_tpu_torch import main as port_main
    from librabft_simulator_tpu_torch.analysis import data_writer
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.sim import byzantine as B
    from librabft_simulator_tpu_torch.sim import simulator as S


def crafted_logs(seed=3, b=96, n=4, h=8):
    """Commit rings with few distinct depths and tags (so conflicts occur),
    commit counts past the ring size (wrap), and three hand-made cases."""
    rng = np.random.default_rng(seed)
    depth = rng.integers(0, 12, (b, n, h)).astype(np.int32)
    tag = rng.integers(0, 3, (b, n, h)).astype(np.int32)
    tag[rng.random((b, n, h)) < 0.7] = 7    # mostly agreeing tags
    tag[:, :, :] = np.where(rng.random((b, 1, 1)) < 0.5, 7, tag)
    cc = rng.integers(0, 2 * h + 3, (b, n)).astype(np.int32)
    # Instance 0: one conflict between nodes 0 and 1, at live ring
    # positions.  Instance 1: the same conflict at a position node 1 has not
    # written yet (commit count 2).  Instance 2: the conflict is with node 3
    # only.  The random instances wrap their rings (commit counts up to 2h+2).
    for i in range(3):
        depth[i] = np.arange(n * h).reshape(n, h) + 100
        tag[i] = 7
        cc[i] = h
    depth[0, 1, 2], tag[0, 1, 2] = depth[0, 0, 5], 9
    depth[1, 1, 2], tag[1, 1, 2] = depth[1, 0, 5], 9
    cc[1, 1] = 2
    depth[2, 3, 0], tag[2, 3, 0] = depth[2, 0, 0], 9
    return depth, tag, cc


def ctx_state(lib, depth, tag, cc):
    ctx = types.SimpleNamespace(log_depth=lib(depth), log_tag=lib(tag),
                                commit_count=lib(cc))
    return types.SimpleNamespace(ctx=ctx)


@pytest.mark.parametrize("honest", [None, [1, 1, 1, 0], [0, 1, 1, 1]])
def test_safety_check_against_jax_reference(honest):
    depth, tag, cc = crafted_logs()
    want = JB.check_safety_reference(ctx_state(np.asarray, depth, tag, cc), honest)
    st = ctx_state(torch.as_tensor, depth, tag, cc)
    np.testing.assert_array_equal(B.check_safety(st, honest), want)
    np.testing.assert_array_equal(B.check_safety_reference(st, honest), want)
    assert want.any() and not want.all()
    assert want[1]                      # the conflict is not in node 1's log
    both = (lambda a, c: honest is None or (honest[a] and honest[c]))
    assert want[0] != both(0, 1) and want[2] != both(0, 3)


def test_fault_masks_against_jax():
    for n in (4, 7):
        jp, p = JParams(n_nodes=n), SimParams(n_nodes=n)
        for kind in JB.SCHEDULES:
            for f, authors in ((0, None), (1, None), (2, None), (0, [1, n - 1])):
                want = JB.schedule_masks(jp, kind, f, authors)
                got = B.schedule_masks(p, kind, f, authors)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, np.asarray(w))
                if kind != "honest":
                    for g, w in zip(B.byz_masks(p, f, kind, authors),
                                    JB.byz_masks(jp, f, kind, authors)):
                        np.testing.assert_array_equal(g, np.asarray(w))
    assert B.SCHEDULES == JB.SCHEDULES
    with pytest.raises(ValueError):
        B.schedule_masks(SimParams(), "bogus")


def test_shuffle_receivers_against_oracle():
    kw = dict(n_nodes=4, delay_kind="uniform", queue_cap=64, max_clock=150,
              shuffle_receivers=True)
    st = S.run_to_completion(SimParams(**kw), S.init_batch(
        SimParams(**kw), [0, 1], device="cpu"), chunk=CHUNK)
    ref = convert.to_reference(st)
    for b in range(2):
        assert_instance_parity(ref, b, OracleSim(JParams(**kw), b).run(), 4)
    assert int(ref["ctx.commit_count"].max()) > 0


def test_cli_byzantine_and_data_files(tmp_path, monkeypatch):
    """One CLI run with both flags: its summary equals the library calls',
    its files equal JAX DataWriter's from the same leaves, and its trace ring
    equals the oracle's."""
    written = {}
    orig = data_writer.DataWriter.write

    def keep(self, st, instance=None):
        written["st"] = st
        return orig(self, st, instance)

    monkeypatch.setattr(data_writer.DataWriter, "write", keep)
    argv = ["--device", "cpu", "--nodes", "4", "--delay", "uniform",
            "--max_clock", "150", "--seed", "0", "--instances", "2",
            "--byzantine_f", "1", "--output_data_files", str(tmp_path / "port")]
    got = port_main.main(argv)

    kw = dict(n_nodes=4, delay_kind="uniform", max_clock=150, queue_cap=64,
              trace_cap=4096)
    p = SimParams(**kw)
    st = S.run_to_completion(p, B.init_fault_batch(p, [0, 1], 1, device="cpu"),
                             chunk=CHUNK)
    honest = np.arange(4) >= 1
    cc = st.ctx.commit_count.numpy()
    assert got["safe_fraction"] == float(B.check_safety(st, honest).mean()) == 1.0
    assert got["mean_commits_per_node"] == float(cc.mean()) > 0
    for key, leaf in (("total_events", "n_events"), ("msgs_sent", "n_msgs_sent"),
                      ("msgs_dropped", "n_msgs_dropped")):
        assert got[key] == int(getattr(st, leaf).sum()), key

    # The files, against JAX DataWriter on the CLI run's own leaves.
    ref = convert.to_reference(written["st"])
    leaves = types.SimpleNamespace(**{k: v for k, v in ref.items() if "." not in k})
    leaves.ctx = types.SimpleNamespace(
        **{k[4:]: v for k, v in ref.items() if k.startswith("ctx.")})
    JaxDataWriter(JParams(**kw), str(tmp_path / "jax")).write(leaves, instance=0)
    for name in ("round_switches.txt", "number_of_messages.txt", "summary.json"):
        a = (tmp_path / "port" / name).read_bytes()
        assert a == (tmp_path / "jax" / name).read_bytes(), name
    assert json.loads((tmp_path / "port" / "summary.json").read_text())["max_round"] > 2

    # The trace ring of instance 0, against the oracle's.
    orc = OracleSim(JParams(**kw), 0, byz_equivocate=np.arange(4) < 1).run()
    assert_instance_parity(ref, 0, orc, 4)
    assert int(ref["trace_count"][0]) == orc.trace_count > 0
    for f in ("trace_node", "trace_round", "trace_time"):
        assert ref[f][0].tolist() == getattr(orc, f), f
