"""The hand-written CUDA select kernel (librabft_simulator_tpu_torch/csrc/
select_events.cu) equals its plain PyTorch versions bit for bit at the main
path's shapes, through both entries: select_events on [B, M] rows (tie and
all-NEVER rows, a row-strided view) and select_queue_events on the engine's
queue read in place (stale invalid slots, message/timer ties, all-invalid
rows with all-NEVER timers, full queues, a last partial tile).  Needs a card: the tests
carry the ``cuda`` marker and skip elsewhere.  This file imports neither
jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import glob
import shutil

import numpy as np
import pytest

NEVER = 2**31 - 1


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs (not
    when it is collected: every xdist worker collects every file).  A machine
    with neither an NVIDIA device node nor ``nvidia-smi`` has no card, and
    the tests skip there before torch is loaded into the worker."""
    global torch, sel
    if not glob.glob("/dev/nvidia*") and shutil.which("nvidia-smi") is None:
        pytest.skip("needs a CUDA device (no NVIDIA driver on this machine)")
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    from librabft_simulator_tpu_torch.ops import select_events as sel
    assert sel.NEVER == NEVER


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


def _rows(rng, b, m):
    """Random rows (~30% NEVER, unique stamps), then 8 rows tied on time
    and kind with repeated stamps, then 8 all-NEVER rows."""
    times = rng.integers(0, 100, (b, m)).astype(np.int32)
    times[rng.random((b, m)) < 0.3] = NEVER
    kinds = rng.integers(-1, 4, (b, m)).astype(np.int32)
    stamps = np.argsort(rng.random((b, m)), axis=1).astype(np.int32)
    times[:8], kinds[:8] = 3, 2
    stamps[:16] = rng.integers(0, 5, (16, m))
    times[8:16] = NEVER
    return times, kinds, stamps


@pytest.mark.cuda
@pytest.mark.parametrize("m", [68, 36])
def test_cuda_kernel_matches_plain(cuda_device, m):
    args = [torch.as_tensor(x, device=cuda_device)
            for x in _rows(np.random.default_rng(m), 10000, m)]
    before = sel.select_events.launches
    idx_k, tmin_k = sel.select_events(*args)
    assert sel.select_events.launches == before + 1
    idx_p, tmin_p = sel.select_events_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(idx_k, idx_p) and torch.equal(tmin_k, tmin_p)


@pytest.mark.cuda
def test_cuda_kernel_row_strided_view(cuda_device):
    base = [torch.as_tensor(x, device=cuda_device)
            for x in _rows(np.random.default_rng(5), 10000, 69)]
    args = [x[:, :68] for x in base]  # row stride 69
    idx_k, tmin_k = sel.select_events(*args)
    idx_p, tmin_p = sel.select_events_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(idx_k, idx_p) and torch.equal(tmin_k, tmin_p)


def _queue(rng, b, cm, n):
    """Queue leaves and timers: ~50% valid slots, invalid ones with small
    stale times, kinds and stamps; rows 0-7 tie a valid message with a
    timer, rows 8-15 are all invalid with all-NEVER timers, rows 16-23
    are full."""
    valid = rng.random((b, cm)) < 0.5
    time = rng.integers(5, 100, (b, cm)).astype(np.int32)
    time[~valid] = rng.integers(0, 3, int((~valid).sum()))
    kind = rng.integers(0, 4, (b, cm)).astype(np.int32)
    stamp = rng.integers(0, 4, (b, cm)).astype(np.int32)
    t_time = rng.integers(5, 100, (b, n)).astype(np.int32)
    t_stamp = rng.integers(0, 4, (b, n)).astype(np.int32)
    valid[:8, 3], time[:8, 3], t_time[:8, 1] = True, 4, 4
    stamp[:8, 3], kind[:8, 3] = t_stamp[:8, 1], [3, 2] * 4
    valid[8:16], t_time[8:16] = False, NEVER
    valid[16:24] = True
    return valid, time, kind, stamp, t_time, t_stamp


@pytest.mark.cuda
@pytest.mark.parametrize("b, in_place", [(10000, True), (10000, False), (9997, True)])
def test_cuda_queue_kernel_matches_plain(cuda_device, b, in_place):
    from librabft_simulator_tpu_torch.utils.xops import scatter_set

    rng = np.random.default_rng(b)
    cm, n = 64, 4
    leaves = [torch.as_tensor(x, device=cuda_device) for x in _queue(rng, b, cm, n)]
    if in_place:  # [B, cm] views of [B, cm + 1] buffers, as the engine's step leaves them
        tgt = np.full((b, 2 * n + 1), cm, np.int32)
        tgt[24:, :2] = np.argsort(rng.random((b - 24, cm)), axis=1)[:, :2]
        tgt = torch.as_tensor(tgt, device=cuda_device)
        leaves[:4] = [scatter_set(x, tgt, v) for x, v in zip(leaves[:4], (True, 7, 1, 9))]
        assert leaves[1].stride() == (cm + 1, 1)
    before = sel.select_queue_events.launches
    idx_k, tmin_k = sel.select_queue_events(*leaves, 3)
    assert sel.select_queue_events.launches == before + 1
    idx_p, tmin_p = sel.select_queue_events_plain(*leaves, 3)
    torch.cuda.synchronize()
    assert torch.equal(idx_k, idx_p) and torch.equal(tmin_k, tmin_p)


def _wide_rows_match(device, m, cm, n=20, b=3000):
    """Both entries at row width ``m`` ([B, M] rows) and ``cm`` (the queue,
    stride ``cm + 1`` as scatter_set leaves it) equal their plain versions."""
    from librabft_simulator_tpu_torch.utils.xops import scatter_set

    rng = np.random.default_rng(m)
    args = [torch.as_tensor(x, device=device) for x in _rows(rng, b, m)]
    idx_k, tmin_k = sel.select_events(*args)
    idx_p, tmin_p = sel.select_events_plain(*args)
    leaves = [torch.as_tensor(x, device=device) for x in _queue(rng, b, cm, n)]
    tgt = torch.full((b, 2 * n + 1), cm, dtype=torch.int32, device=device)
    leaves[:4] = [scatter_set(x, tgt, 0) for x in leaves[:4]]
    q_k = sel.select_queue_events(*leaves, 3)
    q_p = sel.select_queue_events_plain(*leaves, 3)
    torch.cuda.synchronize()
    assert torch.equal(idx_k, idx_p) and torch.equal(tmin_k, tmin_p)
    assert all(torch.equal(a, b) for a, b in zip(q_k, q_p))


@pytest.mark.cuda
def test_cuda_kernel_rows_too_wide_to_stage(cuda_device):
    """Rows whose tile does not fit a block's shared memory (32 rows x 640
    columns x 12 B > 227 KB) are read with plain loads; the answer is the
    same."""
    _wide_rows_match(cuda_device, 640, 640)


@pytest.mark.cuda
def test_cuda_kernel_wide_rows_staged_above_48kb(cuda_device):
    """A tile above the default 48 KB of shared memory (the kernel opts in to
    the card's limit) gives the same answer."""
    _wide_rows_match(cuda_device, 400, 320)


def _inbox(rng, rows, ic):
    """Lane inbox rows as a drain iteration gathers them: ~half the slots
    valid, stale kinds and times in the rest, message kinds 0-2; rows 0-7
    tie a message with the timer, rows 8-15 are empty with NEVER timers."""
    valid = rng.random((rows, ic)) < 0.5
    time = rng.integers(0, 50, (rows, ic)).astype(np.int32)
    kind = rng.integers(0, 3, (rows, ic)).astype(np.int32)
    stamp = rng.integers(0, 1 << 20, (rows, ic)).astype(np.int32)
    timer = rng.integers(0, 60, rows).astype(np.int32)
    valid[:8, 5], time[:8, 5], timer[:8] = True, 0, 0
    valid[8:16], timer[8:16] = False, NEVER
    return valid, time, kind, stamp, timer


@pytest.mark.cuda
def test_cuda_lane_select_matches_earliest(cuda_device):
    """The lane engine's select (``earliest``: select_queue_events on
    [B*A, 256] inbox rows with one timer column; a 106 KB staged tile) equals
    ``_earliest``'s plain port."""
    from librabft_simulator_tpu_torch.sim import parallel_sim as P

    args = [torch.as_tensor(x, device=cuda_device)
            for x in _inbox(np.random.default_rng(3), 16000, 256)]
    before = sel.select_queue_events.launches
    got = P.earliest(*args)
    assert sel.select_queue_events.launches == before + 1
    want = P._earliest(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_lane_step_matches_cpu(cuda_device):
    """A few lane windows on the card equal the same windows on the CPU, leaf
    for leaf (n=16, 2-chain, 256-slot inboxes: config #5's shape, 8 instances)."""
    from librabft_simulator_tpu_torch import convert
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S

    p = SimParams(n_nodes=16, commit_chain=2, inbox_cap=256, max_clock=1000)
    states = {}
    for dev in ("cpu", cuda_device):
        st = P.init_batch(p, np.arange(8), device=dev)
        delay_table, dur_table = S.tables(p, st.clock.device)
        before = sel.select_queue_events.launches
        for _ in range(12):
            st = P.step(p, delay_table, dur_table, P.d_min_of(p), st)
        if dev != "cpu":
            assert sel.select_queue_events.launches == before + 12 * P.drain_of(p)
        states[str(dev)] = convert.to_reference(st)
    want = states.pop("cpu")
    got = states.popitem()[1]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(want["n_events"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [False, True])
def test_cuda_sharded_ring_matches_cpu(cuda_device, lanes):
    """The sharded runtime on the card: a 3-shard mesh on one card (B=5
    padded to 6), the device wrap (ring_k 4) and the pipelined host wrap,
    equal the CPU's run_to_completion in every leaf; the select launches are
    the event steps (windows x drain) of every shard; the ring fetches its
    digests, and waits on the card, fewer times than it retires chunks."""
    import dataclasses

    from fleet_shapes import FLEET_B, FLEET_LANE_KW, FLEET_SER_KW
    from librabft_simulator_tpu_torch import convert
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.parallel import mesh as M, sharded as SH
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S
    from librabft_simulator_tpu_torch.telemetry import ledger

    eng, kw, clock = (P, FLEET_LANE_KW, 150) if lanes else (S, FLEET_SER_KW, 120)
    p = SimParams(max_clock=clock, **kw)
    seeds = SH.fleet_seeds(0, FLEET_B)
    want = convert.to_reference(eng.run_to_completion(p, eng.init_batch(p, seeds, device="cpu"),
                                                      chunk=8))
    mesh = M.make_mesh(3, 1, devices=[cuda_device] * 3)
    per_step = P.drain_of(p) if lanes else 1
    for pw in (dataclasses.replace(p, wrap="device", ring_k=4), p):
        before = sel.select_queue_events.launches
        st = SH.run_sharded(pw, mesh, eng.init_batch(pw, seeds, device=cuda_device),
                            num_steps=8 * 100, chunk=8, engine=eng)
        torch.cuda.synchronize()
        assert (sel.select_queue_events.launches - before
                == SH.run_sharded.last_steps * per_step * 3)
        got = convert.to_reference(st)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if pw.wrap == "device":
            ring = ledger.get().ring_stats()
            assert ring["polls_per_retired_chunk"] < 1
            assert ring["waits_per_retired_chunk"] < 1
    assert int(want["n_events"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [False, True])
def test_cuda_serve_matches_cpu(cuda_device, lanes, tmp_path):
    """The resident fleet service on the card: 6 requests (an attacked one,
    both chains, a static schedule) on 4 slots, served by the pipelined
    digest pump for 2 chunks, preempted, resumed under the device-wrap ring
    (ring_k 4) and drained, give the CPU's host-wrap results field for
    field (all but the wall-clock ttfc_s); the select launches are the event
    steps (windows x drain) the two pumps dispatched."""
    import dataclasses

    from fleet_shapes import FLEET_ADV_SERVE_KW
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.serve import FleetService, ScenarioSpec
    from librabft_simulator_tpu_torch.sim import parallel_sim as P

    p = SimParams(**dict(FLEET_ADV_SERVE_KW, max_clock=120))
    eng = P if lanes else None
    specs = [ScenarioSpec(delay_kind="uniform", max_clock=120, seed=11),
             ScenarioSpec(delay_kind="uniform", commit_chain=2, max_clock=90, seed=22,
                          attack={"windows": [{"behavior": "equivocate", "start": 10,
                                               "end": 60, "targets": [3]}]}),
             ScenarioSpec(delay_kind="uniform", max_clock=30, seed=33),
             ScenarioSpec(delay_kind="constant", delay_mean=7.0, max_clock=70,
                          byz_kind="silent", byz_f=1, seed=44),
             ScenarioSpec(delay_kind="uniform", commit_chain=2, max_clock=80, seed=55),
             ScenarioSpec(delay_kind="uniform", max_clock=60, seed=66,
                          attack={"windows": [{"behavior": "forge_qc", "start": 0,
                                               "end": 40, "targets": [0]}]})]
    chunk = 8 if lanes else 32
    with FleetService(p, slots=4, chunk=chunk, engine=eng, device="cpu") as cpu:
        for s in specs:
            cpu.submit(s)
        want = cpu.drain()
    before = sel.select_queue_events.launches
    svc = FleetService(p, slots=4, chunk=chunk, engine=eng, device=cuda_device)
    for s in specs:
        svc.submit(s)
    svc.serve(max_chunks=2)
    steps = svc.fleet.steps_dispatched
    path = str(tmp_path / "svc.npz")
    svc.preempt(path)
    svc.close()
    ring_p = dataclasses.replace(p, wrap="device", ring_k=4)
    with FleetService.resume(path, ring_p, engine=eng, device=cuda_device) as svc:
        got = svc.drain()
        steps += svc.fleet.steps_dispatched
    torch.cuda.synchronize()
    per_step = P.drain_of(p) if lanes else 1
    assert sel.select_queue_events.launches - before == steps * per_step
    assert set(got) == set(want)
    for rid in want:
        assert {k: v for k, v in got[rid].items() if k != "ttfc_s"} == \
            {k: v for k, v in want[rid].items() if k != "ttfc_s"}, rid
    assert max(max(r["commits"]) for r in want.values()) > 0
