"""The port's event select (librabft_simulator_tpu_torch/ops/select_events.py):
the plain versions of both entries equal the JAX package's Pallas kernel in
interpret mode and its plain reference, and the wrappers reject what the
kernel does not take.  The CUDA kernel against the plain versions is
tests/test_torch_cuda.py (it needs a card)."""

import jax.numpy as jnp
import numpy as np
import pytest

from librabft_simulator_tpu.ops.pallas_queue import (
    NEVER, select_events as jax_select, select_events_reference,
)
from tests.test_ops import random_batch
from tests.port_support import import_torch


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, sel
    torch = import_torch()
    from librabft_simulator_tpu_torch.ops import select_events as sel
    assert sel.NEVER == NEVER


def _port(t, k, s, device="cpu"):
    args = [torch.as_tensor(np.array(x), device=device) for x in (t, k, s)]
    idx, tmin = sel.select_events(*args)
    assert idx.dtype == torch.int32 and tmin.dtype == torch.int32
    return idx.cpu().numpy(), tmin.cpu().numpy()


@pytest.mark.parametrize("shape", [(4, 35), (8, 128), (3, 200)])
def test_plain_matches_pallas_interpret(shape):
    rng = np.random.default_rng(0)
    t, k, s = random_batch(rng, *shape)
    idx_j, tmin_j = jax_select(t, k, s, interpret=True)
    idx_t, tmin_t = _port(t, k, s)
    np.testing.assert_array_equal(idx_t, np.asarray(idx_j))
    np.testing.assert_array_equal(tmin_t, np.asarray(tmin_j))


def _edge_rows(rng, b=16, m=36):
    times = rng.integers(0, 9, (b, m)).astype(np.int32)
    kinds = rng.integers(-1, 4, (b, m)).astype(np.int32)
    stamps = rng.integers(0, 5, (b, m)).astype(np.int32)  # repeated stamps
    times[: b // 2] = 3                                   # full-row time ties
    kinds[: b // 4] = 2                                   # ... and kind ties
    times[b // 2:] = NEVER                                # all-NEVER rows
    return times, kinds, stamps


@pytest.mark.parametrize("case", ["ties", "all_never"])
def test_plain_matches_reference_on_ties_and_never(case):
    rng = np.random.default_rng(1 if case == "ties" else 2)
    t, k, s = _edge_rows(rng)
    rows = slice(0, 8) if case == "ties" else slice(8, 16)
    t, k, s = t[rows], k[rows], s[rows]
    idx_r, tmin_r = select_events_reference(jnp.asarray(t), jnp.asarray(k),
                                            jnp.asarray(s))
    idx_t, tmin_t = _port(t, k, s)
    np.testing.assert_array_equal(idx_t, np.asarray(idx_r))
    np.testing.assert_array_equal(tmin_t, np.asarray(tmin_r))


def test_wrapper_checks_operands():
    x = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        sel.select_events(x.long(), x, x)
    with pytest.raises(ValueError):
        sel.select_events(x, x, x[:, :2])
    with pytest.raises(ValueError):
        sel.select_events(x.t(), x.t(), x.t())
    launches = sel.select_events.launches
    sel.select_events(x, x, x)
    assert sel.select_events.launches == launches  # the plain version is no launch


# select_queue_events: the engine's queue and timers read in place.  Its
# plain version is held against select_events_reference on the [B, cm + n]
# rows built in numpy from the same leaves.  B = 8, cm = 32, n = 4 keeps the
# reference at the [8, 36] shape the cases above already run.

KIND_TIMER = 3
QB, QCM, QN = 8, 32, 4


def _queue_state(case):
    """Hand-made queue leaves (valid, time, kind, stamp) and timers (time,
    stamp) for one case; invalid slots keep stale kinds and stamps."""
    rng = np.random.default_rng({"stale_early": 3, "timer_ties": 4,
                                 "all_invalid": 5, "in_place": 6}[case])
    valid = rng.random((QB, QCM)) < 0.5
    time = rng.integers(10, 50, (QB, QCM)).astype(np.int32)
    kind = rng.integers(0, 4, (QB, QCM)).astype(np.int32)
    stamp = rng.integers(0, 6, (QB, QCM)).astype(np.int32)
    t_time = rng.integers(10, 50, (QB, QN)).astype(np.int32)
    t_stamp = rng.integers(0, 6, (QB, QN)).astype(np.int32)
    if case == "stale_early":
        # Invalid slots hold times below every valid one; they must not win.
        time[~valid] = rng.integers(0, 3, int((~valid).sum()))
    elif case == "timer_ties":
        # A valid message equal to a timer in time and stamp; its kind is
        # the timer's on even rows (the column decides) and lower on odd rows.
        col, tcol = rng.integers(0, QCM, QB), rng.integers(0, QN, QB)
        rows = np.arange(QB)
        valid[rows, col] = True
        time[rows, col] = t_time[rows, tcol] = 5
        stamp[rows, col] = t_stamp[rows, tcol]
        kind[rows, col] = np.where(rows % 2 == 0, KIND_TIMER, KIND_TIMER - 1)
    elif case == "all_invalid":
        # No valid slot and every timer NEVER: kind, stamp and column decide
        # over the stale values and the timers.
        valid[:] = False
        t_time[:] = NEVER
        stamp[:], t_stamp[:] = rng.integers(0, 2, (QB, QCM)), rng.integers(0, 2, (QB, QN))
    return valid, time, kind, stamp, t_time, t_stamp


def _queue_reference(valid, time, kind, stamp, t_time, t_stamp):
    all_time = np.concatenate([np.where(valid, time, NEVER), t_time], axis=1)
    all_kind = np.concatenate([kind, np.full_like(t_time, KIND_TIMER)], axis=1)
    all_stamp = np.concatenate([stamp, t_stamp], axis=1)
    idx, tmin = select_events_reference(*(jnp.asarray(x.astype(np.int32)) for x in
                                          (all_time, all_kind, all_stamp)))
    return np.asarray(idx), np.asarray(tmin)


def _in_place(leaves):
    """The queue leaves as the engine holds them after a step: [B, cm] views
    of [B, cm + 1] buffers from scatter_set (here every target is the drop
    sentinel, so the values stay as they were)."""
    from librabft_simulator_tpu_torch.utils.xops import scatter_set
    tgt = torch.full((QB, 2 * QN + 1), QCM, dtype=torch.int32)
    out = [scatter_set(x, tgt, 0) for x in leaves[:4]]
    assert all(x.stride() == (QCM + 1, 1) for x in out)
    return out + list(leaves[4:])


@pytest.mark.parametrize("case", ["stale_early", "timer_ties", "all_invalid", "in_place"])
def test_queue_plain_matches_reference(case):
    arrays = _queue_state(case)
    leaves = [torch.as_tensor(x) for x in arrays]
    if case == "in_place":
        leaves = _in_place(leaves)
    launches = sel.select_queue_events.launches
    idx_t, tmin_t = sel.select_queue_events(*leaves, KIND_TIMER)
    assert sel.select_queue_events.launches == launches  # the plain version is no launch
    assert idx_t.dtype == torch.int32 and tmin_t.dtype == torch.int32
    idx_r, tmin_r = _queue_reference(*arrays)
    np.testing.assert_array_equal(idx_t.numpy(), idx_r)
    np.testing.assert_array_equal(tmin_t.numpy(), tmin_r)
    if case == "stale_early":
        assert (tmin_r >= 10).all()  # no stale early time won
    if case == "timer_ties":
        assert ((idx_r < QCM) == (np.arange(QB) % 2 == 0)).all()
    if case == "all_invalid":
        assert (tmin_r == NEVER).all()


@pytest.mark.parametrize("fault", ["dtype", "batch", "column_stride", "alignment"])
def test_queue_wrapper_checks_operands(fault):
    leaves = [torch.as_tensor(x) for x in _queue_state("stale_early")]
    if fault == "dtype":
        leaves[2], err = leaves[2].long(), TypeError
    elif fault == "batch":
        leaves[4], err = leaves[4][:-1], ValueError
    elif fault == "column_stride":
        wide = torch.zeros((QB, 2 * QCM), dtype=torch.int32)
        leaves[3], err = wide[:, ::2], ValueError
    else:
        buf = torch.zeros(QB * QCM + 1, dtype=torch.int32)
        leaves[1], err = buf[1:].view(QB, QCM), ValueError  # 4 bytes past a boundary
    launches = sel.select_queue_events.launches
    with pytest.raises(err):
        sel.select_queue_events(*leaves, KIND_TIMER)
    assert sel.select_queue_events.launches == launches
