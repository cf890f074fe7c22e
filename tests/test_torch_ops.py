"""The port's event select (librabft_simulator_tpu_torch/ops/select_events.py):
its plain version equals the JAX package's Pallas kernel in interpret mode
and its plain reference.  The CUDA kernel against the plain version is
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
