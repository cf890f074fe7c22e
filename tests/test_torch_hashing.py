"""Port hashing (librabft_simulator_tpu_torch/utils/hashing.py) == the JAX
package's, bit for bit, on random uint32 vectors (uint32 carried as int32
bit patterns in the port)."""

import jax.numpy as jnp
import numpy as np
import pytest

from librabft_simulator_tpu.utils import hashing as JH
from tests.port_support import import_torch


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, TH
    torch = import_torch()
    from librabft_simulator_tpu_torch.utils import hashing as TH


def _words(rng, n=257):
    w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 1, 2**31, 2**32 - 1]
    return w


def _t(u32):
    return torch.as_tensor(u32.view(np.int32).copy())


def _same(jax_out, port_out):
    want = np.asarray(jax_out).astype(np.uint32)
    got = port_out.numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.mark.parametrize("fn", ["mix32", "fold", "rng_u32", "rng_u32_pair",
                                "state_tag_next", "epoch_initial_tag"])
def test_hash_functions_match_jax(fn):
    rng = np.random.default_rng(sum(map(ord, fn)))
    a, b, c, d = (_words(rng) for _ in range(4))
    if fn == "mix32":
        _same(JH.mix32(jnp.asarray(a), jnp.asarray(b)), TH.mix32(_t(a), _t(b)))
    elif fn == "fold":
        _same(JH.fold(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)),
              TH.fold(_t(a), _t(b), _t(c)))
    elif fn == "rng_u32":
        _same(JH.rng_u32(jnp.asarray(a), jnp.asarray(b)), TH.rng_u32(_t(a), _t(b)))
    elif fn == "rng_u32_pair":
        ja, jb = JH.rng_u32_pair(jnp.asarray(a), jnp.asarray(b))
        ta, tb = TH.rng_u32_pair(_t(a), _t(b))
        _same(ja, ta)
        _same(jb, tb)
    elif fn == "state_tag_next":
        _same(JH.state_tag_next(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                                jnp.asarray(d)),
              TH.state_tag_next(_t(a), _t(b), _t(c), _t(d)))
    else:
        _same(JH.epoch_initial_tag(jnp.asarray(a)), TH.epoch_initial_tag(_t(a)))


def test_host_constants_and_signed_words():
    assert TH.initial_state_tag() == TH.to_i32(int(JH.initial_state_tag()))
    # int32 words (negative values, bools) hash as their uint32 casts.
    x = np.asarray([-1, -7, 5, 2**31 - 1], np.int32)
    _same(JH.fold(jnp.asarray(x).astype(jnp.uint32), jnp.asarray([True, False, True, False])),
          TH.fold(torch.as_tensor(x), torch.as_tensor([True, False, True, False])))
