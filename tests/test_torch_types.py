"""Port state containers (librabft_simulator_tpu_torch/core/types.py and
convert.py) against the JAX package: SimParams fields and tables, the packed
payload layout, init_batch leaf for leaf, and the state converter."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from librabft_simulator_tpu.core import types as JT
from librabft_simulator_tpu.sim import simulator as JS
from librabft_simulator_tpu.utils import quantile as JQ
from tests.port_support import import_torch


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, convert, TT, TS, TQ
    torch = import_torch()
    from librabft_simulator_tpu_torch import convert
    from librabft_simulator_tpu_torch.core import types as TT
    from librabft_simulator_tpu_torch.sim import simulator as TS
    from librabft_simulator_tpu_torch.utils import quantile as TQ


CONFIG2 = dict(n_nodes=4, delay_kind="uniform", queue_cap=64)


def jax_leaves(tree, batched=True):
    """``{path: np.ndarray}`` of a JAX pytree (unbatched gains [1] in front)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        a = np.asarray(leaf)
        out[jax.tree_util.keystr(path).lstrip(".")] = a if batched else a[None]
    return out


def assert_leaves_equal(want: dict, got: dict):
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        assert want[k].shape == got[k].shape, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_simparams_fields_defaults_and_properties():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(TT.SimParams) == fields(JT.SimParams)
    for kw in ({}, CONFIG2, dict(lam=1.0, drop_prob=0.3, scenario=True, commit_chain=2)):
        jp, tp = JT.SimParams(**kw), TT.SimParams(**kw)
        assert (tp.lam_fp, tp.drop_u32) == (jp.lam_fp, jp.drop_u32)
        assert dataclasses.asdict(tp.structural()) == dataclasses.asdict(jp.structural())
    with pytest.raises(ValueError):
        TT.SimParams(epoch_handoff=True, handoff_epochs=0)


@pytest.mark.parametrize("kind", ["lognormal", "uniform", "pareto", "constant"])
def test_delay_and_duration_tables(kind):
    kw = dict(delay_kind=kind, delay_mean=12.0, delay_variance=9.0, gamma=2.5)
    jp, tp = JT.SimParams(**kw), TT.SimParams(**kw)
    for a, b in ((jp.delay_table(), tp.delay_table()),
                 (jp.duration_table(), tp.duration_table())):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert TQ.TABLE_BITS == JQ.TABLE_BITS


def test_pack_unpack_payload_matches_jax():
    jp, tp = JT.SimParams(**CONFIG2), TT.SimParams(**CONFIG2)
    f = JT.payload_width(jp)
    assert TT.payload_width(tp) == f == 163
    rng = np.random.default_rng(5)
    rows = rng.integers(-2**31, 2**31, (3, f)).astype(np.int32)
    jpay = [JT.unpack_payload(jp, jnp.asarray(r)) for r in rows]
    tpay = TT.unpack_payload(tp, torch.as_tensor(rows))
    want = {k: np.stack([jax_leaves(p, batched=True)[k] for p in jpay])
            for k in jax_leaves(jpay[0])}
    got = {path: leaf.numpy().view(np.uint32) if u32 else leaf.numpy()
           for path, leaf, u32 in TT.leaves_with_path(tpay)}
    assert_leaves_equal(want, got)
    packed = np.stack([np.asarray(JT.pack_payload(p)) for p in jpay])
    np.testing.assert_array_equal(TT.pack_payload(tpay).numpy(), packed)


def test_init_batch_matches_jax_at_config2():
    seeds = np.asarray([0, 7, 2**32 - 1], np.uint32)
    want = jax_leaves(JS.init_batch(JT.SimParams(**CONFIG2), seeds))
    st = TS.init_batch(TT.SimParams(**CONFIG2), seeds, device="cpu")
    got = convert.to_reference(st)
    assert_leaves_equal(want, got)
    assert len(got) == 114
    for path, leaf, u32 in TT.leaves_with_path(st):
        assert leaf.dtype in (torch.int32, torch.bool), path
        if u32:
            assert leaf.dtype == torch.int32, path


def test_convert_round_trip():
    seeds = np.asarray([3, 4], np.uint32)
    jst = JS.init_batch(JT.SimParams(**CONFIG2), seeds)
    leaves = jax_leaves(jst)
    st = convert.from_reference(leaves, device="cpu")
    assert_leaves_equal(leaves, convert.to_reference(st))
    # uint32 leaves given as int32 bit patterns are read the same way.
    as_i32 = {k: v.view(np.int32) if v.dtype == np.uint32 else v
              for k, v in leaves.items()}
    assert_leaves_equal(leaves, convert.to_reference(
        convert.from_reference(as_i32, device="cpu")))
