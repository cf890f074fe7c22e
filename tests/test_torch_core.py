"""Port protocol helpers against the JAX package, eager, one function at a
time: core/config.py (quorum, author picking, leaders) and
core/pacemaker.py (round durations, update_pacemaker with the 16.16
query-all period, including lam = 1.0 where the low-part product needs the
full 32 bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from librabft_simulator_tpu.core import config as JC
from librabft_simulator_tpu.core import pacemaker as JPM
from librabft_simulator_tpu.core import types as JT
from tests.port_support import import_torch


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, TC, TPM, TT
    torch = import_torch()
    from librabft_simulator_tpu_torch.core import config as TC
    from librabft_simulator_tpu_torch.core import pacemaker as TPM
    from librabft_simulator_tpu_torch.core import types as TT


B, N = 16, 4


def _weights(rng):
    w = rng.integers(1, 5, (B, N)).astype(np.int32)
    w[0] = 1
    return w


def test_quorum_and_votes_match_jax():
    rng = np.random.default_rng(0)
    w = _weights(rng)
    mask = rng.random((B, N)) < 0.5
    tw, tm = torch.as_tensor(w), torch.as_tensor(mask)
    for jf, tf in ((JC.quorum_threshold, TC.quorum_threshold),
                   (JC.validity_threshold, TC.validity_threshold)):
        want = np.asarray(jax.vmap(jf)(jnp.asarray(w)))
        got = tf(tw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(JC.count_votes(jnp.asarray(w), jnp.asarray(mask)))
    np.testing.assert_array_equal(TC.count_votes(tw, tm).numpy(), want)


def test_pick_author_and_leader_match_jax():
    rng = np.random.default_rng(1)
    w = _weights(rng)
    u = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    rounds = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    want = np.asarray(jax.vmap(JC.pick_author)(jnp.asarray(w), jnp.asarray(u)))
    got = TC.pick_author(torch.as_tensor(w), torch.as_tensor(u.view(np.int32).copy()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax.vmap(JC.leader_of_round)(jnp.asarray(w), jnp.asarray(rounds)))
    np.testing.assert_array_equal(
        TC.leader_of_round(torch.as_tensor(w), torch.as_tensor(rounds)).numpy(), want)


def _node_state(rng, p):
    """Random per-node pacemaker inputs that reach every branch."""
    s = TT.Store.initial(p, (B,), "cpu")
    hqc = rng.integers(0, 40, B).astype(np.int32)
    htc = rng.integers(0, 40, B).astype(np.int32)
    to_valid = np.zeros((B, N), bool)
    to_valid[:, 1] = rng.random(B) < 0.6
    s = s.replace(
        hqc_round=torch.as_tensor(hqc), htc_round=torch.as_tensor(htc),
        hcr=torch.as_tensor(rng.integers(0, 30, B).astype(np.int32)),
        current_round=torch.as_tensor(np.maximum(hqc, htc) + 1),
        to_valid=torch.as_tensor(to_valid),
        proposed_var=torch.as_tensor(rng.integers(-1, 2, B).astype(np.int32)))
    big = rng.integers(0, 2**30, B).astype(np.int32)
    pm = TT.Pacemaker(
        active_epoch=torch.zeros(B, dtype=torch.int32),
        active_round=torch.as_tensor((np.maximum(hqc, htc) + rng.integers(0, 2, B)).astype(np.int32)),
        active_leader=torch.as_tensor(rng.integers(-1, N, B).astype(np.int32)),
        round_start=torch.as_tensor(rng.integers(-50, 2**30, B).astype(np.int32)),
        round_duration=torch.as_tensor(big))
    lqa = torch.as_tensor(rng.integers(-50, 2**30, B).astype(np.int32))
    clock = torch.as_tensor(rng.integers(-20, 2**31 - 1, B).astype(np.int32))
    return s, pm, lqa, clock


def _to_jax(tree, cls):
    kw = {}
    for name in TT.tree_fields(tree):
        a = getattr(tree, name).numpy()
        kw[name] = jnp.asarray(a.view(np.uint32) if name in tree.U32 else a)
    return cls(**kw)


@pytest.mark.parametrize("lam", [0.5, 1.0])
def test_update_pacemaker_matches_jax(lam):
    kw = dict(n_nodes=N, lam=lam, gamma=4.0)
    jp, tp = JT.SimParams(**kw), TT.SimParams(**kw)
    rng = np.random.default_rng(int(lam * 10))
    s, pm, lqa, clock = _node_state(rng, tp)
    w = torch.ones((B, N), dtype=torch.int32)
    author = torch.full((B,), 1, dtype=torch.int32)
    dur = torch.as_tensor(tp.duration_table())
    pm2, act = TPM.update_pacemaker(tp, pm, s, w, author, s.epoch_id, lqa, clock, dur)

    def jax_one(s_, pm_, lqa_, clock_):
        return JPM.update_pacemaker(jp, pm_, s_, jnp.ones((N,), jnp.int32), 1,
                                    s_.epoch_id, lqa_, clock_,
                                    jnp.asarray(jp.duration_table()))

    jpm2, jact = jax.vmap(jax_one)(_to_jax(s, JT.Store), _to_jax(pm, JT.Pacemaker),
                                   jnp.asarray(lqa.numpy()), jnp.asarray(clock.numpy()))
    for name in TT.tree_fields(pm2):
        np.testing.assert_array_equal(getattr(pm2, name).numpy(),
                                      np.asarray(getattr(jpm2, name)), err_msg=name)
    for name in ("should_propose", "propose_prev_round", "should_create_timeout",
                 "timeout_round", "send_leader", "should_broadcast",
                 "should_query_all", "next_sched"):
        got, want = getattr(act, name).numpy(), np.asarray(getattr(jact, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(act.propose_prev_tag.numpy().view(np.uint32),
                                  np.asarray(jact.propose_prev_tag))
    assert bool(act.should_query_all.any())  # the period branch is reached
    # The 16.16 period itself, wide durations included.
    d = torch.as_tensor(rng.integers(0, 2**31 - 1, B).astype(np.int32))
    hi, lo = d.numpy() >> 16, d.numpy() & 0xFFFF
    want = hi * tp.lam_fp + ((lo.astype(np.uint64) * tp.lam_fp) % 2**32 >> 16)
    np.testing.assert_array_equal(TPM.query_all_period(tp, d).numpy(),
                                  want.astype(np.int64).astype(np.int32))
