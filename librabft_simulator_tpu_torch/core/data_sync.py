"""DataSync: catch-up protocol over fixed-shape payloads.  The port of
``librabft_simulator_tpu/core/data_sync.py``.

A response carries a K-round tail of (block, QC) pairs ending at the
responder's highest QC, plus the highest commit certificate with its block,
timeouts and the proposal.  A receiver lagging beyond the window performs a
state-sync jump: it re-anchors a fresh store at the base of the received
chain and adopts the committed state (counted in ``Context.sync_jumps``).
"""

from __future__ import annotations

import torch

from . import store as store_ops
from .types import (
    BlockMsg,
    Context,
    NodeExtra,
    Payload,
    QcMsg,
    SimParams,
    Store,
    VoteMsg,
    tree_map,
)
from ..utils.xops import const, take

I32 = torch.int32


def _slot(p, r):
    return torch.remainder(r, p.window)


def qc_msg_at(p: SimParams, s: Store, r, var, valid):
    sl = _slot(p, r)
    return QcMsg(
        valid=valid,
        epoch=s.epoch_id,
        round=take(s.qc_round, sl, var),
        blk_tag=take(s.blk_tag, sl, take(s.qc_blk_var, sl, var)),
        state_depth=take(s.qc_state_depth, sl, var),
        state_tag=take(s.qc_state_tag, sl, var),
        commit_valid=take(s.qc_commit_valid, sl, var),
        commit_depth=take(s.qc_commit_depth, sl, var),
        commit_tag=take(s.qc_commit_tag, sl, var),
        votes_lo=take(s.qc_votes_lo, sl, var),
        votes_hi=take(s.qc_votes_hi, sl, var),
        author=take(s.qc_author, sl, var),
        tag=take(s.qc_tag, sl, var),
    )


def blk_msg_at(p: SimParams, s: Store, r, var, valid):
    sl = _slot(p, r)
    return BlockMsg(
        valid=valid,
        round=take(s.blk_round, sl, var),
        author=take(s.blk_author, sl, var),
        prev_round=take(s.blk_prev_round, sl, var),
        prev_tag=take(s.blk_prev_tag, sl, var),
        time=take(s.blk_time, sl, var),
        cmd_proposer=take(s.blk_cmd_proposer, sl, var),
        cmd_index=take(s.blk_cmd_index, sl, var),
        tag=take(s.blk_tag, sl, var),
    )


def own_vote_msg(p: SimParams, s: Store, author):
    """current_vote as a wire vote."""
    a = author.clamp(0, p.n_nodes - 1)
    sl = _slot(p, s.current_round)
    return VoteMsg(
        valid=take(s.vt_valid, a), epoch=s.epoch_id, round=s.current_round,
        blk_tag=take(s.blk_tag, sl, take(s.vt_blk_var, a)),
        state_depth=take(s.vt_state_depth, a), state_tag=take(s.vt_state_tag, a),
        commit_valid=take(s.vt_commit_valid, a),
        commit_depth=take(s.vt_commit_depth, a),
        commit_tag=take(s.vt_commit_tag, a), author=a,
    )


def _empty(p: SimParams, s: Store) -> Payload:
    return Payload.empty(p.n_nodes, p.chain_k, s.epoch_id.shape, s.epoch_id.device)


def create_notification(p: SimParams, s: Store, author) -> Payload:
    """data_sync.rs:82-111."""
    pay = _empty(p, s)
    hcc = qc_msg_at(p, s, s.hcc_round, s.hcc_var, s.hcc_valid)
    hqc = qc_msg_at(p, s, s.hqc_round, s.hqc_var, s.hqc_round > 0)
    sl = _slot(p, s.current_round)
    prop_var = s.proposed_var.clamp(min=0)
    # Do not reshare other leaders' proposals.
    prop_valid = (s.proposed_var >= 0) & (take(s.blk_author, sl, prop_var) == author)
    prop = blk_msg_at(p, s, s.current_round, prop_var, prop_valid)
    return pay.replace(
        epoch=s.epoch_id,
        hcc=hcc,
        hqc=hqc,
        prop_blk=prop,
        vote=own_vote_msg(p, s, author),
        tc_to=pay.tc_to.replace(round=s.htc_round, valid=s.tc_valid, hcbr=s.tc_hcbr),
        cur_to=pay.cur_to.replace(round=s.current_round, valid=s.to_valid,
                                  hcbr=s.to_hcbr),
    )


def _insert_timeout_batch(p, s, weights, to_msg, rec_epoch):
    """Insert a TimeoutsMsg author by author."""
    for a in range(p.n_nodes):
        author = const(tuple(to_msg.round.shape), a, I32, to_msg.round.device)
        s, _ = store_ops.insert_timeout(
            p, s, weights, rec_epoch, to_msg.round, to_msg.hcbr[:, a], author,
            when=to_msg.valid[:, a])
    return s


def incoming_qc_tag_ok(p: SimParams, pay: Payload) -> dict:
    """Tag verification of every QC a payload carries, hashed in one pass:
    ``{"hcc": [B], "hqc": [B], "chain_qc": [B, K]}``.  A QC's tag depends on
    its own fields only, so the handlers' inserts can take it precomputed."""
    cat = tree_map(lambda a, b, c: torch.cat([a.unsqueeze(-1), b.unsqueeze(-1), c], dim=1),
                   pay.hcc, pay.hqc, pay.chain_qc)
    ok = cat.tag == store_ops.qc_msg_tag(cat)
    return {"hcc": ok[:, 0], "hqc": ok[:, 1], "chain_qc": ok[:, 2:]}


def _tag_ok(tag_ok, name):
    return None if tag_ok is None else tag_ok[name]


def handle_notification(p: SimParams, s: Store, weights, pay: Payload,
                        tag_ok=None):
    """data_sync.rs:113-177.  Returns (store, should_sync).  ``tag_ok`` is
    ``incoming_qc_tag_ok(p, pay)`` when the caller has it."""
    should_sync = pay.epoch > s.epoch_id
    # Highest commit certificate (an invalid QC never passes insert_qc, so
    # the JAX package's select on ``valid`` is implied).
    s, _ = store_ops.insert_qc(p, s, weights, pay.hcc, _tag_ok(tag_ok, "hcc"))
    should_sync = should_sync | (
        pay.hcc.valid
        & ((pay.hcc.epoch > s.epoch_id)
           | ((pay.hcc.epoch == s.epoch_id) & (pay.hcc.round > s.hcr + 2))))
    # Highest QC.
    s, _ = store_ops.insert_qc(p, s, weights, pay.hqc, _tag_ok(tag_ok, "hqc"))
    should_sync = should_sync | (
        pay.hqc.valid
        & ((pay.hqc.epoch > s.epoch_id)
           | ((pay.hqc.epoch == s.epoch_id) & (pay.hqc.round > s.hqc_round))))
    # Proposed block, timeouts, vote.
    s, _ = store_ops.insert_block(p, s, weights, pay.prop_blk, pay.epoch)
    s = _insert_timeout_batch(p, s, weights, pay.tc_to, pay.epoch)
    s = _insert_timeout_batch(p, s, weights, pay.cur_to, pay.epoch)
    s, _ = store_ops.insert_vote(p, s, weights, pay.vote)
    return s, should_sync


def handle_request(p: SimParams, s: Store, author, req: Payload,
                   notif: Payload | None = None) -> Payload:
    """data_sync.rs:183-207 with the K-tail redesign of unknown_records.
    ``notif`` is create_notification(s, author) when the caller has it."""
    resp = notif if notif is not None else create_notification(p, s, author)
    # Walk back K QCs from our highest QC; emit ascending (blocks + QCs).
    valids, rounds, vars_, _ = store_ops.qc_walk_back(
        p, s, s.hqc_round > 0, s.hqc_round, s.hqc_var, p.chain_k)
    valid = torch.stack(valids[::-1], dim=1)
    rnd = torch.stack(rounds[::-1], dim=1)
    var = torch.stack(vars_[::-1], dim=1)
    b = rnd.shape[0]
    rows = torch.arange(b, device=rnd.device).unsqueeze(-1)
    sl = torch.remainder(rnd, p.window)

    def g(x, v=var):
        return x[rows, sl, v]

    bvar = g(s.qc_blk_var)
    blks = BlockMsg(
        valid=valid, round=g(s.blk_round, bvar), author=g(s.blk_author, bvar),
        prev_round=g(s.blk_prev_round, bvar), prev_tag=g(s.blk_prev_tag, bvar),
        time=g(s.blk_time, bvar), cmd_proposer=g(s.blk_cmd_proposer, bvar),
        cmd_index=g(s.blk_cmd_index, bvar), tag=g(s.blk_tag, bvar))
    qcs = QcMsg(
        valid=valid, epoch=s.epoch_id.unsqueeze(-1).expand(b, p.chain_k),
        round=g(s.qc_round), blk_tag=g(s.blk_tag, bvar),
        state_depth=g(s.qc_state_depth), state_tag=g(s.qc_state_tag),
        commit_valid=g(s.qc_commit_valid), commit_depth=g(s.qc_commit_depth),
        commit_tag=g(s.qc_commit_tag), votes_lo=g(s.qc_votes_lo),
        votes_hi=g(s.qc_votes_hi), author=g(s.qc_author), tag=g(s.qc_tag))
    hcc_bvar = take(s.qc_blk_var, _slot(p, s.hcc_round), s.hcc_var)
    hcc_blk = blk_msg_at(p, s, s.hcc_round, hcc_bvar, s.hcc_valid)
    return resp.replace(
        chain_blk=blks, chain_qc=qcs, hcc_blk=hcc_blk,
        vote=resp.vote.replace(valid=torch.zeros_like(resp.vote.valid)),
    )


def handle_response(p: SimParams, s: Store, nx: NodeExtra, ctx: Context, weights,
                    pay: Payload, tag_ok=None):
    """data_sync.rs:209-241 + state-sync jump.  Returns (store, nx, ctx).
    ``tag_ok`` as in handle_notification."""
    gap_jump = pay.hqc.valid & (
        (pay.epoch > s.epoch_id)
        | (pay.hqc.round > s.hqc_round + (p.window - p.chain_k)))
    do_jump = gap_jump & pay.chain_qc.valid[:, 0]
    s = store_ops._sel(do_jump, _anchored_store(p, s, pay), s)
    nx = nx.replace(
        latest_voted_round=torch.where(do_jump, 0, nx.latest_voted_round),
        locked_round=torch.where(do_jump, 0, nx.locked_round),
    )
    # Adopt the committed state carried by the commit certificate on a jump.
    adopt = do_jump & pay.hcc.valid & pay.hcc.commit_valid \
        & (pay.hcc.commit_depth > ctx.last_depth)
    ctx = ctx.replace(
        last_depth=torch.where(adopt, pay.hcc.commit_depth, ctx.last_depth),
        last_tag=torch.where(adopt, pay.hcc.commit_tag, ctx.last_tag),
        sync_jumps=ctx.sync_jumps + do_jump.to(I32),
        # Adopted depths (last_depth+1 .. commit_depth) never reach the log.
        skipped_commits=ctx.skipped_commits + torch.where(
            adopt, pay.hcc.commit_depth - ctx.last_depth, 0),
    )
    # Replay the chain tail in ascending order: block then QC (the anchor
    # pair is skipped after a jump).
    for i in range(p.chain_k):
        blk = tree_map(lambda x: x[:, i], pay.chain_blk)
        qc = tree_map(lambda x: x[:, i], pay.chain_qc)
        if i == 0:
            blk = blk.replace(valid=blk.valid & ~do_jump)
            qc = qc.replace(valid=qc.valid & ~do_jump)
        s, _ = store_ops.insert_block(p, s, weights, blk, pay.epoch)
        s, _ = store_ops.insert_qc(
            p, s, weights, qc, None if tag_ok is None else tag_ok["chain_qc"][:, i])
    # Highest commit certificate with its block, then the rest.
    s, _ = store_ops.insert_block(p, s, weights, pay.hcc_blk, pay.epoch)
    s, _ = store_ops.insert_qc(p, s, weights, pay.hcc, _tag_ok(tag_ok, "hcc"))
    s = _insert_timeout_batch(p, s, weights, pay.tc_to, pay.epoch)
    s = _insert_timeout_batch(p, s, weights, pay.cur_to, pay.epoch)
    s, _ = store_ops.insert_block(p, s, weights, pay.prop_blk, pay.epoch)
    return s, nx, ctx


def _anchored_store(p: SimParams, s: Store, pay: Payload) -> Store:
    """Fresh store re-anchored at the base QC of the received chain: the
    base QC becomes the 'initial' QC of the store (state-sync jump)."""
    base = tree_map(lambda x: x[:, 0], pay.chain_qc)
    fresh = Store.initial(p, s.epoch_id.shape, s.epoch_id.device)
    return fresh.replace(
        epoch_id=pay.epoch,
        initial_round=base.round,
        initial_tag=base.tag,
        initial_state_depth=base.state_depth,
        initial_state_tag=base.state_tag,
        current_round=base.round + 1,
        hqc_round=base.round,   # 'no QC beyond the anchor yet'
        htc_round=base.round,
        hcr=base.round,
        anchored=torch.ones_like(s.anchored),
    )
