"""Tensorized record store: verification, insertion, vote aggregation, QC
chaining and the commit rule.  The port of
``librabft_simulator_tpu/core/store.py``.

The JAX code is written for one node with scalar predicates and vmapped;
here every predicate is a per-instance ``[B]`` tensor and every table keeps
``[B]`` in front (``[B, W, V]`` record tables, ``[B, N]`` per-author rows,
``[B, V, 2]`` ballot).  ``xops.bc`` reshapes a predicate to broadcast over a
leaf's trailing dims.

Conditional writes fold the verification outcome into the write mask
(``onehot(..., when=ok)``) instead of building the updated store and
selecting per field afterwards: for every instance the result is the JAX
``_sel(ok, updated, old)``, with one mask per record instead of a select per
leaf.  ``_sel`` itself skips leaves the update left untouched.  An insert
whose record is invalid for every instance returns the store as it is
when ``xops.needed`` allows (on the CPU; the card always queues the work).
"""

from __future__ import annotations

import torch

from . import config
from .types import (
    ELECTION_CLOSED,
    ELECTION_ONGOING,
    ELECTION_WON,
    BlockMsg,
    QcMsg,
    SimParams,
    Store,
    Tree,
    VoteMsg,
    tree_fields,
)
from ..utils import hashing as H
from ..utils.xops import arange, bc, needed, onehot, put, take, where

I32 = torch.int32
I64 = torch.int64


def _sel(ok, new, old):
    """Per-field select of a whole container on a per-instance predicate.
    Leaves that ``new`` shares with ``old`` are kept as they are."""
    kw = {}
    for name in tree_fields(new):
        a, b = getattr(new, name), getattr(old, name)
        if a is b:
            continue
        if isinstance(a, Tree):
            kw[name] = _sel(ok, a, b)
        else:
            kw[name] = torch.where(bc(ok, b), a, b)
    return old.replace(**kw) if kw else old


def _slot(p: SimParams, r):
    return torch.remainder(r, p.window)


def _first_true(match):
    """Index of the first set entry along the last dim (argmax tie order),
    or -1."""
    out = None
    for v in reversed(range(match.shape[-1])):
        out = torch.where(match[..., v], v, -1 if out is None else out)
    return out.to(I32)


def block_parents(p: SimParams, s: Store):
    """``(found, prev_var)`` tables ``[B, W, V]``: prev_qc_of_block for every
    block slot at once, cached on the store until a replace touches the
    block links, the QC table or the initial QC."""
    cached = s.__dict__.get("_parents")
    if cached is not None:
        return cached
    b, w, v = s.blk_prev_round.shape
    pr = s.blk_prev_round.reshape(b, w * v, 1)
    pt = s.blk_prev_tag.reshape(b, w * v, 1)
    is_initial = ((pr == s.initial_round.reshape(b, 1, 1))
                  & (pt == s.initial_tag.reshape(b, 1, 1))).squeeze(-1)
    rows = torch.remainder(pr, p.window).to(I64).expand(b, w * v, v)
    match = (torch.gather(s.qc_valid, 1, rows)
             & (torch.gather(s.qc_round, 1, rows) == pr)
             & (torch.gather(s.qc_tag, 1, rows) == pt))
    var = _first_true(match)
    found = is_initial | (var >= 0)
    prev_var = torch.where(is_initial, -1, var)
    out = (found.reshape(b, w, v), prev_var.reshape(b, w, v))
    s.__dict__["_parents"] = out
    return out


def current_leader(s: Store, weights):
    """leader_of_round(weights, s.current_round), cached on the store until
    its round changes."""
    cached = s.__dict__.get("_leader")
    if cached is not None and cached[0] is weights:
        return cached[1]
    leader = config.leader_of_round(weights, s.current_round)
    s.__dict__["_leader"] = (weights, leader)
    return leader


# ---------------------------------------------------------------------------
# Lookups
# ---------------------------------------------------------------------------


def blk_find(p: SimParams, s: Store, r, tag):
    """Variant index of the block with content ``tag`` at round ``r``; -1 if
    absent."""
    sl = _slot(p, r)
    match = (take(s.blk_valid, sl) & (take(s.blk_round, sl) == r.unsqueeze(-1))
             & (take(s.blk_tag, sl) == tag.unsqueeze(-1)))
    return _first_true(match)


def qc_find(p: SimParams, s: Store, r, tag):
    sl = _slot(p, r)
    match = (take(s.qc_valid, sl) & (take(s.qc_round, sl) == r.unsqueeze(-1))
             & (take(s.qc_tag, sl) == tag.unsqueeze(-1)))
    return _first_true(match)


def hqc_ref(p: SimParams, s: Store):
    """(round, tag) of the highest QC, or the initial QC."""
    has_qc = s.hqc_round > s.initial_round
    tag = torch.where(has_qc, take(s.qc_tag, _slot(p, s.hqc_round), s.hqc_var),
                      s.initial_tag)
    return s.hqc_round, tag


def _qc_state(p: SimParams, s: Store, r, var):
    sl = _slot(p, r)
    return take(s.qc_state_depth, sl, var), take(s.qc_state_tag, sl, var)


def _blk_prev(p: SimParams, s: Store, r, var):
    sl = _slot(p, r)
    return take(s.blk_prev_round, sl, var), take(s.blk_prev_tag, sl, var)


def _qc_blk_var(p: SimParams, s: Store, r, var):
    return take(s.qc_blk_var, _slot(p, r), var)


def prev_qc_of_block(p: SimParams, s: Store, blk_round, blk_var):
    """(found, prev_round, prev_var): the QC a block chains to; prev_var==-1
    means the epoch-initial (or jump-anchor) QC.  Read from the store's
    block_parents tables."""
    found, prev_var = block_parents(p, s)
    sl = _slot(p, blk_round)
    return (take(found, sl, blk_var), take(s.blk_prev_round, sl, blk_var),
            take(prev_var, sl, blk_var))


def qc_walk_back(p: SimParams, s: Store, start_valid, start_round, start_var, steps):
    """BackwardQuorumCertificateIterator: from the QC at (start_round,
    start_var), follow block->previous-QC links for ``steps`` hops.  Returns
    per-hop lists (valid, round, var, hit_initial), newest first."""
    alive = start_round > s.initial_round
    if start_valid is not True:
        alive = start_valid & alive
    r, v = start_round, start_var
    valids, rounds, vars_, hits = [], [], [], []
    for _ in range(steps):
        bvar = _qc_blk_var(p, s, r, v)
        found, pr, pv = prev_qc_of_block(p, s, r, bvar)
        ok = alive & found
        hits.append(ok & (pv < 0))
        valids.append(alive)
        rounds.append(r)
        vars_.append(v)
        alive = ok & (pv >= 0)
        r = torch.where(alive, pr, r)
        v = torch.where(alive, pv, v)
    return valids, rounds, vars_, hits


# ---------------------------------------------------------------------------
# Derived protocol values
# ---------------------------------------------------------------------------


def previous_round(p: SimParams, s: Store, blk_round, blk_var):
    """Round of the QC a block extends."""
    pr, _ = _blk_prev(p, s, blk_round, blk_var)
    return pr


def second_previous_round(p: SimParams, s: Store, blk_round, blk_var):
    found, pr, pv = prev_qc_of_block(p, s, blk_round, blk_var)
    at_initial = pv < 0
    bvar = _qc_blk_var(p, s, pr, pv.clamp(min=0))
    pr2, _ = _blk_prev(p, s, pr, bvar)
    return torch.where(at_initial | ~found, s.initial_round, pr2)


def _check_commit_chain(p: SimParams):
    if not isinstance(p.commit_chain, int):
        raise NotImplementedError(
            "a traced per-slot commit_chain belongs to the scenario-plane slice")


def vote_committed_state(p: SimParams, s: Store, blk_round, blk_var, prev=None):
    """(valid, depth, tag, undeterminable) of the state the commit rule would
    finalize if a QC formed on this block, for ``commit_chain`` C: the C-1
    QCs below the block must have contiguous rounds; the oldest one's state
    is committed.  ``undeterminable``: the walk touched a state-sync anchor.
    ``prev`` is ``prev_qc_of_block(p, s, blk_round, blk_var)`` when the
    caller has it."""
    _check_commit_chain(p)
    C = p.commit_chain
    found0, pr, pv = prev or prev_qc_of_block(p, s, blk_round, blk_var)
    valids, rounds, vars_, hits = qc_walk_back(
        p, s, found0 & (pv >= 0), pr, pv.clamp(min=0), C - 1)
    ok = None
    prev_r = blk_round
    for i in range(C - 1):
        step_ok = valids[i] & (prev_r == rounds[i] + 1)
        ok = step_ok if ok is None else ok & step_ok
        prev_r = rounds[i]
    if ok is None:
        ok = torch.ones_like(found0)
    touched = found0 & (pv < 0)
    for h in hits[: C - 1]:
        touched = touched | h
    undet = s.anchored & touched
    d, t = _qc_state(p, s, rounds[C - 2], vars_[C - 2])
    return ok, torch.where(ok, d, 0), torch.where(ok, t, 0), undet


def compute_state(p: SimParams, s: Store, blk_round, blk_var, prev=None):
    """Execute the block's command on its parent state: rolling hash,
    depth + 1.  ``prev`` as in vote_committed_state."""
    found, pr, pv = prev or prev_qc_of_block(p, s, blk_round, blk_var)
    at_initial = pv < 0
    pd, pt = _qc_state(p, s, pr, pv.clamp(min=0))
    base_d = torch.where(at_initial, s.initial_state_depth, pd)
    base_t = torch.where(at_initial, s.initial_state_tag, pt)
    sl = _slot(p, blk_round)
    tag = H.state_tag_next(
        base_t,
        take(s.blk_cmd_proposer, sl, blk_var),
        take(s.blk_cmd_index, sl, blk_var),
        take(s.blk_time, sl, blk_var),
    )
    return found, base_d + 1, tag


def update_commit_chain(p: SimParams, s: Store, qc_round, qc_var, when=None) -> Store:
    """The C-chain commit rule applied after inserting the QC at (qc_round,
    qc_var); ``when`` gates the update per instance."""
    _check_commit_chain(p)
    C = p.commit_chain
    valids, rounds, _, _ = qc_walk_back(p, s, True, qc_round, qc_var, C)
    ok = valids[0]
    for i in range(1, C):
        ok = ok & valids[i] & (rounds[i - 1] == rounds[i] + 1)
    r1 = rounds[C - 1]
    ok = ok & (r1 > s.hcr)
    if when is not None:
        ok = ok & when
    return s.replace(
        hcr=torch.where(ok, r1, s.hcr),
        hcc_valid=ok | s.hcc_valid,
        hcc_round=torch.where(ok, qc_round, s.hcc_round),
        hcc_var=torch.where(ok, qc_var, s.hcc_var),
    )


def update_current_round(s: Store, r, when=None) -> Store:
    """Advance the round and clear per-round aggregation state; ``when``
    gates it per instance."""
    adv = r > s.current_round
    if when is not None:
        adv = adv & when
    keep = ~adv

    def clear(x):
        kb = bc(keep, x)
        return x & kb if x.dtype == torch.bool else torch.where(kb, x, 0)

    return s.replace(
        current_round=torch.where(adv, r, s.current_round),
        proposed_var=torch.where(adv, -1, s.proposed_var),
        vt_valid=clear(s.vt_valid),
        to_valid=clear(s.to_valid),
        to_weight=clear(s.to_weight),
        bal_used=clear(s.bal_used),
        bal_weight=clear(s.bal_weight),
        bal_state_depth=clear(s.bal_state_depth),
        bal_state_tag=clear(s.bal_state_tag),
        election=torch.where(adv, ELECTION_ONGOING, s.election),
        won_var=clear(s.won_var),
        won_slot=clear(s.won_slot),
    )


# ---------------------------------------------------------------------------
# Record tags (content hashes)
# ---------------------------------------------------------------------------


def block_tag(epoch, round_, author, prev_round, prev_tag, time, cmd_proposer, cmd_index):
    return H.fold(H.TAG_BLOCK, epoch, round_, author, prev_round, prev_tag,
                  time, cmd_proposer, cmd_index)


def qc_tag(epoch, round_, blk_tag_, state_depth, state_tag, commit_valid,
           commit_depth, commit_tag, votes_lo, votes_hi, author):
    return H.fold(H.TAG_QC, epoch, round_, blk_tag_, state_depth, state_tag,
                  commit_valid, commit_depth, commit_tag, votes_lo, votes_hi, author)


def qc_msg_tag(q: QcMsg):
    """The content tag a QC message's fields hash to (any trailing dims)."""
    return qc_tag(q.epoch, q.round, q.blk_tag, q.state_depth, q.state_tag,
                  q.commit_valid, q.commit_depth, q.commit_tag,
                  q.votes_lo, q.votes_hi, q.author)


def author_mask_words(mask):
    """Pack a ``[B, N<=64]`` author bool mask into two uint32 words (int32
    bit patterns): the votes digest.  Distinct bits, so the sum is the OR."""
    n = mask.shape[-1]
    idx = arange(n, mask.device)
    m = mask.to(I64)
    lo = (m * torch.where(idx < 32, 1 << idx.clamp(max=31), 0)).sum(-1)
    hi = (m * torch.where(idx >= 32, 1 << (idx - 32).clamp(min=0), 0)).sum(-1)
    return H.to_i32(lo), H.to_i32(hi)


def mask_weight(p: SimParams, weights, lo, hi):
    """Total voting weight of the authors set in the (lo, hi) bit mask, plus
    a validity flag rejecting bits outside 0..n-1."""
    n = p.n_nodes
    idx = arange(n, weights.device)
    lo_u, hi_u = H.as_u32(lo), H.as_u32(hi)
    word = torch.where(idx < 32, lo_u.unsqueeze(-1), hi_u.unsqueeze(-1))
    bit = (word >> torch.where(idx < 32, idx, idx - 32)) & 1
    w = torch.where(bit == 1, weights, 0).sum(-1, dtype=I32)
    if n >= 64:
        known = torch.ones_like(lo, dtype=torch.bool)
    elif n >= 32:
        known = (hi_u >> (n - 32)) == 0
    else:
        known = ((lo_u >> n) == 0) & (hi == 0)
    return w, known


# ---------------------------------------------------------------------------
# Insertions (verify_network_record + try_insert_network_record)
# ---------------------------------------------------------------------------


def _pick_variant(valid_col, round_col, tag_col, r, tag):
    """Choose a table variant for a new record at round ``r``: reuse
    stale/empty slots, detect duplicates, cap at V live variants.
    Columns are ``[B, V]``.  Returns (var, is_dup, has_room)."""
    stale0 = ~valid_col[:, 0] | (round_col[:, 0] != r)
    stale1 = ~valid_col[:, 1] | (round_col[:, 1] != r)
    dup0 = ~stale0 & (tag_col[:, 0] == tag)
    dup1 = ~stale1 & (tag_col[:, 1] == tag)
    is_dup = dup0 | dup1
    var = torch.where(stale0, 0, torch.where(stale1, 1, -1)).to(I32)
    return var, is_dup, var >= 0


def insert_block(p: SimParams, s: Store, weights, b: BlockMsg, rec_epoch):
    """Verify and insert a block.  Returns (store, ok)."""
    if not needed(b.valid):
        return s, b.valid
    sl = _slot(p, b.round)
    var, is_dup, has_room = _pick_variant(
        take(s.blk_valid, sl), take(s.blk_round, sl), take(s.blk_tag, sl),
        b.round, b.tag)
    prev_initial = (b.prev_round == s.initial_round) & (b.prev_tag == s.initial_tag)
    prev_known = prev_initial | (qc_find(p, s, b.prev_round, b.prev_tag) >= 0)
    in_window = b.round > s.current_round - p.window
    ok = (b.valid & (rec_epoch == s.epoch_id) & ~is_dup & has_room & prev_known
          & (b.round > b.prev_round) & in_window)
    var = var.clamp(min=0)
    m = onehot(s.blk_valid, (sl, var), when=ok)
    # current_proposed_block: only the legitimate leader's block at the
    # current round becomes the proposal.
    is_proposal = ok & (b.round == s.current_round) & (
        current_leader(s, weights) == b.author)
    return s.replace(
        blk_valid=put(m, s.blk_valid, True),
        blk_round=put(m, s.blk_round, b.round),
        blk_author=put(m, s.blk_author, b.author),
        blk_prev_round=put(m, s.blk_prev_round, b.prev_round),
        blk_prev_tag=put(m, s.blk_prev_tag, b.prev_tag),
        blk_time=put(m, s.blk_time, b.time),
        blk_cmd_proposer=put(m, s.blk_cmd_proposer, b.cmd_proposer),
        blk_cmd_index=put(m, s.blk_cmd_index, b.cmd_index),
        blk_tag=put(m, s.blk_tag, b.tag),
        proposed_var=torch.where(is_proposal, var, s.proposed_var),
    ), ok


def insert_vote(p: SimParams, s: Store, weights, v: VoteMsg):
    """Verify and insert a vote, then update the ballot.  Returns (store, ok)."""
    if not needed(v.valid):
        return s, v.valid
    bvar = blk_find(p, s, v.round, v.blk_tag)
    cs_ok, cs_d, cs_t, cs_undet = vote_committed_state(
        p, s, v.round, bvar.clamp(min=0))
    commit_match = cs_undet | (
        (v.commit_valid == cs_ok)
        & (~cs_ok | ((v.commit_depth == cs_d) & (v.commit_tag == cs_t))))
    author = v.author.clamp(0, p.n_nodes - 1)
    ok = (v.valid & (v.epoch == s.epoch_id) & (bvar >= 0) & commit_match
          & (v.round == s.current_round) & ~take(s.vt_valid, author))
    bvar = bvar.clamp(min=0)
    mv = onehot(s.vt_valid, author, when=ok)
    # Ballot update (ElectionState::Ongoing only); the vote rows above do
    # not touch the ballot, so it is read from the old store.
    ongoing = s.election == ELECTION_ONGOING
    used0, used1 = take(s.bal_used, bvar, 0), take(s.bal_used, bvar, 1)
    m0 = used0 & (take(s.bal_state_depth, bvar, 0) == v.state_depth) \
        & (take(s.bal_state_tag, bvar, 0) == v.state_tag)
    m1 = used1 & (take(s.bal_state_depth, bvar, 1) == v.state_depth) \
        & (take(s.bal_state_tag, bvar, 1) == v.state_tag)
    slot = torch.where(m0, 0, torch.where(m1, 1, torch.where(
        ~used0, 0, torch.where(~used1, 1, -1)))).to(I32)
    has_slot = slot >= 0
    slot = slot.clamp(min=0)
    new_weight = take(s.bal_weight, bvar, slot) + take(weights, author)
    do_ballot = ok & ongoing & has_slot
    mb = onehot(s.bal_used, (bvar, slot), when=do_ballot)
    won = do_ballot & (new_weight >= config.quorum_threshold(weights))
    return s.replace(
        vt_valid=put(mv, s.vt_valid, True),
        vt_blk_var=put(mv, s.vt_blk_var, bvar),
        vt_state_depth=put(mv, s.vt_state_depth, v.state_depth),
        vt_state_tag=put(mv, s.vt_state_tag, v.state_tag),
        vt_commit_valid=put(mv, s.vt_commit_valid, v.commit_valid),
        vt_commit_depth=put(mv, s.vt_commit_depth, v.commit_depth),
        vt_commit_tag=put(mv, s.vt_commit_tag, v.commit_tag),
        bal_used=put(mb, s.bal_used, True),
        bal_weight=put(mb, s.bal_weight, new_weight),
        bal_state_depth=put(mb, s.bal_state_depth, v.state_depth),
        bal_state_tag=put(mb, s.bal_state_tag, v.state_tag),
        election=torch.where(won, ELECTION_WON, s.election),
        won_var=torch.where(won, bvar, s.won_var),
        won_slot=torch.where(won, slot, s.won_slot),
    ), ok


def insert_qc(p: SimParams, s: Store, weights, q: QcMsg, tag_ok=None):
    """Verify and insert a QC, with vote-set re-verification: the masked
    authors must be known, their weight must reach quorum, and the tag must
    recompute from the carried fields including the mask (``tag_ok``, when
    the caller already checked it, e.g. for a batch of incoming QCs at
    once).  Returns (store, ok)."""
    if not needed(q.valid):
        return s, q.valid
    sl = _slot(p, q.round)
    var, is_dup, has_room = _pick_variant(
        take(s.qc_valid, sl), take(s.qc_round, sl), take(s.qc_tag, sl),
        q.round, q.tag)
    bvar = blk_find(p, s, q.round, q.blk_tag)
    bvar_c = bvar.clamp(min=0)
    author_ok = take(s.blk_author, sl, bvar_c) == q.author
    prev = prev_qc_of_block(p, s, q.round, bvar_c)
    cs_ok, cs_d, cs_t, cs_undet = vote_committed_state(p, s, q.round, bvar_c, prev)
    commit_match = cs_undet | (
        (q.commit_valid == cs_ok)
        & (~cs_ok | ((q.commit_depth == cs_d) & (q.commit_tag == cs_t))))
    exec_ok, st_d, st_t = compute_state(p, s, q.round, bvar_c, prev)
    state_match = exec_ok & (st_d == q.state_depth) & (st_t == q.state_tag)
    in_window = q.round > s.current_round - p.window
    vote_w, authors_known = mask_weight(p, weights, q.votes_lo, q.votes_hi)
    quorum_ok = authors_known & (vote_w >= config.quorum_threshold(weights))
    if tag_ok is None:
        tag_ok = q.tag == qc_msg_tag(q)
    ok = (q.valid & (q.epoch == s.epoch_id) & ~is_dup & has_room & (bvar >= 0)
          & author_ok & commit_match & state_match & in_window & quorum_ok & tag_ok)
    var = var.clamp(min=0)
    m = onehot(s.qc_valid, (sl, var), when=ok)
    newer = ok & (q.round > s.hqc_round)
    s2 = s.replace(
        qc_valid=put(m, s.qc_valid, True),
        qc_round=put(m, s.qc_round, q.round),
        qc_blk_var=put(m, s.qc_blk_var, bvar_c),
        qc_state_depth=put(m, s.qc_state_depth, q.state_depth),
        qc_state_tag=put(m, s.qc_state_tag, q.state_tag),
        qc_commit_valid=put(m, s.qc_commit_valid, q.commit_valid),
        qc_commit_depth=put(m, s.qc_commit_depth, q.commit_depth),
        qc_commit_tag=put(m, s.qc_commit_tag, q.commit_tag),
        qc_votes_lo=put(m, s.qc_votes_lo, q.votes_lo),
        qc_votes_hi=put(m, s.qc_votes_hi, q.votes_hi),
        qc_author=put(m, s.qc_author, q.author),
        qc_tag=put(m, s.qc_tag, q.tag),
        hqc_round=torch.where(newer, q.round, s.hqc_round),
        hqc_var=torch.where(newer, var, s.hqc_var),
    )
    s2 = update_current_round(s2, q.round + 1, when=ok)
    s2 = update_commit_chain(p, s2, q.round, var, when=ok)
    return s2, ok


def insert_timeout(p: SimParams, s: Store, weights, t_epoch, t_round, t_hcbr,
                   t_author, when=None):
    """Verify and insert a timeout; a quorum forms a TC and advances the
    round.  ``when`` gates the insert per instance.  Returns (store, ok)."""
    if when is not None and not needed(when):
        return s, when
    author = t_author.clamp(0, p.n_nodes - 1)
    ok = ((t_epoch == s.epoch_id) & (t_hcbr <= s.hqc_round)
          & (t_round == s.current_round) & ~take(s.to_valid, author))
    if when is not None:
        ok = ok & when
    new_weight = s.to_weight + take(weights, author)
    m = onehot(s.to_valid, author, when=ok)
    to_valid = put(m, s.to_valid, True)
    to_hcbr = put(m, s.to_hcbr, t_hcbr)
    tc = ok & (new_weight >= config.quorum_threshold(weights))
    s2 = s.replace(
        to_valid=to_valid,
        to_hcbr=to_hcbr,
        to_weight=torch.where(ok, new_weight, s.to_weight),
        tc_valid=where(tc, to_valid, s.tc_valid),
        tc_hcbr=where(tc, to_hcbr, s.tc_hcbr),
        htc_round=torch.where(tc, s.current_round, s.htc_round),
    )
    return update_current_round(s2, s.current_round + 1, when=tc), ok


# ---------------------------------------------------------------------------
# Record creation
# ---------------------------------------------------------------------------


def make_block_msg(p: SimParams, s: Store, author, prev_round, prev_tag, time,
                   cmd_proposer, cmd_index):
    r = s.current_round
    tag = block_tag(s.epoch_id, r, author, prev_round, prev_tag, time,
                    cmd_proposer, cmd_index)
    return BlockMsg(
        valid=torch.ones_like(r, dtype=torch.bool), round=r, author=author,
        prev_round=prev_round, prev_tag=prev_tag, time=time,
        cmd_proposer=cmd_proposer, cmd_index=cmd_index, tag=tag,
    )


def propose_block(p: SimParams, s: Store, weights, author, prev_round, prev_tag,
                  time, cmd_index, when=None):
    """Fetch a command (proposer=author, running index) and insert a block on
    top of ``prev``; ``when`` gates it per instance."""
    b = make_block_msg(p, s, author, prev_round, prev_tag, time, author, cmd_index)
    if when is not None:
        b = b.replace(valid=when)
    return insert_block(p, s, weights, b, s.epoch_id)


def create_vote(p: SimParams, s: Store, weights, author, blk_round, blk_var,
                when=None):
    """Execute the block, vote for the resulting state; ``when`` gates it per
    instance.  Returns (store, ok) - ok False if execution failed."""
    if when is not None and not needed(when):
        return s, when
    sl = _slot(p, blk_round)
    prev = prev_qc_of_block(p, s, blk_round, blk_var)
    cs_ok, cs_d, cs_t, _ = vote_committed_state(p, s, blk_round, blk_var, prev)
    exec_ok, st_d, st_t = compute_state(p, s, blk_round, blk_var, prev)
    v = VoteMsg(
        valid=exec_ok if when is None else exec_ok & when,
        epoch=s.epoch_id, round=blk_round,
        blk_tag=take(s.blk_tag, sl, blk_var), state_depth=st_d, state_tag=st_t,
        commit_valid=cs_ok, commit_depth=cs_d, commit_tag=cs_t, author=author,
    )
    s2, ins_ok = insert_vote(p, s, weights, v)
    return s2, exec_ok & ins_ok


def create_timeout(p: SimParams, s: Store, weights, author, round_, when=None):
    return insert_timeout(p, s, weights, s.epoch_id, round_, s.hqc_round,
                          author, when=when)


def has_timeout(s: Store, author, round_):
    return (round_ == s.current_round) & take(s.to_valid, author)


def check_new_qc(p: SimParams, s: Store, weights, author):
    """If our proposal won the election, mint the QC from the recorded
    votes.  Returns (store, created)."""
    won = s.election == ELECTION_WON
    bvar = s.won_var
    sl = _slot(p, s.current_round)
    trigger = won & (take(s.blk_author, sl, bvar) == author)
    if not needed(trigger):
        return s, trigger
    st_d = take(s.bal_state_depth, bvar, s.won_slot)
    st_t = take(s.bal_state_tag, bvar, s.won_slot)
    cs_ok, cs_d, cs_t, _ = vote_committed_state(p, s, s.current_round, bvar)
    votes_mask = (s.vt_valid & (s.vt_state_depth == st_d.unsqueeze(-1))
                  & (s.vt_state_tag == st_t.unsqueeze(-1))
                  & (s.vt_blk_var == bvar.unsqueeze(-1)))
    lo, hi = author_mask_words(votes_mask)
    blk_tag_ = take(s.blk_tag, sl, bvar)
    tag = qc_tag(s.epoch_id, s.current_round, blk_tag_, st_d, st_t,
                 cs_ok, cs_d, cs_t, lo, hi, author)
    q = QcMsg(
        valid=trigger, epoch=s.epoch_id, round=s.current_round,
        blk_tag=blk_tag_, state_depth=st_d, state_tag=st_t,
        commit_valid=cs_ok, commit_depth=cs_d, commit_tag=cs_t,
        votes_lo=lo, votes_hi=hi, author=author, tag=tag,
    )
    # Without a trigger the QC is invalid and the insert leaves s2 == s, so
    # the JAX package's final select on ``trigger`` is the identity here.
    s2 = s.replace(election=torch.where(trigger, ELECTION_CLOSED, s.election))
    # The QC's tag was just computed from its own fields: it verifies.
    s3, _ = insert_qc(p, s2, weights, q, tag_ok=trigger)
    return s3, trigger


# ---------------------------------------------------------------------------
# Commit extraction
# ---------------------------------------------------------------------------


def committed_states_after(p: SimParams, s: Store, after_round):
    """Walk the highest-commit-certificate chain backward, skip the newest
    C-1 QCs (not yet committed), collect states with round > after_round.
    Returns ``[B, W]`` (valid, round, depth, tag) in ASCENDING round order
    (valid entries right-aligned)."""
    W = p.window
    start_r = torch.where(s.hcc_valid, s.hcc_round, 0)
    valids, rounds, vars_, _ = qc_walk_back(p, s, s.hcc_valid, start_r, s.hcc_var, W)
    valids = torch.stack(valids[::-1], dim=1)
    rounds = torch.stack(rounds[::-1], dim=1)
    vars_ = torch.stack(vars_[::-1], dim=1)
    skip = p.commit_chain - 1
    # Ascending order: newest-first hop i sits at column W-1-i.
    keep = valids & (arange(W, s.hcr.device) <= W - 1 - skip) \
        & (rounds > after_round.unsqueeze(-1))
    sls = torch.remainder(rounds, W)
    rows = arange(s.hcr.shape[0], s.hcr.device).unsqueeze(-1)
    depths = s.qc_state_depth[rows, sls, vars_]
    tags = s.qc_state_tag[rows, sls, vars_]
    return keep, rounds, depths, tags
