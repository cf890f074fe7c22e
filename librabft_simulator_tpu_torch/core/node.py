"""NodeState: the main per-node protocol loop ``update_node``, commit
delivery and the commit tracker.  The port of
``librabft_simulator_tpu/core/node.py``.

All functions take the handled node's slices with ``[B]`` in front
(per-author axes keep their ``[N]`` dim).
"""

from __future__ import annotations

import dataclasses

import torch

from . import data_sync
from . import pacemaker as pm_ops
from . import store as store_ops
from .types import Context, NodeExtra, Pacemaker, SimParams, Store, pack_payload, sat_add
from ..utils import hashing as H
from ..utils.xops import arange, needed, take

I32 = torch.int32


@dataclasses.dataclass
class NodeUpdateActions:
    """NodeUpdateActions: ``should_send``/``should_broadcast`` merged into one
    receiver mask, plus the cross-epoch handoff capture (the old-epoch
    response pack built at an epoch switch; ``None`` when
    SimParams.epoch_handoff is off)."""

    next_sched: torch.Tensor    # NodeTime
    send_mask: torch.Tensor     # [N] bool - receivers of our notification
    should_query_all: torch.Tensor
    ho_switched: torch.Tensor   # bool: this update crossed an epoch boundary
    ho_epoch: torch.Tensor      # epoch the pack belongs to
    ho_pack: torch.Tensor | None  # [F] packed old-epoch response (None: no
                                  # instance switched, nothing to capture)


def inert_actions(p: SimParams, no) -> NodeUpdateActions:
    """The actions of an update no instance makes (``no``: an all-False
    ``[B]`` mask); every use of them is gated by the update mask."""
    z = torch.zeros_like(no, dtype=I32)
    return NodeUpdateActions(
        next_sched=z, send_mask=no.unsqueeze(-1).expand(no.shape[0], p.n_nodes),
        should_query_all=no, ho_switched=no, ho_epoch=z, ho_pack=None)


def update_node(p: SimParams, s: Store, pm: Pacemaker, nx: NodeExtra, ctx: Context,
                weights, author, clock, dur_table):
    """One step of the protocol main loop (node.rs:240-304).
    Returns (store, pm, node_extra, ctx, NodeUpdateActions)."""
    nodes = arange(p.n_nodes, author.device)
    # --- Pacemaker update + its actions.
    pm, pa = pm_ops.update_pacemaker(
        p, pm, s, weights, author, s.epoch_id, nx.latest_query_all, clock, dur_table)
    send_mask = (nodes == pa.send_leader.unsqueeze(-1)) & (pa.send_leader >= 0).unsqueeze(-1)
    # Create a timeout; never vote at a round we timed out.
    s, _ = store_ops.create_timeout(p, s, weights, author, pa.timeout_round,
                                    when=pa.should_create_timeout)
    nx = nx.replace(latest_voted_round=torch.where(
        pa.should_create_timeout,
        torch.maximum(nx.latest_voted_round, pa.timeout_round),
        nx.latest_voted_round))
    # Propose a block: fetch() always yields the next (author, index) command.
    s, _ = store_ops.propose_block(
        p, s, weights, author, pa.propose_prev_round, pa.propose_prev_tag,
        clock, ctx.next_cmd_index, when=pa.should_propose)
    ctx = ctx.replace(next_cmd_index=ctx.next_cmd_index + pa.should_propose.to(I32))

    # --- Vote on the proposed block.
    has_prop = pm_ops.proposed_block_valid(pm, s)
    bvar = s.proposed_var.clamp(min=0)
    block_round = s.current_round
    sl = torch.remainder(block_round, p.window)
    proposer = take(s.blk_author, sl, bvar)
    prev_r = store_ops.previous_round(p, s, block_round, bvar)
    may_vote = has_prop & (block_round > nx.latest_voted_round) & (prev_r >= nx.locked_round)
    second_prev = store_ops.second_previous_round(p, s, block_round, bvar)
    nx = nx.replace(
        latest_voted_round=torch.where(may_vote, block_round, nx.latest_voted_round),
        locked_round=torch.where(
            may_vote, torch.maximum(nx.locked_round, second_prev), nx.locked_round),
    )
    # The insert's own verification carries the ``may_vote`` gate, which is
    # the JAX package's select on it.
    s, vote_ok = store_ops.create_vote(p, s, weights, author, block_round, bvar,
                                       when=may_vote)
    voted = may_vote & vote_ok
    # Send our vote to the proposer.
    send_mask = torch.where(voted.unsqueeze(-1), nodes == proposer.unsqueeze(-1),
                            send_mask)

    # --- Mint a QC if our proposal won.
    s, qc_created = store_ops.check_new_qc(p, s, weights, author)
    broadcast = pa.should_broadcast | qc_created
    next_sched = torch.where(qc_created, clock, pa.next_sched)

    # --- Deliver commits / switch epochs.
    s, nx, ctx, ho_switched, ho_epoch, ho_pack = process_commits(
        p, s, nx, ctx, weights, author)

    # --- Commit tracker.
    nx, tr_query_all, tr_next = update_tracker(p, nx, s, clock)
    query_all = pa.should_query_all | tr_query_all
    next_sched = torch.minimum(next_sched, tr_next)
    nx = nx.replace(latest_query_all=torch.where(query_all, clock, nx.latest_query_all))
    send_mask = send_mask | (broadcast.unsqueeze(-1) & (nodes != author.unsqueeze(-1)))
    actions = NodeUpdateActions(
        next_sched=next_sched, send_mask=send_mask, should_query_all=query_all,
        ho_switched=ho_switched, ho_epoch=ho_epoch, ho_pack=ho_pack,
    )
    return s, pm, nx, ctx, actions


def process_commits(p: SimParams, s: Store, nx: NodeExtra, ctx: Context, weights,
                    author):
    """node.rs:313-351: deliver newly committed states to the context in
    ascending round order; on an epoch boundary, rebuild the record store for
    the new epoch and stop delivering.

    Returns (store, nx, ctx, ho_switched, ho_epoch, ho_pack): the ho_* values
    are the cross-epoch handoff capture, the packed response of the
    post-update, pre-switch store (``None`` when SimParams.epoch_handoff is
    off)."""
    keep, rounds, depths, tags = store_ops.committed_states_after(p, s, nx.tracker_hcr)
    ctx, sw, sw_e, sw_d, sw_t = _deliver(p, s, ctx, keep, rounds, depths, tags)
    # Cross-epoch handoff capture: the old store's full response pack (chain
    # K-tail + highest CC), built before the switch discards it.
    old_epoch = s.epoch_id
    if p.epoch_handoff and needed(sw):
        notif_old = data_sync.create_notification(p, s, author)
        resp_old = data_sync.handle_request(p, s, author, notif_old, notif=notif_old)
        ho_pack = pack_payload(resp_old)
    else:
        ho_pack = None
    # Epoch switch: fresh record store anchored at the committed state; reset
    # voting constraints.
    s = store_ops._sel(sw, new_epoch_store(p, s, sw_e, sw_d, sw_t), s)
    nx = nx.replace(
        latest_voted_round=torch.where(sw, 0, nx.latest_voted_round),
        locked_round=torch.where(sw, 0, nx.locked_round),
    )
    return s, nx, ctx, sw, old_epoch, ho_pack


def _deliver(p: SimParams, s: Store, ctx: Context, keep, rounds, depths, tags):
    """The JAX package's delivery scan over the ``[B, W]`` ascending
    committed entries, computed for all entries at once.

    In the scan, entry i is delivered when it is valid, no earlier delivery
    switched epochs, and its depth exceeds the last delivered one.  A valid
    entry that is not delivered never exceeds that depth, so the last
    delivered depth before i is the running maximum over earlier valid
    entries (and the context's last depth), and delivery stops after the
    first delivery that switches epochs.  Returns (ctx, switched, epoch,
    depth, tag) of the switch."""
    b, w = keep.shape
    idx = arange(w, keep.device)
    d0 = ctx.last_depth.unsqueeze(-1)
    seen = torch.cummax(torch.where(keep, depths, torch.iinfo(I32).min), dim=1).values
    last = torch.maximum(torch.cat([d0, seen[:, :-1]], dim=1), d0)
    do = keep & (depths > last)
    # EpochReader::read_epoch_id = depth // commands_per_epoch.
    new_epoch = torch.div(depths, p.commands_per_epoch, rounding_mode="floor")
    first = torch.where(do & (new_epoch > s.epoch_id.unsqueeze(-1)), idx, w).min(dim=1).values
    do = do & (idx <= first.unsqueeze(-1))
    sw = first < w
    at = first.clamp(max=w - 1).unsqueeze(-1)
    sw_e = torch.where(sw, new_epoch.gather(1, at).squeeze(1), 0)
    sw_d = torch.where(sw, depths.gather(1, at).squeeze(1), 0)
    sw_t = torch.where(sw, tags.gather(1, at).squeeze(1), 0)
    # StateFinalizer::commit: ring appends at consecutive positions; where
    # more entries than ring slots arrive, the later one wins, as in order.
    n_do = do.sum(dim=1, dtype=I32)
    h = p.commit_log
    pos = torch.remainder(ctx.commit_count.unsqueeze(-1)
                          + torch.cumsum(do, dim=1, dtype=I32) - 1, h)
    hit = do.unsqueeze(-1) & (pos.unsqueeze(-1) == arange(h, keep.device))  # [B, W, H]
    winner = torch.where(hit, idx.reshape(1, w, 1), -1).max(dim=1).values   # [B, H]
    written = winner >= 0
    src = winner.clamp(min=0)
    # Depths between consecutive deliveries were bypassed: the increments
    # d_i - last_i - 1 telescope to d_last - last_depth - n_do.
    last_i = torch.where(do, idx, -1).max(dim=1).values
    has = last_i >= 0
    at = last_i.clamp(min=0).unsqueeze(-1)
    lc_d = torch.where(has, depths.gather(1, at).squeeze(1), ctx.last_depth)
    lc_t = torch.where(has, tags.gather(1, at).squeeze(1), ctx.last_tag)
    ctx = ctx.replace(
        commit_count=ctx.commit_count + n_do,
        last_depth=lc_d,
        last_tag=lc_t,
        skipped_commits=ctx.skipped_commits + torch.where(
            has, lc_d - ctx.last_depth - n_do, 0),
        log_round=torch.where(written, rounds.gather(1, src), ctx.log_round),
        log_depth=torch.where(written, depths.gather(1, src), ctx.log_depth),
        log_tag=torch.where(written, tags.gather(1, src), ctx.log_tag),
    )
    return ctx, sw, sw_e, sw_d, sw_t


def new_epoch_store(p: SimParams, s: Store, epoch, state_depth, state_tag) -> Store:
    """RecordStoreState::new for a later epoch."""
    fresh = Store.initial(p, epoch.shape, epoch.device)
    return fresh.replace(
        epoch_id=epoch,
        initial_tag=H.epoch_initial_tag(epoch),
        initial_state_depth=state_depth,
        initial_state_tag=state_tag,
    )


def update_tracker(p: SimParams, nx: NodeExtra, s: Store, clock):
    """CommitTracker::update_tracker (node.rs:363-397).
    Returns (node_extra, should_query_all, next_sched)."""
    bump = (s.epoch_id > nx.tracker_epoch) | (s.hcr > nx.tracker_hcr)
    nx = nx.replace(
        tracker_epoch=torch.maximum(nx.tracker_epoch, s.epoch_id),
        tracker_hcr=torch.where(bump, s.hcr, nx.tracker_hcr),
        tracker_commit_time=torch.where(bump, clock, nx.tracker_commit_time),
    )
    base = torch.maximum(nx.tracker_commit_time, nx.latest_query_all)
    deadline = sat_add(base, p.target_commit_interval)
    should_query_all = clock >= deadline
    deadline = torch.where(should_query_all,
                           sat_add(clock, p.target_commit_interval), deadline)
    return nx, should_query_all, deadline
