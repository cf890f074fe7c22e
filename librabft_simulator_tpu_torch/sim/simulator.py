"""Batched discrete-event simulator: the port of
``librabft_simulator_tpu/sim/simulator.py`` (the serial engine).

``step`` processes exactly one event of every instance of a ``[B]`` batch
(JAX vmaps a per-instance step; here the batch dim is written out);
``macro_step`` is ``SimParams.macro_k`` steps, the unit a chunk counts;
``make_scan_fn`` is the chunk runner that ``run_to_completion``, its
``stream=`` loop and the sharded runtime (parallel/sharded.py) share; and
``run_to_completion`` is a chunked host loop over it with one
``halted.all()`` read per chunk, or with ``stream=`` one fetch of the
``[13]`` fleet digest per chunk (telemetry/stream.py).  Both loops record
their dispatch and poll spans on the runtime ledger (telemetry/ledger.py).

Event selection is the lexicographic argmin over (time asc, kind desc,
stamp asc) of ``ops/select_events.py::select_queue_events``, which reads the
queue and timers in place: the hand-written CUDA kernel on the card, its
plain version on the CPU.  Every entry point runs on ``cuda``
unless the caller passes ``device="cpu"``.

``SimParams.telemetry`` (the metrics plane and flight recorder) and
``SimParams.watchdog`` (the consensus watchdog) add their updates to the
step when on; off, their leaves are zero-width and the step launches
nothing for them.  So do the scenario plane (``SimParams.scenario``: each
instance draws its delays from its own ``sc_delay`` table and commits by
its own ``sc_commit`` rule) and the adversary plane
(``SimParams.adversary``: windowed Byzantine behaviors OR-ed onto the
static masks, per-link and windowed extra delays, partitions that heal;
adversary/plane.py).  ``SimParams.mp_authors`` sums the quorum sites over
the author group that the sharded runtime binds (core/config.py); outside
it the step raises ``NameError``, as JAX's trace of an unbound axis does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..adversary import plane as aplane
from ..core import data_sync, node as node_ops, store as store_ops
from ..core.config import leader_of_round
from ..core.types import (
    KIND_NOTIFY,
    KIND_REQUEST,
    KIND_RESPONSE,
    KIND_TIMER,
    NEVER,
    Context,
    NodeExtra,
    Pacemaker,
    Payload,
    Queue,
    SimParams,
    SimState,
    Store,
    TracedParams,
    pack_payload,
    payload_offsets,
    payload_width,
    plane_leaves,
    sat_add,
    tree_fields,
    tree_map,
    unpack_payload,
)
from ..ops.select_events import select_queue_events
from ..telemetry import ledger as tledger, plane as tplane, stream as tstream
from ..utils import hashing as H
from ..utils.quantile import TABLE_BITS
from ..utils.xops import (arange, const, needed, onehot, put, resolve_params, scatter_set,
                          take, wset, zeros)

I32 = torch.int32
EQUIV_SALT = 1 << 20  # command-index offset of an equivocating second proposal

# Default host-loop budget: macro-steps per chunk x chunk cap.  The sharded
# sweep path (analysis/sweeps.py) runs under the same cap.
RUN_CHUNK = 256
RUN_MAX_CHUNKS = 400


def _u32_to_i32(values) -> np.ndarray:
    return np.asarray(values).astype(np.uint32).view(np.int32)


def _per_instance(x, b, n, dtype, device, default):
    """A ``[N]`` or ``[B, N]`` per-node argument as a ``[B, N]`` tensor."""
    if x is None:
        return torch.full((b, n), default, dtype=dtype, device=device)
    t = torch.as_tensor(np.asarray(x), device=device).to(dtype)
    return t.expand(b, n).contiguous() if t.dim() == 1 else t


def init_batch(p: SimParams, seeds, weights=None, byz_equivocate=None,
               byz_silent=None, byz_forge_qc=None, device="cuda") -> SimState:
    """Simulator::new for a batch of instance seeds: per-node random startup
    times, initial timers at local time 0.  ``weights`` and the ``byz_*``
    masks are ``[N]`` (shared) or ``[B, N]`` (per instance)."""
    seeds = _u32_to_i32(np.asarray(seeds).reshape(-1))
    b, n = seeds.shape[0], p.n_nodes
    device = torch.device(device)
    seed = torch.as_tensor(seeds.copy(), device=device)
    delay_table = torch.as_tensor(p.delay_table(), device=device)
    nodes = arange(n, device)
    draws = H.rng_u32(seed.unsqueeze(-1), nodes)
    startup = delay_table[H.as_u32(draws) >> (32 - TABLE_BITS)] + 1
    e = p.handoff_epochs if p.epoch_handoff else 0
    f = payload_width(p)

    def full(shape, value, dtype=I32):
        return torch.full(shape, value, dtype=dtype, device=device)

    def z(*shape, dtype=I32):
        return zeros(tuple(shape), dtype, device)

    return SimState(
        store=Store.initial(p, (b, n), device),
        pm=Pacemaker.initial((b, n), device),
        node=NodeExtra.initial((b, n), device),
        ctx=Context.initial(p, (b, n), device),
        queue=Queue.initial(p, (b,), device),
        ho_pay=z(b, n, e, f),
        ho_epoch=full((b, n, e), -1),
        timer_time=startup,
        timer_stamp=nodes.to(I32).expand(b, n).contiguous(),
        startup=startup,
        weights=_per_instance(weights, b, n, I32, device, 1),
        byz_equivocate=_per_instance(byz_equivocate, b, n, torch.bool, device, False),
        byz_silent=_per_instance(byz_silent, b, n, torch.bool, device, False),
        byz_forge_qc=_per_instance(byz_forge_qc, b, n, torch.bool, device, False),
        clock=z(b),
        stamp_ctr=full((b,), n),
        halted=z(b, dtype=torch.bool),
        seed=seed,
        max_clock=full((b,), p.max_clock),
        drop_u32=full((b,), H.to_i32(p.drop_u32)),
        n_events=z(b), n_msgs_sent=z(b), n_msgs_dropped=z(b), n_queue_full=z(b),
        trace_node=z(b, p.trace_cap), trace_round=z(b, p.trace_cap),
        trace_time=z(b, p.trace_cap), trace_count=z(b),
        metrics=tplane.init_plane(p, (b,), device), flight=tplane.init_flight(p, (b,), device),
        wd=tstream.init_wd(p, (b,), device),
        **plane_leaves(p, (b,), device),
    )


def init_state(p: SimParams, seed: int, weights=None, byz_equivocate=None,
               byz_silent=None, byz_forge_qc=None, device="cuda") -> SimState:
    """One instance: a batch of one (the JAX package's unbatched state is
    this state's row 0)."""
    return init_batch(p, [seed], weights=weights, byz_equivocate=byz_equivocate,
                      byz_silent=byz_silent, byz_forge_qc=byz_forge_qc,
                      device=device)


def _select_event(p: SimParams, st: SimState):
    """Lexicographic (time, kind desc, stamp) argmin over messages + timers:
    the ``[B, cm + n]`` rows the JAX package builds, read in place from the
    queue and timers by select_queue_events."""
    q = st.queue
    idx, t_min = select_queue_events(q.valid, q.time, q.kind, q.stamp,
                                     st.timer_time, st.timer_stamp, KIND_TIMER)
    return idx, t_min, idx >= p.queue_cap


def _equivocated_row(p: SimParams, s_a: Store, notif: Payload, row):
    """Packed second, conflicting proposal for Byzantine equivocation: the
    notification row with a salted command index, its block tag, and no
    vote."""
    b = notif.prop_blk
    cmd_index = b.cmd_index + EQUIV_SALT
    tag = store_ops.block_tag(s_a.epoch_id, b.round, b.author, b.prev_round,
                              b.prev_tag, b.time, b.cmd_proposer, cmd_index)
    off = payload_offsets(p)
    row = row.clone()
    row[:, off["prop_blk.cmd_index"][0]] = cmd_index
    row[:, off["prop_blk.tag"][0]] = tag
    row[:, off["vote.valid"][0]] = 0
    return row


def _forged_qc_payload(p: SimParams, s_a: Store, author, pay: Payload) -> Payload:
    """Quorum-less forged QC for Byzantine sweeps: the attacker claims a QC on
    its own current-round proposal backed only by its own vote (author-bit
    mask = {author}), with a self-consistent content tag, so the receiver's
    vote-set re-verification is the rejecting predicate."""
    bvar = s_a.proposed_var.clamp(min=0)
    r = s_a.current_round
    sl = torch.remainder(r, p.window)
    blk_tag_ = take(s_a.blk_tag, sl, bvar)
    own = (s_a.proposed_var >= 0) & (take(s_a.blk_author, sl, bvar) == author)
    prev = store_ops.prev_qc_of_block(p, s_a, r, bvar)
    exec_ok, st_d, st_t = store_ops.compute_state(p, s_a, r, bvar, prev)
    cs_ok, cs_d, cs_t, _ = store_ops.vote_committed_state(p, s_a, r, bvar, prev)
    au = author.to(torch.int64)
    lo = H.to_i32(torch.where(au < 32, 1 << au.clamp(0, 31), 0))
    hi = H.to_i32(torch.where(au >= 32, 1 << (au - 32).clamp(0, 31), 0))
    tag = store_ops.qc_tag(s_a.epoch_id, r, blk_tag_, st_d, st_t,
                           cs_ok, cs_d, cs_t, lo, hi, author)
    forged = pay.hqc.replace(
        valid=own & exec_ok, epoch=s_a.epoch_id, round=r, blk_tag=blk_tag_,
        state_depth=st_d, state_tag=st_t, commit_valid=cs_ok, commit_depth=cs_d,
        commit_tag=cs_t, votes_lo=lo, votes_hi=hi, author=author, tag=tag,
    )
    return pay.replace(hqc=forged)


def _gate_payload(pay: Payload, on) -> Payload:
    """The payload with every record's ``valid`` flag cleared where ``on``
    is False, so a handler fed it leaves those instances untouched."""
    def g(x):
        return x & on.reshape(on.shape + (1,) * (x.dim() - 1))

    return pay.replace(
        hcc=pay.hcc.replace(valid=g(pay.hcc.valid)),
        hqc=pay.hqc.replace(valid=g(pay.hqc.valid)),
        hcc_blk=pay.hcc_blk.replace(valid=g(pay.hcc_blk.valid)),
        prop_blk=pay.prop_blk.replace(valid=g(pay.prop_blk.valid)),
        vote=pay.vote.replace(valid=g(pay.vote.valid)),
        tc_to=pay.tc_to.replace(valid=g(pay.tc_to.valid)),
        cur_to=pay.cur_to.replace(valid=g(pay.cur_to.valid)),
        chain_blk=pay.chain_blk.replace(valid=g(pay.chain_blk.valid)),
        chain_qc=pay.chain_qc.replace(valid=g(pay.chain_qc.valid)),
    )


def _node_gather(tree, a):
    return type(tree)(**{f: take(getattr(tree, f), a) for f in tree_fields(tree)})


def _node_write(tree, gathered, new, mask):
    """Write the handled node's row back; rows the event left untouched
    (still the gathered tensor) are skipped."""
    kw = {}
    for f in tree_fields(tree):
        v = getattr(new, f)
        if v is not getattr(gathered, f):
            kw[f] = put(mask, getattr(tree, f), v)
    return tree.replace(**kw) if kw else tree


def handle_events(p: SimParams, dur_table, s_a: Store, pm_a, nx_a, cx_a, weights,
                  a, local_clock, pay_in: Payload, is_notify, is_request,
                  is_response, do_update, forge_a, silent_a, rows_a, eps_a,
                  any_equivocate: bool = True, any_forge: bool = True):
    """Handle one event per row: the notification or response handler, the
    node update, and the ``[R, 4, F]`` bank of outgoing payloads
    (notification, equivocating notification, request, response).  Shared
    by the serial engine (a row per instance) and the lane engine (a row per
    lane).  ``rows_a``/``eps_a`` are the handled node's epoch-handoff ring
    (``None`` when the handoff is off); the updated ring is returned.

    Returns (store, pm, node, ctx, actions, should_sync, bank, rows_a, eps_a)."""
    # ---- Handlers, masked by kind.  A row handles at most one kind, so
    # running the notification handler on a payload gated to notify events,
    # then the response handler on one gated to response events, gives the
    # JAX package's per-kind select of the two handlers' results.
    # (``needed`` skips work masked off for every row; on the card it
    # always runs.)
    s_in, should_sync, nx_in, cx_in = s_a, is_notify, nx_a, cx_a
    if needed(is_notify) or needed(is_response):
        tag_ok = data_sync.incoming_qc_tag_ok(p, pay_in)
        if needed(is_notify):
            s_in, should_sync = data_sync.handle_notification(
                p, s_a, weights, _gate_payload(pay_in, is_notify), tag_ok)
        if needed(is_response):
            s_in, nx_in, cx_in = data_sync.handle_response(
                p, s_in, nx_a, cx_a, weights, _gate_payload(pay_in, is_response),
                tag_ok)

    if needed(do_update):
        s_u, pm_u, nx_u, cx_u, actions = node_ops.update_node(
            p, s_in, pm_a, nx_in, cx_in, weights, a, local_clock, dur_table)
        s_f = store_ops._sel(do_update, s_u, s_in)
        pm_f = store_ops._sel(do_update, pm_u, pm_a)
        nx_f = store_ops._sel(do_update, nx_u, nx_in)
        cx_f = store_ops._sel(do_update, cx_u, cx_in)
    else:
        s_f, pm_f, nx_f, cx_f = s_in, pm_a, nx_in, cx_in
        actions = node_ops.inert_actions(p, do_update)

    # ---- Outgoing payloads.
    notif = data_sync.create_notification(p, s_f, a)
    if any_forge:
        notif = store_ops._sel(forge_a, _forged_qc_payload(p, s_f, a, notif), notif)
    notif_row = pack_payload(notif)
    notif_b_row = _equivocated_row(p, s_f, notif, notif_row) if any_equivocate \
        else notif_row
    # create_request (data_sync.rs:66-72): an empty payload carrying our
    # epoch and where our chain stands, written straight into its columns.
    off = payload_offsets(p)
    request_row = torch.zeros_like(notif_row)
    request_row[:, off["epoch"][0]] = s_f.epoch_id
    request_row[:, off["req_hqc_round"][0]] = s_f.hqc_round
    request_row[:, off["req_hcr"][0]] = s_f.hcr
    if needed(is_request & ~silent_a):
        resp_row = pack_payload(data_sync.handle_request(p, s_f, a, pay_in, notif=notif))
    else:
        resp_row = notif_row  # never selected: no row answers a request
    if p.epoch_handoff:
        # Cross-epoch handoff: update_node captured the old-epoch pack at the
        # switch; serve any requester whose epoch matches a held pack.
        E = p.handoff_epochs
        if actions.ho_pack is not None:   # None: no row switched epochs
            switched = do_update & actions.ho_switched
            wslot = torch.remainder(actions.ho_epoch.clamp(min=0), E)
            rows_a = wset(rows_a, wslot, actions.ho_pack, when=switched)
            eps_a = wset(eps_a, wslot, actions.ho_epoch, when=switched)
        rslot = torch.remainder(pay_in.epoch.clamp(min=0), E)
        serve_ho = (is_request & (take(eps_a, rslot) == pay_in.epoch)
                    & (pay_in.epoch < s_f.epoch_id))
        resp_row = torch.where(serve_ho.unsqueeze(-1), take(rows_a, rslot), resp_row)
    bank = torch.stack([notif_row, notif_b_row, request_row, resp_row], dim=1)
    return s_f, pm_f, nx_f, cx_f, actions, should_sync, bank, rows_a, eps_a


def step(p: SimParams, delay_table, dur_table, st: SimState,
         any_equivocate: bool = True, any_forge: bool = True) -> SimState:
    """Process one event of every instance (loop_until body,
    simulator.rs:380-468).

    ``any_equivocate`` / ``any_forge`` may be False when no instance of the
    batch can equivocate or forge (:func:`byz_flags`); the payload that
    behavior would select is then never built (the trajectory is the same).

    With the scenario plane on, ``delay_table`` is ignored: each instance
    draws from its own ``sc_delay`` row, and the protocol code sees the
    params through a TracedParams whose ``commit_chain`` is ``sc_commit``."""
    n, cm = p.n_nodes, p.queue_cap
    b = st.clock.shape[0]
    dev = st.clock.device
    nodes = arange(n, dev)
    pp = TracedParams(p, st.sc_commit[:, 0]) if p.scenario else p
    idx, t_min, is_timer = _select_event(p, st)
    halt = st.halted | (t_min > st.max_clock)
    live = ~halt
    clock = torch.maximum(st.clock, t_min.clamp(max=NEVER - 1))
    midx = idx.clamp(max=cm - 1)
    kind = torch.where(is_timer, KIND_TIMER, take(st.queue.kind, midx))
    a = torch.where(is_timer, idx - cm, take(st.queue.receiver, midx)).clamp(0, n - 1)
    sender = take(st.queue.sender, midx)
    pay_in = unpack_payload(p, take(st.queue.payload, midx))
    # Consume the message slot.
    queue_valid = wset(st.queue.valid, midx, False, when=live & ~is_timer)

    s_a = _node_gather(st.store, a)
    pm_a = _node_gather(st.pm, a)
    nx_a = _node_gather(st.node, a)
    cx_a = _node_gather(st.ctx, a)
    local_clock = clock - take(st.startup, a)
    eqv_a = take(st.byz_equivocate, a)
    silent_a = take(st.byz_silent, a)
    forge_a = take(st.byz_forge_qc, a)
    if p.adversary:
        # Windowed behaviors of the handled node, OR-ed onto the static
        # masks.  Keys: the event time, the instance's event count before
        # this event, and the node's epoch before its handler.
        adv_act = aplane.active_windows(st.adv_sched, clock, st.n_events, s_a.epoch_id)
        adv_eq, adv_sil, adv_forge = aplane.node_masks(st.adv_sched, adv_act, a)
        eqv_a, silent_a, forge_a = eqv_a | adv_eq, silent_a | adv_sil, forge_a | adv_forge

    not_timer = live & ~is_timer
    is_notify = not_timer & (kind == KIND_NOTIFY)
    is_request = not_timer & (kind == KIND_REQUEST)
    is_response = not_timer & (kind == KIND_RESPONSE)
    do_update = live & (is_timer | is_notify | is_response)
    if p.epoch_handoff:
        rows_a, eps_a = take(st.ho_pay, a), take(st.ho_epoch, a)  # [B, E, F], [B, E]
    else:
        rows_a = eps_a = None
    (s_f, pm_f, nx_f, cx_f, actions, should_sync, payload_bank, rows_a,
     eps_a) = handle_events(
        pp, dur_table, s_a, pm_a, nx_a, cx_a, st.weights, a, local_clock, pay_in,
        is_notify, is_request, is_response, do_update, forge_a, silent_a,
        rows_a, eps_a, any_equivocate, any_forge)
    if p.epoch_handoff:
        m_a = onehot(st.ho_epoch, a)
        ho_pay = put(m_a, st.ho_pay, rows_a)
        ho_epoch = put(m_a, st.ho_epoch, eps_a)
    else:
        ho_pay, ho_epoch = st.ho_pay, st.ho_epoch
    want_response = is_request & ~silent_a
    silent = silent_a
    others = nodes != a.unsqueeze(-1)
    # Candidate order fixes the stamp sequence: [sync-request or response]
    # then (timer stamp) then notifications then query-all requests.
    want_sync_req = is_notify & should_sync & ~silent
    cand0_want = want_sync_req | want_response
    cand0_kind = torch.where(want_response, KIND_RESPONSE, KIND_REQUEST).to(I32)
    cand0_recv = sender.clamp(0, n - 1)
    cand0_pay = torch.where(want_response, 3, 2).to(I32)

    speak = do_update & ~silent
    send_mask = actions.send_mask & others & speak.unsqueeze(-1)
    # Equivocators send the conflicting proposal to the upper index half.
    upper = nodes * 2 >= n
    notif_sel = (eqv_a.unsqueeze(-1) & upper).to(I32)
    query_mask = others & (actions.should_query_all & speak).unsqueeze(-1)

    if p.shuffle_receivers:
        # Seeded per-event receiver permutation (the reference shuffles
        # delivery order per broadcast, simulator.rs:343): receivers keep
        # their payload and mask but take the stamp, hence the delay draw, of
        # their permuted position.  A stable argsort of unsigned keys, ties
        # by index, as the oracle and the C++ engine replay it.
        base = H.rng_u32(st.seed, st.stamp_ctr)
        keys = H.as_u32(H.mix32(base.unsqueeze(-1), nodes + 1))
        order = torch.argsort(keys, dim=1, stable=True)
        send_mask = send_mask.gather(1, order)
        query_mask = query_mask.gather(1, order)
        notif_sel = notif_sel.expand(b, n).gather(1, order)
        node_row = order.to(I32)
    else:
        node_row = nodes.to(I32).expand(b, n)
    want = torch.cat([cand0_want.unsqueeze(-1), send_mask, query_mask], dim=1)
    kinds = torch.cat([cand0_kind.unsqueeze(-1), const((b, n), KIND_NOTIFY, I32, dev),
                       const((b, n), KIND_REQUEST, I32, dev)], dim=1)
    recvs = torch.cat([cand0_recv.unsqueeze(-1), node_row, node_row], dim=1)
    pay_sel = torch.cat([cand0_pay.unsqueeze(-1), notif_sel,
                         const((b, n), 2, I32, dev)], dim=1)

    # Stamps: candidate 0, then one for the timer reschedule, then the rest.
    pos_in_want = torch.cumsum(want, dim=1, dtype=I32) - 1
    timer_gap = do_update.to(I32)
    later = (arange(2 * n + 1, dev) > 0)
    stamps = st.stamp_ctr.unsqueeze(-1) + pos_in_want + later * timer_gap.unsqueeze(-1)
    stamps = stamps.to(I32)
    total_consumed = want.sum(dim=1, dtype=I32) + timer_gap
    timer_stamp_new = st.stamp_ctr + cand0_want.to(I32)

    # Delays + drops (schedule_network_event): unsigned draws, compared and
    # shifted on their int64 values.
    u_delay, u_drop = H.rng_u32_pair(st.seed.unsqueeze(-1), stamps)
    u_idx = H.as_u32(u_delay) >> (32 - TABLE_BITS)
    delays = st.sc_delay.gather(1, u_idx) if p.scenario else delay_table[u_idx]
    dropped = want & (H.as_u32(u_drop) < H.as_u32(st.drop_u32).unsqueeze(-1))
    if p.adversary:
        # The network plane: the link's and the active delay windows' extra
        # latency on each candidate, and the partition cut (a crossing
        # message sent before the heal time is dropped).  The leader is the
        # handled node's, after its handler.
        recv_c = recvs.clamp(0, n - 1).to(torch.int64)
        leader = leader_of_round(st.weights, pm_f.active_round)
        delays = (delays + take(st.adv_link, a).gather(1, recv_c).clamp(0, aplane.DELAY_CAP)
                  + aplane.delay_extra(st.adv_sched, adv_act, recv_c, leader))
        cut = ((take(st.adv_group, a).unsqueeze(-1) != st.adv_group.gather(1, recv_c))
               & (clock < st.adv_heal[:, 0]).unsqueeze(-1))
        dropped = dropped | (want & cut)
    arrive = clock.unsqueeze(-1) + delays

    # Free-slot assignment.
    go = want & ~dropped
    free = ~queue_valid
    n_free = free.sum(dim=1, dtype=I32)
    rank = torch.cumsum(go, dim=1, dtype=I32) - 1
    free_rank = torch.cumsum(free, dim=1, dtype=I32) - 1
    # slot_of_rank[r] = index of the r-th free slot (2n+1 is the drop sentinel).
    sentinel = 2 * n + 1
    slot_of_rank = scatter_set(
        const((b, sentinel), -1, I32, dev),
        torch.where(free, free_rank, sentinel).clamp(max=sentinel),
        arange(cm, dev).to(I32).expand(b, cm))
    overflow = go & (rank >= n_free.unsqueeze(-1))
    # Sentinel cm is out of range, so the scatter drops it.
    tgt = torch.where(go & ~overflow,
                      torch.gather(slot_of_rank, 1, rank.clamp(0, 2 * n).to(torch.int64)),
                      cm)
    out_pay = torch.gather(
        payload_bank, 1,
        pay_sel.to(torch.int64).unsqueeze(-1).expand(b, 2 * n + 1, payload_bank.shape[2]))
    queue = Queue(
        valid=scatter_set(queue_valid, tgt, True),
        time=scatter_set(st.queue.time, tgt, arrive),
        kind=scatter_set(st.queue.kind, tgt, kinds),
        stamp=scatter_set(st.queue.stamp, tgt, stamps),
        sender=scatter_set(st.queue.sender, tgt, a.unsqueeze(-1).expand(b, 2 * n + 1)),
        receiver=scatter_set(st.queue.receiver, tgt, recvs),
        payload=scatter_set(st.queue.payload, tgt, out_pay),
    )

    # ---- Timer reschedule (process_node_actions): sat_add keeps
    # next_sched + startup from wrapping, also for negative local times.
    m_node = onehot(st.timer_time, a, when=do_update)
    next_g = sat_add(actions.next_sched, take(st.startup, a))
    new_timer = torch.maximum(next_g, clock + 1)
    timer_time = put(m_node, st.timer_time, new_timer)
    timer_stamp = put(m_node, st.timer_stamp, timer_stamp_new)

    # ---- Round-switch trace: the handled node entered a higher round.
    switched_r = do_update & (pm_f.active_round > pm_a.active_round)
    trace_count = st.trace_count + switched_r.to(I32)
    if p.trace_cap > 0:
        tpos = torch.remainder(st.trace_count, p.trace_cap)
        m_tr = onehot(st.trace_node, tpos, when=switched_r)
        trace_node = put(m_tr, st.trace_node, a)
        trace_round = put(m_tr, st.trace_round, pm_f.active_round)
        trace_time = put(m_tr, st.trace_time, clock)
    else:
        trace_node, trace_round, trace_time = st.trace_node, st.trace_round, st.trace_time

    planes = {}
    if p.watchdog:
        planes["wd"] = _watchdog_step(p, st, a, live, switched_r, queue.valid, cx_a, cx_f)
    if p.telemetry:
        planes["metrics"], planes["flight"] = _telemetry_step(
            p, st, a, kind, clock, live, is_timer, is_notify, is_request, is_response,
            switched_r, dropped, overflow, queue, pm_a, pm_f, s_f, cx_a, cx_f)

    m_a = onehot(st.timer_time, a)
    sent = torch.where(live, (go & ~overflow).sum(dim=1, dtype=I32), 0)
    return st.replace(
        **planes,
        store=_node_write(st.store, s_a, s_f, m_a),
        pm=_node_write(st.pm, pm_a, pm_f, m_a),
        node=_node_write(st.node, nx_a, nx_f, m_a),
        ctx=_node_write(st.ctx, cx_a, cx_f, m_a),
        queue=queue,
        ho_pay=ho_pay,
        ho_epoch=ho_epoch,
        timer_time=timer_time,
        timer_stamp=timer_stamp,
        clock=torch.where(live, clock, st.clock),
        stamp_ctr=st.stamp_ctr + torch.where(live, total_consumed, 0),
        halted=halt,
        n_events=st.n_events + live.to(I32),
        n_msgs_sent=st.n_msgs_sent + sent,
        n_msgs_dropped=st.n_msgs_dropped + torch.where(
            live, dropped.sum(dim=1, dtype=I32), 0),
        n_queue_full=st.n_queue_full + torch.where(
            live, overflow.sum(dim=1, dtype=I32), 0),
        trace_node=trace_node,
        trace_round=trace_round,
        trace_time=trace_time,
        trace_count=trace_count,
    )


def newest_commit(p: SimParams, cx):
    """Per row of ``cx`` (one node per row): the (depth, tag, round) of the
    newest committed entry, the round of the one before it, and whether
    the two lie in one epoch (rounds restart at an epoch switch)."""
    pos = torch.remainder((cx.commit_count - 1).clamp(min=0), p.commit_log)
    pos2 = torch.remainder((cx.commit_count - 2).clamp(min=0), p.commit_log)
    d_new = take(cx.log_depth, pos)
    cpe = p.commands_per_epoch
    same_epoch = (torch.div(d_new, cpe, rounding_mode="floor")
                  == torch.div(take(cx.log_depth, pos2), cpe, rounding_mode="floor"))
    return (d_new, take(cx.log_tag, pos), take(cx.log_round, pos),
            take(cx.log_round, pos2), same_epoch)


def _watchdog_step(p: SimParams, st: SimState, a, live, switched, queue_valid, cx_a, cx_f):
    """The consensus watchdog's update for one event of every instance
    (telemetry/stream.py WD_SLOTS): the liveness stall (events since the
    handled node last advanced a round, one trip per threshold crossing),
    queue saturation after this step's writes, the handled node's sync
    jumps, and, at a commit, a round regression inside its own committed
    chain and a conflicting entry at the same depth in another node's log
    (the other nodes' rows are untouched by this event, so ``st.ctx`` is
    current for them)."""
    wd = st.wd
    T = p.watchdog_stall_events
    stall_ev0 = wd[:, tstream.WD_STALL_EV]
    stall_ev = torch.where(switched, 0, stall_ev0 + live.to(I32))
    stall_trip = (stall_ev0 < T) & (stall_ev >= T)
    qsat = live & (queue_valid.sum(dim=1, dtype=I32) >= p.queue_cap)
    sj_inc = torch.where(live, cx_f.sync_jumps - cx_a.sync_jumps, 0)
    committed = live & (cx_f.commit_count > cx_a.commit_count)
    d_new, t_new, r_new, r_prev, same_epoch = newest_commit(p, cx_f)
    regress = committed & (cx_f.commit_count >= 2) & same_epoch & (r_new <= r_prev)
    h = p.commit_log
    ctx = st.ctx
    entry_ok = arange(h, a.device) < ctx.commit_count.clamp(max=h).unsqueeze(-1)
    others = arange(p.n_nodes, a.device) != a.unsqueeze(-1)
    conflict = committed & (
        others.unsqueeze(-1) & entry_ok
        & (ctx.log_depth == d_new.reshape(-1, 1, 1))
        & (ctx.log_tag != t_new.reshape(-1, 1, 1))).flatten(1).any(dim=1)
    return torch.stack([
        stall_ev,
        wd[:, tstream.WD_STALL] + stall_trip.to(I32),
        wd[:, tstream.WD_QUEUE_SAT] + qsat.to(I32),
        wd[:, tstream.WD_SYNC_JUMP] + sj_inc,
        wd[:, tstream.WD_SAFETY_CONFLICT] + conflict.to(I32),
        wd[:, tstream.WD_ROUND_REGRESS] + regress.to(I32),
    ], dim=1).to(I32)


def _telemetry_step(p: SimParams, st: SimState, a, kind, clock, live, is_timer,
                    is_notify, is_request, is_response, switched, dropped, overflow,
                    queue, pm_a, pm_f, s_f, cx_a, cx_f):
    """The metrics plane and flight recorder for one event of every
    instance (telemetry/plane.py): event-kind counts, losses, sync jumps,
    post-write queue high-water marks, the round-dwell and proposal-to-commit
    latency histograms, and one flight row per live event at ring position
    ``fr_count % flight_cap``.  Returns (metrics, flight)."""
    n = p.n_nodes
    m = st.metrics
    m = tplane.bump(p, m, "ev_notify", when=is_notify)
    m = tplane.bump(p, m, "ev_request", when=is_request)
    m = tplane.bump(p, m, "ev_response", when=is_response)
    m = tplane.bump(p, m, "ev_timer", when=live & is_timer)
    m = tplane.bump(p, m, "drops", dropped.sum(dim=1, dtype=I32), when=live)
    m = tplane.bump(p, m, "overflow", overflow.sum(dim=1, dtype=I32), when=live)
    m = tplane.bump(p, m, "sync_jumps", cx_f.sync_jumps - cx_a.sync_jumps, when=live)
    # Queue pressure after this step's writes.
    depth_n = (queue.valid.unsqueeze(-1)
               & (queue.receiver.unsqueeze(-1) == arange(n, a.device))).sum(dim=1, dtype=I32)
    qtot = queue.valid.sum(dim=1, dtype=I32)
    m = tplane.region_max(p, m, "node_depth_hwm", depth_n)
    m = tplane.region_max(p, m, "queue_hwm", qtot)
    # Round-switch latency: local-clock dwell in the round just left.
    rlat = (pm_f.round_start - pm_a.round_start).clamp(min=0)
    m = tplane.bump_hist(p, m, "round_lat_hist", rlat.unsqueeze(1), switched.unsqueeze(1))
    # Proposal -> commit latency of the newest committed entry (global time).
    committed = live & (cx_f.commit_count > cx_a.commit_count)
    cfound, clat = tplane.commit_latency(p, s_f, cx_f, st.startup, clock)
    m = tplane.bump_hist(p, m, "commit_lat_hist", clat.unsqueeze(1),
                         (committed & cfound).unsqueeze(1))
    m = tplane.bump(p, m, "commit_lat_miss", when=committed & ~cfound)
    # Flight recorder: one row per live event.
    frc = tplane.read(p, m, "fr_count")
    row = torch.stack([kind.to(I32), a.to(I32), clock.to(I32),
                       s_f.current_round.to(I32), qtot], dim=1)
    flight = wset(st.flight, torch.remainder(frc, p.flight_cap), row, when=live)
    m = tplane.bump(p, m, "fr_count", when=live)
    return m, flight


def byz_rows(p: SimParams, st) -> torch.Tensor:
    """``[B, 2]`` bool: per instance of a SimState, a PSimState or a
    ``serve.scenario.ScenarioPlane``, whether it can equivocate (column 0)
    or forge a QC (column 1) during a run, by a static mask or by a window
    of its attack schedule (a window row with ``hi > lo`` and that
    behavior).  No host read."""
    eq, forge = st.byz_equivocate.any(dim=-1), st.byz_forge_qc.any(dim=-1)
    if p.adversary:
        sched = st.adv_sched
        live = sched[..., aplane.F_HI] > sched[..., aplane.F_LO]
        beh = sched[..., aplane.F_BEH]
        eq = eq | (live & (beh == aplane.BEH_EQUIVOCATE)).any(dim=-1)
        forge = forge | (live & (beh == aplane.BEH_FORGE_QC)).any(dim=-1)
    return torch.stack([eq, forge], dim=-1)


def byz_flags(p: SimParams, st):
    """(any_equivocate, any_forge): whether some instance can equivocate or
    forge a QC during a run (:func:`byz_rows`).  Both are constant over a
    run: one host read."""
    eq, forge = byz_rows(p, st).any(dim=0).tolist()
    return eq, forge


def select_instances(st, idx):
    """The instances ``idx`` of a batched SimState or PSimState, as copies
    (e.g. to compare a few instances of a card run with a CPU run; a lane
    state's inbox leaves lose their routing pad, so the copy is for reading
    only)."""
    idx = torch.as_tensor(np.asarray(idx), device=st.clock.device)
    return tree_map(lambda x: x.index_select(0, idx), st)


def tables(p: SimParams, device):
    """The delay quantile table and round-duration table on ``device``."""
    return (torch.as_tensor(p.delay_table(), device=device),
            torch.as_tensor(p.duration_table(), device=device))


def macro_k_of(p: SimParams) -> int:
    """The macro-step width (``SimParams.macro_k``; 1 when unset)."""
    return int(p.macro_k) if p.macro_k is not None else 1


def macro_step(p: SimParams, delay_table, dur_table, st: SimState,
               any_equivocate: bool = True, any_forge: bool = True) -> SimState:
    """One dispatched unit of work: ``macro_k`` calls of :func:`step`.
    Halted instances and drained queues make the extra calls exact no-ops
    (every write of ``step`` is gated on ``live``), so a chunk of K-event
    macro-steps equals K times as many single steps, leaf for leaf."""
    for _ in range(macro_k_of(p)):
        st = step(p, delay_table, dur_table, st, any_equivocate, any_forge)
    return st


def make_scan_fn(p: SimParams, num_steps: int, st: SimState, flags=None):
    """The chunk runner, ``st -> st``: ``num_steps`` macro-steps
    (``num_steps * macro_k`` events) per instance, with the tables on the
    device of ``st`` and the Byzantine skip flags ``flags`` (default: read
    from ``st``, one host read, here; constant over a run).
    ``run_to_completion``, its stream loop, the sharded runtime and the
    resident service all run chunks through it."""
    p = resolve_params(p)
    delay_table, dur_table = tables(p, st.clock.device)
    flags = byz_flags(p, st) if flags is None else tuple(flags)

    def run(s):
        for _ in range(num_steps):
            s = macro_step(p, delay_table, dur_table, s, *flags)
        return s

    return run


def stream_completion(run, p: SimParams, st, chunk: int, max_chunks: int, stream,
                      events_per_step: int = 1):
    """The digest-poll host loop both engines' ``run_to_completion(stream=)``
    share: ``run`` is a chunk runner (``make_scan_fn``); after each chunk the
    ``[13]`` digest (telemetry/stream.py) is computed on the device and
    fetched, once, and the halt check reads its slot 0, never the ``[B]``
    halted plane.  Every digest goes to ``stream``, whose ``steps`` are the
    event steps (windows) run per instance: ``(i + 1) * chunk *
    events_per_step``, where ``events_per_step`` is the serial engine's
    ``macro_k``.  Returns (state, chunks run)."""
    b_total = st.clock.shape[0]
    lg = tledger.get()
    rid = lg.new_run("stream_completion", chunk_steps=chunk)
    chunks = 0
    for i in range(max_chunks):
        with lg.span(tledger.DISPATCH, run=rid, chunk=i):
            st = run(st)
            dg = tstream.compute_digest(p, st)
        with lg.span(tledger.POLL, run=rid, chunk=i):
            fetched = dg.cpu().numpy()
        chunks += 1
        d = stream.record(fetched, steps=(i + 1) * chunk * events_per_step)
        if d["halted"] >= b_total:
            break
    return st, chunks


def halt_completion(run, st, chunk: int, max_chunks: int, engine: str):
    """The plain host loop both engines' ``run_to_completion`` share: one
    read of ``halted.all()`` after each chunk of ``run``.  Returns (state,
    chunks run)."""
    lg = tledger.get()
    rid = lg.new_run("run_to_completion", engine=engine, chunk_steps=chunk)
    chunks = 0
    for i in range(max_chunks):
        with lg.span(tledger.DISPATCH, run=rid, chunk=i):
            st = run(st)
        with lg.span(tledger.POLL, run=rid, chunk=i):
            halted = bool(st.halted.all())
        chunks += 1
        if halted:
            break
    return st, chunks


@torch.inference_mode()
def run_to_completion(p: SimParams, st: SimState, chunk: int = RUN_CHUNK,
                      max_chunks: int = RUN_MAX_CHUNKS, batched: bool = False,
                      stream=None):
    """Host loop: run until every instance passes max_clock, ``chunk``
    macro-steps (``chunk * macro_k`` events) per instance between reads of
    ``halted`` (one host sync per chunk).  ``stream`` (a
    telemetry/stream.TimelineRecorder) switches the loop to the digest
    contract of :func:`stream_completion`.  ``batched`` is accepted for the
    JAX signature; the port's state always carries the batch dim.  Returns
    the final state; the number of event steps taken is
    ``run_to_completion.last_steps``."""
    del batched
    p = resolve_params(p)
    run = make_scan_fn(p, chunk, st)
    k = macro_k_of(p)
    if stream is not None:
        st, chunks = stream_completion(run, p, st, chunk, max_chunks, stream, k)
    else:
        st, chunks = halt_completion(run, st, chunk, max_chunks, "serial")
    run_to_completion.last_steps = chunks * chunk * k
    return st


run_to_completion.last_steps = 0
