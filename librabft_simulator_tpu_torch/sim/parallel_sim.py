"""Lane-compacted conservative-window engine: the port of
``librabft_simulator_tpu/sim/parallel_sim.py`` (its unpacked layout; the
packed ``[N, S]`` plane is a TPU lowering choice with no port).

Each window of every instance of a ``[B]`` batch: find the earliest pending
event of each node, set the global horizon ``hz = t_min + d_min`` (every
message takes at least ``d_min``, so nothing below ``hz`` can depend on work
done in the window), gather the ``A = lanes_of(p)`` earliest qualifying
nodes onto lanes (stable argsort, ties by node index), let each lane drain
up to ``K = drain_of(p)`` of its own events below ``hz``, scatter the lanes
back, and route every message the window sent into per-receiver inboxes
``[N, IC]`` (overflow is counted, as in the JAX engine).

Lanes are rows: the ``B x A`` lanes of a window form one ``[B*A]`` batch
for the protocol layers (``sim/simulator.py::handle_events``), with the
instance's weights repeated per lane and the lane's node as the author.
Each drain iteration selects its lanes' events through
``ops/select_events.py::select_queue_events`` on ``[B*A, IC]`` inbox rows
with one timer column, so a window launches the select kernel ``K`` times
on the card.

Memory: the inbox payloads ``[B, N, IC, F]`` are most of the state (26 GB
at BASELINE config #3, 35 GB at config #5), so nothing copies them.  The
inbox leaves are views of buffers that own ``ROUTE_PAD`` spare rows after
them; routing writes the placed messages in place and sends every other
candidate to a spare row (the JAX engine drops those writes).  A drain
iteration reads its lanes' payload rows straight from the inbox, and the
routed payload rows are built one drain iteration at a time.  ``step``
therefore updates the inbox leaves of the state it is given, as the JAX
engine donates its state buffers.

On the CPU, a drain iteration in which no lane of any instance is active
ends the window's drain (nothing would change in it or after it); on the
card all ``K`` iterations are queued without a host sync.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import (
    ADV_FIELDS,
    FR_COLS,
    KIND_NOTIFY,
    KIND_REQUEST,
    KIND_RESPONSE,
    KIND_TIMER,
    NEVER,
    Array,
    Context,
    NodeExtra,
    Pacemaker,
    SimParams,
    Store,
    Tree,
    payload_width,
    sat_add,
    tree_fields,
    tree_map,
    unpack_payload,
)
from ..ops.select_events import select_queue_events
from ..utils import hashing as H
from ..utils.quantile import TABLE_BITS
from ..utils.xops import arange, const, needed, scatter_set, zeros
from . import simulator as S

I32 = torch.int32
I64 = torch.int64

#: Spare rows after each inbox buffer.  A routed candidate that is not placed
#: is written to spare row ``(its index) % ROUTE_PAD``, so that millions of
#: such writes do not all land on one address.
ROUTE_PAD = 4096

#: Host-loop budget: windows between reads of ``halted`` x chunk cap.  The
#: cap is the JAX engine's (256 x 400 = 102,400 windows); the chunk is
#: shorter because an eager window on the card takes 0.1-4 s (PERF.md), so a
#: halt read per 4 windows costs nothing and wastes at most 3 windows.
RUN_CHUNK = 4
RUN_MAX_CHUNKS = 25600


@dataclasses.dataclass
class PSimState(Tree):
    """A batch of instances under the lane engine; leaf names, order and
    shapes are the JAX ``PSimState``'s with ``[B]`` in front.  The inbox
    leaves (``in_*``) are views of padded routing buffers (see
    :func:`inbox_buffer`)."""

    store: Store
    pm: Pacemaker
    node: NodeExtra
    ctx: Context
    byz_forge_qc: Array   # [N] bool
    max_clock: Array
    drop_u32: Array       # uint32 drop threshold
    ho_pay: Array         # [N, E, F]
    ho_epoch: Array       # [N, E]; -1 = none
    in_valid: Array       # [N, IC] bool
    in_time: Array        # [N, IC]
    in_kind: Array        # [N, IC]
    in_stamp: Array       # [N, IC]
    in_sender: Array      # [N, IC]
    in_pay: Array         # [N, IC, F] packed payloads
    timer_time: Array     # [N]
    startup: Array        # [N]
    weights: Array        # [N]
    byz_equivocate: Array
    byz_silent: Array
    clock: Array
    node_ctr: Array       # [N] per-node stamp/rng counters
    halted: Array
    seed: Array           # uint32 instance seed
    n_events: Array
    n_msgs_sent: Array
    n_msgs_dropped: Array
    n_inbox_full: Array
    trace_node: Array     # [T]
    trace_round: Array
    trace_time: Array
    trace_count: Array
    metrics: Array        # [0] (telemetry slice)
    flight: Array         # [0, FR_COLS]
    wd: Array             # [0] (watchdog slice)
    sc_delay: Array       # [0] (scenario slice)
    sc_commit: Array
    adv_sched: Array      # [0, ADV_FIELDS] (adversary slice)
    adv_link: Array
    adv_group: Array
    adv_heal: Array

    U32 = frozenset({"seed", "drop_u32"})


INBOX = ("in_valid", "in_time", "in_kind", "in_stamp", "in_sender", "in_pay")


def d_min_of(p: SimParams) -> int:
    """Network lookahead: the minimum message latency (>= 1)."""
    return max(int(np.min(p.delay_table())), 1)


def inbox_cap(p: SimParams) -> int:
    """Per-receiver inbox slots: ``SimParams.inbox_cap`` if set, else 4 per
    peer (at least 16)."""
    return p.inbox_cap if p.inbox_cap > 0 else max(16, 4 * p.n_nodes)


def lanes_of(p: SimParams) -> int:
    """Active lanes per window: ``SimParams.active_lanes`` if set, else
    min(n, max(8, n/4))."""
    if p.active_lanes > 0:
        return min(p.n_nodes, p.active_lanes)
    return min(p.n_nodes, max(8, p.n_nodes // 4))


def drain_of(p: SimParams) -> int:
    """Events each lane may drain per window (its node's chain, in order)."""
    return p.drain_k if p.drain_k > 0 else (4 if p.n_nodes <= 16 else 8)


def check_slice(p: SimParams):
    """Raise for what the lane engine does not run: the serial engine's
    knobs, and the planes of later slices of the port."""
    if (p.macro_k or 1) > 1:
        raise ValueError(
            f"SimParams.macro_k={p.macro_k} is a serial-engine knob; the lane "
            "engine's horizon windows already batch events per dispatch - run "
            "the serial engine, or set macro_k=None for lane runs")
    if p.shuffle_receivers:
        raise NotImplementedError(
            "SimParams.shuffle_receivers is a parity-trio semantic "
            "(serial/oracle/C++); the lane engine delivers in index order - "
            "use the serial engine for shuffle fuzzing")
    S.check_slice(p)


def inbox_buffer(shape, dtype, device, values=None) -> torch.Tensor:
    """A ``[B, N, IC(, F)]`` inbox leaf (zeros, or a copy of ``values``) as a
    view of the first rows of a buffer with ``ROUTE_PAD`` spare rows after
    them."""
    rows = shape[0] * shape[1] * shape[2]
    buf = torch.zeros((rows + ROUTE_PAD,) + tuple(shape[3:]), dtype=dtype,
                      device=device)
    out = buf[:rows].view(tuple(shape))
    if values is not None:
        out.copy_(values)
    return out


def _routing_view(x: torch.Tensor) -> torch.Tensor:
    """The flat ``[B*N*IC + ROUTE_PAD, ...]`` buffer behind inbox leaf ``x``."""
    rows = x.shape[0] * x.shape[1] * x.shape[2]
    tail = tuple(x.shape[3:])
    inner = int(np.prod(tail)) if tail else 1
    need = (x.storage_offset() + (rows + ROUTE_PAD) * inner) * x.element_size()
    if not x.is_contiguous() or x.untyped_storage().nbytes() < need:
        raise ValueError(
            "inbox leaves must come from init_batch or inbox_buffer (a buffer "
            "with the routing pad after it)")
    return x.as_strided((rows + ROUTE_PAD,) + tail,
                        (inner,) + ((1,) * len(tail)), x.storage_offset())


def init_batch(p: SimParams, seeds, weights=None, byz_equivocate=None,
               byz_silent=None, byz_forge_qc=None, device="cuda") -> PSimState:
    """``init_state`` for a batch of instance seeds: per-node random startup
    times, timers at startup, empty inboxes.  ``weights`` and the ``byz_*``
    masks are ``[N]`` (shared) or ``[B, N]`` (per instance)."""
    check_slice(p)
    seeds = S._u32_to_i32(np.asarray(seeds).reshape(-1))
    b, n = seeds.shape[0], p.n_nodes
    ic, f = inbox_cap(p), payload_width(p)
    device = torch.device(device)
    seed = torch.as_tensor(seeds.copy(), device=device)
    delay_table = torch.as_tensor(p.delay_table(), device=device)
    draws = H.rng_u32(seed.unsqueeze(-1), arange(n, device))
    startup = delay_table[H.as_u32(draws) >> (32 - TABLE_BITS)] + 1
    e = p.handoff_epochs if p.epoch_handoff else 0

    def full(shape, value, dtype=I32):
        return torch.full(shape, value, dtype=dtype, device=device)

    def z(*shape, dtype=I32):
        return zeros(tuple(shape), dtype, device)

    def inbox(*tail, dtype=I32):
        return inbox_buffer((b, n, ic) + tail, dtype, device)

    def mask(x, default, dtype=torch.bool):
        return S._per_instance(x, b, n, dtype, device, default)

    return PSimState(
        store=Store.initial(p, (b, n), device),
        pm=Pacemaker.initial((b, n), device),
        node=NodeExtra.initial((b, n), device),
        ctx=Context.initial(p, (b, n), device),
        byz_forge_qc=mask(byz_forge_qc, False),
        max_clock=full((b,), p.max_clock),
        drop_u32=full((b,), H.to_i32(p.drop_u32)),
        ho_pay=z(b, n, e, f),
        ho_epoch=full((b, n, e), -1),
        in_valid=inbox(dtype=torch.bool), in_time=inbox(), in_kind=inbox(),
        in_stamp=inbox(), in_sender=inbox(), in_pay=inbox(f),
        timer_time=startup,
        startup=startup,
        weights=mask(weights, 1, I32),
        byz_equivocate=mask(byz_equivocate, False),
        byz_silent=mask(byz_silent, False),
        clock=z(b),
        node_ctr=full((b, n), 1),
        halted=z(b, dtype=torch.bool),
        seed=seed,
        n_events=z(b), n_msgs_sent=z(b), n_msgs_dropped=z(b), n_inbox_full=z(b),
        trace_node=z(b, p.trace_cap), trace_round=z(b, p.trace_cap),
        trace_time=z(b, p.trace_cap), trace_count=z(b),
        metrics=z(b, 0), flight=z(b, 0, FR_COLS), wd=z(b, 0),
        sc_delay=z(b, 0), sc_commit=z(b, 0),
        adv_sched=z(b, 0, ADV_FIELDS), adv_link=z(b, 0, 0), adv_group=z(b, 0),
        adv_heal=z(b, 0),
    )


def init_state(p: SimParams, seed: int, weights=None, byz_equivocate=None,
               byz_silent=None, byz_forge_qc=None, device="cuda") -> PSimState:
    """One instance: a batch of one."""
    return init_batch(p, [seed], weights=weights, byz_equivocate=byz_equivocate,
                      byz_silent=byz_silent, byz_forge_qc=byz_forge_qc,
                      device=device)


def _earliest(in_valid, in_time, in_kind, in_stamp, timer_time):
    """Per row: the earliest pending event by (time, kind desc, stamp) over
    the valid inbox slots and one timer (the JAX function, operation for
    operation; the plain version of :func:`earliest`).

    Returns (time, kind, slot, is_timer); slot is -1 for a timer, which wins
    at equal time because messages have kinds 0-2."""
    msg_time = torch.where(in_valid, in_time, NEVER)
    t_best = torch.minimum(msg_time.min(dim=1).values, timer_time)
    m1 = msg_time == t_best.unsqueeze(1)
    k_msg = torch.where(m1, in_kind, -1).max(dim=1).values
    timer_due = timer_time == t_best
    k_best = torch.maximum(k_msg, torch.where(timer_due, KIND_TIMER, -1).to(I32))
    m2 = m1 & (in_kind == k_best.unsqueeze(1))
    s_best = torch.where(m2, in_stamp, NEVER).min(dim=1).values
    is_timer = timer_due & (k_best == KIND_TIMER)
    slot = (m2 & (in_stamp == s_best.unsqueeze(1))).to(I32).argmax(dim=1).to(I32)
    slot = torch.where(is_timer, -1, slot)
    return t_best, k_best, slot, is_timer


def earliest(in_valid, in_time, in_kind, in_stamp, timer_time):
    """:func:`_earliest` through the select kernel: ``[R, IC]`` inbox rows
    and one timer column of kind ``KIND_TIMER``; column ``IC`` is the timer."""
    rows, ic = in_valid.shape
    idx, t_best = select_queue_events(
        in_valid, in_time, in_kind, in_stamp, timer_time.unsqueeze(1),
        const((rows, 1), 0, I32, in_valid.device), KIND_TIMER)
    is_timer = idx >= ic
    slot = torch.where(is_timer, -1, idx)
    kind = torch.where(
        is_timer, KIND_TIMER,
        in_kind.gather(1, slot.clamp(min=0).to(I64).unsqueeze(1)).squeeze(1))
    return t_best, kind, slot, is_timer


def _tree_put(tree, gathered, new, put):
    """Write the lanes' rows of every leaf the window changed (leaves still
    the gathered tensor are left as they are)."""
    kw = {}
    for f in tree_fields(tree):
        v = getattr(new, f)
        if v is not getattr(gathered, f):
            kw[f] = put(getattr(tree, f), v)
    return tree.replace(**kw) if kw else tree


def step(p: SimParams, delay_table, dur_table, d_min: int, st: PSimState,
         any_equivocate: bool = True, any_forge: bool = True) -> PSimState:
    """One window of every instance: compact the A earliest qualifying nodes
    onto lanes, drain up to K events per lane, then route every message the
    window sent.  ``any_equivocate`` / ``any_forge`` may be False when no
    instance carries that Byzantine mask."""
    n, ic, F = p.n_nodes, inbox_cap(p), payload_width(p)
    A, K, nc = lanes_of(p), drain_of(p), 2 * p.n_nodes + 1
    b = st.clock.shape[0]
    rows = b * A
    dev = st.clock.device
    nodes = arange(n, dev)

    # ---- Window bookkeeping: per-node earliest times, the global horizon.
    msg_time = torch.where(st.in_valid, st.in_time, NEVER)
    t_ev = torch.minimum(msg_time.min(dim=2).values, st.timer_time)   # [B, N]
    t_min = t_ev.min(dim=1).values
    halt = st.halted | (t_min > st.max_clock)
    live = ~halt
    clock = torch.maximum(st.clock, t_min.clamp(max=NEVER - 1))
    hz = t_min.clamp(max=NEVER - d_min) + d_min
    qualify = live.unsqueeze(1) & (t_ev < hz.unsqueeze(1)) & (
        t_ev <= st.max_clock.unsqueeze(1))

    # ---- Lane compaction: the A earliest qualifying nodes, ties by index.
    sel = torch.argsort(torch.where(qualify, t_ev, NEVER), dim=1, stable=True)[:, :A]
    li = (arange(b, dev).unsqueeze(1) * n + sel).reshape(-1)   # rows of [B*N]
    author = sel.reshape(-1).to(I32)

    def lanes(x):
        return x.reshape((b * n,) + tuple(x.shape[2:])).index_select(0, li)

    def per_lane(x):
        return x.repeat_interleave(A, dim=0)

    def put(x, v):
        flat = x.reshape((b * n,) + tuple(x.shape[2:]))
        return flat.index_copy(0, li, v.to(x.dtype)).view(x.shape)

    lane_on = qualify.gather(1, sel).reshape(-1)
    lane_startup = lanes(st.startup)
    l_sil, l_eq, l_forge = lanes(st.byz_silent), lanes(st.byz_equivocate), lanes(st.byz_forge_qc)
    hz_l, maxc_l = per_lane(hz), per_lane(st.max_clock)
    seed_l, drop_l = per_lane(st.seed).unsqueeze(1), H.as_u32(per_lane(st.drop_u32)).unsqueeze(1)
    weights_l = per_lane(st.weights)
    others = nodes != author.unsqueeze(1)
    # Loop constants: a drain only clears in_valid; the times, kinds, stamps,
    # senders and payloads of queued messages do not change in a window.
    g_it, g_ik, g_is, g_isnd = (lanes(st.in_time), lanes(st.in_kind),
                                lanes(st.in_stamp), lanes(st.in_sender))
    pay_base = li * ic
    in_pay = st.in_pay.reshape(b * n * ic, F)
    l_store, l_pm, l_nx, l_cx = (tree_map(lanes, st.store), tree_map(lanes, st.pm),
                                 tree_map(lanes, st.node), tree_map(lanes, st.ctx))
    g_store, g_pm, g_nx, g_cx = l_store, l_pm, l_nx, l_cx
    g_iv, g_timer, g_ctr = lanes(st.in_valid), lanes(st.timer_time), lanes(st.node_ctr)
    if p.epoch_handoff:
        g_hop, g_hoe = lanes(st.ho_pay), lanes(st.ho_epoch)
    else:
        g_hop = g_hoe = None
    ev_n = drop_n = zeros((b,), I32, dev)
    tr_n, tr_r, tr_t, tr_c = st.trace_node, st.trace_round, st.trace_time, st.trace_count
    later = arange(nc, dev) > 0
    upper = nodes * 2 >= n
    node_row = nodes.to(I32).expand(rows, n)
    kinds_rest = torch.cat([const((rows, n), KIND_NOTIFY, I32, dev),
                            const((rows, n), KIND_REQUEST, I32, dev)], dim=1)
    lane_rows = arange(rows, dev)

    ys = []
    for _ in range(K):
        t_l, k_l, slot_l, is_tm = earliest(g_iv, g_it, g_ik, g_is, g_timer)
        act = lane_on & (t_l < hz_l) & (t_l <= maxc_l)
        if not needed(act):
            break   # no lane of any instance has work left in this window
        slot_c = slot_l.clamp(min=0).to(I64)
        pay_in = unpack_payload(p, in_pay.index_select(0, pay_base + slot_c))
        sender = g_isnd.gather(1, slot_c.unsqueeze(1)).squeeze(1)
        consume = act & ~is_tm
        g_iv[lane_rows, slot_c] &= ~consume   # g_iv is the window's own copy

        is_notify = consume & (k_l == KIND_NOTIFY)
        is_request = consume & (k_l == KIND_REQUEST)
        is_response = consume & (k_l == KIND_RESPONSE)
        do_update = act & (is_tm | is_notify | is_response)
        pre_round = g_pm.active_round
        (g_store, g_pm, g_nx, g_cx, actions, should_sync, bank, g_hop,
         g_hoe) = S.handle_events(
            p, dur_table, g_store, g_pm, g_nx, g_cx, weights_l, author,
            t_l - lane_startup, pay_in, is_notify, is_request, is_response,
            do_update, l_forge, l_sil, g_hop, g_hoe, any_equivocate, any_forge)

        # ---- Outgoing candidates: [lanes, 2n+1].
        want_response = is_request & ~l_sil
        cand0_want = (is_notify & should_sync & ~l_sil) | want_response
        speak = do_update & ~l_sil
        send_mask = actions.send_mask & others & speak.unsqueeze(1)
        query_mask = others & (actions.should_query_all & speak).unsqueeze(1)
        want = torch.cat([cand0_want.unsqueeze(1), send_mask, query_mask], dim=1)
        kinds = torch.cat([torch.where(want_response, KIND_RESPONSE, KIND_REQUEST)
                           .to(I32).unsqueeze(1), kinds_rest], dim=1)
        recvs = torch.cat([sender.clamp(0, n - 1).unsqueeze(1), node_row, node_row], dim=1)
        pay_sel = torch.cat([torch.where(want_response, 3, 2).to(I32).unsqueeze(1),
                             (l_eq.unsqueeze(1) & upper).to(I32),
                             const((rows, n), 2, I32, dev)], dim=1)

        # Node-local stamps (ctr * N + node): disjoint across nodes, so the
        # draws do not depend on how windows interleave.
        pos = torch.cumsum(want, dim=1, dtype=I32) - 1
        timer_gap = do_update.to(I32)
        stamps = ((g_ctr.unsqueeze(1) + pos + later * timer_gap.unsqueeze(1)) * n
                  + author.unsqueeze(1)).to(I32)
        g_ctr = g_ctr + torch.where(act, want.sum(dim=1, dtype=I32) + timer_gap, 0)
        u_delay, u_drop = H.rng_u32_pair(seed_l, stamps)
        delays = delay_table[H.as_u32(u_delay) >> (32 - TABLE_BITS)].clamp(min=d_min)
        dropped = want & (H.as_u32(u_drop) < drop_l)
        arrive = t_l.unsqueeze(1) + delays
        go = want & ~dropped

        # ---- Timer reschedule (sat_add: see types.sat_add).
        next_g = sat_add(actions.next_sched, lane_startup)
        g_timer = torch.where(do_update, torch.maximum(next_g, t_l + 1), g_timer)
        ev_n = ev_n + act.view(b, A).sum(dim=1, dtype=I32)
        drop_n = drop_n + dropped.view(b, A * nc).sum(dim=1, dtype=I32)

        # ---- Round-switch trace: ring append in lane order.
        switched = (do_update & (g_pm.active_round > pre_round)).view(b, A)
        if p.trace_cap > 0:
            tpos = torch.where(
                switched,
                torch.remainder(tr_c.unsqueeze(1)
                                + torch.cumsum(switched, dim=1, dtype=I32) - 1,
                                p.trace_cap),
                p.trace_cap)
            tr_n = scatter_set(tr_n, tpos, author.view(b, A))
            tr_r = scatter_set(tr_r, tpos, g_pm.active_round.view(b, A))
            tr_t = scatter_set(tr_t, tpos, t_l.view(b, A))
        tr_c = tr_c + switched.sum(dim=1, dtype=I32)
        ys.append((go, kinds, recvs, stamps, arrive, pay_sel, bank))

    out = dict(clock=torch.where(live, clock, st.clock), halted=halt)
    if not ys:
        return st.replace(**out)

    # ---- Scatter lane state back (lanes are distinct nodes; rows the window
    # left untouched write back their own values).
    st.in_valid.view(b * n, ic).index_copy_(0, li, g_iv)
    out.update(
        store=_tree_put(st.store, l_store, g_store, put),
        pm=_tree_put(st.pm, l_pm, g_pm, put),
        node=_tree_put(st.node, l_nx, g_nx, put),
        ctx=_tree_put(st.ctx, l_cx, g_cx, put),
        timer_time=put(st.timer_time, g_timer),
        node_ctr=put(st.node_ctr, g_ctr),
        trace_node=tr_n, trace_round=tr_r, trace_time=tr_t, trace_count=tr_c,
        n_events=st.n_events + torch.where(live, ev_n, 0),
        n_msgs_dropped=st.n_msgs_dropped + torch.where(live, drop_n, 0),
    )
    if p.epoch_handoff:
        out.update(ho_pay=put(st.ho_pay, g_hop), ho_epoch=put(st.ho_epoch, g_hoe))

    # ---- Route every candidate to its receiver's inbox.  Receiver rank
    # order: (candidate block, drain iteration, lane); under overflow it
    # decides which messages are lost.
    kd = len(ys)
    ka = kd * A

    def stacked(j):
        return torch.stack([y[j].view(b, A, nc) for y in ys], dim=1).view(b, ka, nc)

    go, recv = stacked(0), stacked(2).to(I64)
    recv0 = recv[:, :, 0].clamp(0, n - 1)
    oh0 = (recv0.unsqueeze(2) == nodes) & go[:, :, :1]            # [B, KA, n]
    cnt0 = oh0.sum(dim=1, dtype=I32)
    rank0 = (torch.cumsum(oh0, dim=1, dtype=I32) - 1).gather(2, recv0.unsqueeze(2))
    go1, go2 = go[:, :, 1:n + 1], go[:, :, n + 1:]                  # receiver = column
    cnt1 = go1.sum(dim=1, dtype=I32)
    rank1 = cnt0.unsqueeze(1) + torch.cumsum(go1, dim=1, dtype=I32) - 1
    rank2 = (cnt0 + cnt1).unsqueeze(1) + torch.cumsum(go2, dim=1, dtype=I32) - 1
    rank = torch.cat([rank0, rank1, rank2], dim=2)                 # [B, KA, nc]

    free = ~st.in_valid                                            # post-drain
    free_rank = torch.cumsum(free, dim=2, dtype=I32) - 1
    n_free = free.sum(dim=2, dtype=I32).clamp(max=ic)              # [B, N]
    # slot_of_rank[b, r, k]: the slot of receiver r's k-th free slot.
    slot_of_rank = scatter_set(
        const((b * n, ic), ic, I32, dev),
        torch.where(free, free_rank, ic).view(b * n, ic),
        arange(ic, dev).to(I32).expand(b * n, ic)).reshape(b, n * ic)
    overflow = go & (rank >= n_free.gather(1, recv.view(b, -1)).view(b, ka, nc))
    place = go & ~overflow
    slot = slot_of_rank.gather(
        1, (recv * ic + rank.clamp(0, ic - 1)).view(b, -1)).view(b, ka, nc)
    total = b * n * ic
    spare = total + torch.remainder(arange(b * ka * nc, dev), ROUTE_PAD).view(b, ka, nc)
    tgt = torch.where(place, (arange(b, dev).view(b, 1, 1) * n + recv) * ic + slot, spare)

    flat = tgt.reshape(-1)
    _routing_view(st.in_valid).index_put_((flat,), const((), True, torch.bool, dev))
    _routing_view(st.in_time).index_put_((flat,), stacked(4).reshape(-1))
    _routing_view(st.in_kind).index_put_((flat,), stacked(1).reshape(-1))
    _routing_view(st.in_stamp).index_put_((flat,), stacked(3).reshape(-1))
    senders = author.view(b, 1, A, 1).expand(b, kd, A, nc)
    _routing_view(st.in_sender).index_put_((flat,), senders.reshape(-1))
    # Payload rows, one drain iteration at a time: [B*A*nc, F] each.
    pay_buf = _routing_view(st.in_pay)
    bank_rows = lane_rows.unsqueeze(1) * 4
    for k, y in enumerate(ys):
        src = y[6].view(rows * 4, F).index_select(0, (bank_rows + y[5]).view(-1))
        pay_buf.index_put_((tgt[:, k * A:(k + 1) * A].reshape(-1),), src)

    out.update(
        n_msgs_sent=st.n_msgs_sent + torch.where(
            live, place.view(b, -1).sum(dim=1, dtype=I32), 0),
        n_inbox_full=st.n_inbox_full + torch.where(
            live, overflow.view(b, -1).sum(dim=1, dtype=I32), 0),
    )
    return st.replace(**out)


@torch.no_grad()
def run_to_completion(p: SimParams, st: PSimState, chunk: int = RUN_CHUNK,
                      max_chunks: int = RUN_MAX_CHUNKS, batched: bool = False,
                      stream=None, d_min: int | None = None) -> PSimState:
    """Host loop: windows until every instance passes max_clock, ``chunk``
    windows between reads of ``halted``.  ``d_min`` overrides the lookahead
    (1 <= d_min <= d_min_of(p)); absent inbox overflow the trajectory does
    not depend on it, nor on ``active_lanes`` / ``drain_k``.  The number of
    windows taken is ``run_to_completion.last_steps``."""
    del batched
    if stream is not None:
        raise NotImplementedError(
            "run_to_completion(stream=) is not ported yet; it lands with the "
            "telemetry-plane slice")
    check_slice(p)
    dmin = d_min_of(p) if d_min is None else int(d_min)
    if not 1 <= dmin <= d_min_of(p):
        raise ValueError(f"d_min={dmin} must lie in [1, {d_min_of(p)}]")
    delay_table, dur_table = S.tables(p, st.clock.device)
    any_eq = bool(st.byz_equivocate.any())
    any_forge = bool(st.byz_forge_qc.any())
    windows = 0
    for _ in range(max_chunks):
        for _ in range(chunk):
            st = step(p, delay_table, dur_table, dmin, st, any_eq, any_forge)
        windows += chunk
        if bool(st.halted.all()):
            break
    run_to_completion.last_steps = windows
    return st


run_to_completion.last_steps = 0
