"""Pacemaker: round synchronization, leader election, timeouts, query-all.
The port of ``librabft_simulator_tpu/core/pacemaker.py``.

Round durations (delta * n^gamma) come from a host-precomputed integer
table; the query-all period (lambda * duration) uses 16.16 fixed point, so
every decision is integer and bit-identical to the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from . import config
from . import store as store_ops
from .types import NEVER, Pacemaker, SimParams, Store, sat_add
from ..utils import hashing as H

I32 = torch.int32


@dataclasses.dataclass
class PacemakerActions:
    """PacemakerUpdateActions (pacemaker.rs:17-31)."""

    should_propose: torch.Tensor
    propose_prev_round: torch.Tensor
    propose_prev_tag: torch.Tensor
    should_create_timeout: torch.Tensor
    timeout_round: torch.Tensor
    send_leader: torch.Tensor          # author to sync with, -1 = none
    should_broadcast: torch.Tensor
    should_query_all: torch.Tensor
    next_sched: torch.Tensor


def round_duration(p: SimParams, dur_table, active_round, hcr):
    """duration(round) = delta * n^gamma with
    n = round - (hcr > 0 ? hcr + 2 : 0)."""
    hccr = torch.where(hcr > 0, hcr + 2, 0)
    n = (active_round - hccr).clamp(0, p.dur_table_size - 1)
    return dur_table[n]


def query_all_period(p: SimParams, duration):
    """floor(lam_fp * d / 2^16) as hi * lam_fp + (lo * lam_fp >> 16).  The
    low-part product can reach 2^32, so it is formed on the int64 value and
    masked to 32 bits before the shift, as the JAX package's uint32 product
    wraps."""
    d_hi, d_lo = duration >> 16, duration & 0xFFFF
    lo_term = (((d_lo.to(torch.int64) * (p.lam_fp & H.M32)) & H.M32) >> 16).to(I32)
    return d_hi * p.lam_fp + lo_term


def update_pacemaker(p: SimParams, pm: Pacemaker, s: Store, weights, author,
                     epoch_id, latest_query_all, clock, dur_table):
    """pacemaker.rs:142-207.  Returns (new_pm, PacemakerActions)."""
    active_round = torch.maximum(s.hqc_round, s.htc_round) + 1
    enter = (epoch_id > pm.active_epoch) | (
        (epoch_id == pm.active_epoch) & (active_round > pm.active_round))
    leader = config.leader_of_round(weights, active_round)
    duration = round_duration(p, dur_table, active_round, s.hcr)
    pm2 = Pacemaker(
        active_epoch=torch.where(enter, epoch_id, pm.active_epoch),
        active_round=torch.where(enter, active_round, pm.active_round),
        active_leader=torch.where(enter, leader, pm.active_leader),
        round_start=torch.where(enter, clock, pm.round_start),
        round_duration=torch.where(enter, duration, pm.round_duration),
    )
    send_leader = torch.where(enter & (pm2.active_leader != author),
                              pm2.active_leader, -1)

    # Leader with no proposal yet -> propose on top of the highest QC.
    has_prop = proposed_block_valid(pm2, s)
    hqc_r, hqc_t = store_ops.hqc_ref(p, s)
    should_propose = (pm2.active_leader == author) & ~has_prop
    should_broadcast = should_propose
    next_sched = torch.where(should_propose, clock, NEVER)

    has_to = store_ops.has_timeout(s, author, pm2.active_round)
    # Saturating NodeTime sums: durations reach ~2^30 and bases can be
    # negative local times.
    timeout_deadline = sat_add(pm2.round_start, pm2.round_duration)
    past_deadline = clock >= timeout_deadline
    should_create_timeout = ~has_to & past_deadline
    should_broadcast = should_broadcast | should_create_timeout
    next_sched = torch.where(~has_to & ~past_deadline,
                             torch.minimum(next_sched, timeout_deadline), next_sched)
    # Once we hold a timeout, enforce periodic query-all.
    period = query_all_period(p, pm2.round_duration)
    qad = sat_add(latest_query_all, period)
    should_query_all = has_to & (clock >= qad)
    qad = torch.where(should_query_all, sat_add(clock, period), qad)
    next_sched = torch.where(has_to, torch.minimum(next_sched, qad), next_sched)

    actions = PacemakerActions(
        should_propose=should_propose,
        propose_prev_round=hqc_r,
        propose_prev_tag=hqc_t,
        should_create_timeout=should_create_timeout,
        timeout_round=pm2.active_round,
        send_leader=send_leader,
        should_broadcast=should_broadcast,
        should_query_all=should_query_all,
        next_sched=next_sched,
    )
    return pm2, actions


def proposed_block_valid(pm: Pacemaker, s: Store):
    """RecordStore::proposed_block gating: pacemaker on the store's
    epoch/round, a leader exists, and a legitimate proposal is recorded."""
    return ((pm.active_epoch == s.epoch_id) & (pm.active_round == s.current_round)
            & (pm.active_leader >= 0) & (s.proposed_var >= 0))
