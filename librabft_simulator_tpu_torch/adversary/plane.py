"""The adversary plane: per-slot attack state and its decode, the port of
``librabft_simulator_tpu/adversary/plane.py``.

Schema (all int32; every array rides in ``SimState`` / ``PSimState`` as
per-instance data, so one fleet runs many distinct attacks):

* ``adv_sched`` ``[W, ADV_FIELDS]``: one row per window, ``(mode, lo, hi,
  behavior, target_lo, target_hi, arg)``.  A window is active when its
  mode's key (event time, instance event count, or the handled node's
  epoch) lies in ``[lo, hi)``; its behavior then applies to the nodes whose
  bit is set in the 64-bit ``(target_lo, target_hi)`` author mask.  The
  all-zero row is inert (``hi = 0`` admits no key >= 0).
* ``adv_link`` ``[n, n]``: link ``(sender, receiver)`` adds
  ``clip(adv_link[s, r], 0, DELAY_CAP)`` to the drawn latency.
* ``adv_group`` ``[n]`` / ``adv_heal`` ``[1]``: a message sent at ``t <
  heal`` between nodes of different groups is cut (dropped, counted in
  ``n_msgs_dropped``).

The device decode below takes a leading batch dim (``[B]`` instances, or
``[B*A]`` lane rows of the lane engine): ``sched`` is ``[R, W, 7]`` and the
keys are ``[R]``.  It is one-hot, select and elementwise forms only, and it
never writes to the plane.  :class:`HostPlane` is the plain-Python decode
of one instance's rows (the oracle's mirror) with ``describe()``.

Lane-engine lookahead: per-link extras only add latency, so the minimum
off-diagonal extra (:func:`link_lookahead`) soundly widens the horizon from
``t_min + d_min`` to ``t_min + d_min + min_link``; cuts only remove messages
and window delays only add, so neither breaks the bound.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import ADV_FIELDS, NEVER, SimParams

I32 = torch.int32

# Field offsets of one [ADV_FIELDS] schedule row.
F_MODE, F_LO, F_HI, F_BEH, F_TGT_LO, F_TGT_HI, F_ARG = range(ADV_FIELDS)

# Window bound modes: the key the [lo, hi) interval is tested against.
MODE_TIME = 0    # event time
MODE_EVENTS = 1  # instance event count (the lane engine reads it at the
                 # window start: every event of a window sees one count)
MODE_EPOCH = 2   # the handled node's epoch before the event
MODES = ("time", "events", "epoch")

# Behaviors.  1..3 OR onto the static byz_* masks while active; 4..5 add
# ``arg`` to messages to the targeted receivers / to the sender's
# current-round leader (overlapping windows compose by max).
BEH_NONE = 0
BEH_EQUIVOCATE = 1
BEH_SILENT = 2
BEH_FORGE_QC = 3
BEH_DELAY = 4
BEH_DELAY_LEADER = 5
BEHAVIORS = ("none", "equivocate", "silent", "forge_qc", "delay",
             "delay_leader")

#: Cap on any adversarial delay (link entry or window arg), clamped in the
#: decode and checked by the DSL, so that int32 arrival times cannot wrap.
DELAY_CAP = 1 << 20


# ---------------------------------------------------------------------------
# Device decode (batched; shared by both engines).
# ---------------------------------------------------------------------------


def active_windows(sched, t, ev, epoch):
    """``[R, W]`` bool: each window's ``[lo, hi)`` test against its mode's
    key, ``t`` (event time), ``ev`` (instance event count) or ``epoch``
    (the handled node's epoch before the event), each ``[R]`` int32."""
    mode = sched[..., F_MODE]
    key = torch.where(mode == MODE_TIME, t.unsqueeze(-1),
                      torch.where(mode == MODE_EVENTS, ev.unsqueeze(-1),
                                  epoch.unsqueeze(-1)))
    return (key >= sched[..., F_LO]) & (key < sched[..., F_HI])


def _target_hit(sched, node):
    """Bit of ``node`` (``[R]`` or ``[R, C]``) in each window's 64-bit author
    mask: bool ``[R, W]`` or ``[R, W, C]``.  The words stay int32 and shift
    arithmetically: the low bits do not depend on the fill, so the all-ones
    mask is stored as ``-1``."""
    extra = node.dim() - 1
    lo = sched[..., F_TGT_LO].reshape(sched.shape[:2] + (1,) * extra)
    hi = sched[..., F_TGT_HI].reshape(sched.shape[:2] + (1,) * extra)
    nd = node.to(I32).unsqueeze(1)
    word = torch.where(nd < 32, lo, hi)
    bit = torch.where(nd < 32, nd, nd - 32).clamp(0, 31)
    return ((word >> bit) & 1) != 0


def behavior_hit(sched, active, beh, node):
    """Any active window with behavior ``beh`` targeting ``node``: bool of
    ``node``'s shape (``[R]`` handled nodes, or ``[R, C]``)."""
    on = active & (sched[..., F_BEH] == beh)
    on = on.reshape(on.shape + (1,) * (node.dim() - 1))
    return (on & _target_hit(sched, node)).any(dim=1)


def node_masks(sched, active, node):
    """(equivocate, silent, forge_qc) windowed activations of ``node``: what
    the engines OR onto the static ``byz_*`` masks."""
    return (behavior_hit(sched, active, BEH_EQUIVOCATE, node),
            behavior_hit(sched, active, BEH_SILENT, node),
            behavior_hit(sched, active, BEH_FORGE_QC, node))


def delay_extra(sched, active, recvs, leader):
    """Window-scoped extra delay per candidate receiver, int32 ``[R, C]``:
    the max over active delay windows of ``arg``, where a window applies to
    receiver ``r`` if it is ``BEH_DELAY`` targeting ``r``, or
    ``BEH_DELAY_LEADER`` and ``r == leader`` (``leader`` is ``[R]``)."""
    arg = sched[..., F_ARG].clamp(0, DELAY_CAP).unsqueeze(-1)
    beh = sched[..., F_BEH]
    applies = (((active & (beh == BEH_DELAY)).unsqueeze(-1)
                & _target_hit(sched, recvs))
               | ((active & (beh == BEH_DELAY_LEADER)).unsqueeze(-1)
                  & (recvs == leader.unsqueeze(-1)).unsqueeze(1)))
    return torch.where(applies, arg, 0).amax(dim=1).to(I32)


def link_lookahead(link, n: int):
    """``[B]`` int32 >= 0: the least off-diagonal per-link extra delay of
    each instance's ``[n, n]`` matrix, the amount by which every message's
    latency exceeds the delay-table bound.  At ``n == 1`` there is no link
    and the value is ``DELAY_CAP``, as in the JAX package."""
    off = ~torch.eye(n, dtype=torch.bool, device=link.device)
    return torch.where(off, link.clamp(0, DELAY_CAP), DELAY_CAP).flatten(1) \
        .amin(dim=1).to(I32)


# ---------------------------------------------------------------------------
# Host mirror (one instance's rows; the oracle's decode and the reports').
# ---------------------------------------------------------------------------


class HostPlane:
    """Plain-Python decode of one instance's lowered rows; ``describe()``
    is the decoded-program record a report carries."""

    def __init__(self, sched, link, group, heal):
        self.sched = [[int(v) for v in row] for row in np.asarray(sched)]
        self.link = np.asarray(link, np.int64)
        self.group = [int(g) for g in np.asarray(group)]
        heal = np.asarray(heal)
        self.heal = int(heal.reshape(-1)[0]) if heal.size else 0

    def _active(self, t: int, ev: int, epoch: int) -> list[bool]:
        out = []
        for row in self.sched:
            key = (t if row[F_MODE] == MODE_TIME
                   else ev if row[F_MODE] == MODE_EVENTS else epoch)
            out.append(row[F_LO] <= key < row[F_HI])
        return out

    @staticmethod
    def _targets(row, node: int) -> bool:
        word = row[F_TGT_LO] if node < 32 else row[F_TGT_HI]
        return ((word >> min(max(node if node < 32 else node - 32, 0), 31))
                & 1) != 0

    def node_masks(self, t, ev, epoch, node) -> tuple[bool, bool, bool]:
        act = self._active(t, ev, epoch)
        return tuple(
            any(a and row[F_BEH] == beh and self._targets(row, node)
                for a, row in zip(act, self.sched))
            for beh in (BEH_EQUIVOCATE, BEH_SILENT, BEH_FORGE_QC))

    def delay_extra(self, t, ev, epoch, recv, leader) -> int:
        act = self._active(t, ev, epoch)
        best = 0
        for a, row in zip(act, self.sched):
            if not a:
                continue
            if ((row[F_BEH] == BEH_DELAY and self._targets(row, recv))
                    or (row[F_BEH] == BEH_DELAY_LEADER and recv == leader)):
                best = max(best, min(max(row[F_ARG], 0), DELAY_CAP))
        return best

    def link_extra(self, sender: int, recv: int) -> int:
        return int(min(max(self.link[sender, recv], 0), DELAY_CAP))

    def cut(self, sender: int, recv: int, t: int) -> bool:
        return self.group[sender] != self.group[recv] and t < self.heal

    def describe(self) -> dict:
        """The decoded program: named windows and the network rows."""
        windows = []
        for row in self.sched:
            if row[F_HI] <= row[F_LO] or row[F_BEH] == BEH_NONE:
                continue
            tgt = (row[F_TGT_LO] & 0xFFFFFFFF) | ((row[F_TGT_HI] & 0xFFFFFFFF) << 32)
            windows.append(dict(
                behavior=BEHAVIORS[row[F_BEH]], mode=MODES[row[F_MODE]],
                lo=row[F_LO], hi=row[F_HI],
                targets=[i for i in range(64) if (tgt >> i) & 1],
                arg=row[F_ARG]))
        return dict(
            windows=windows,
            link=self.link.tolist() if self.link.size else [],
            groups=self.group,
            heal=self.heal if self.heal < NEVER else "never")


def default_rows(p: SimParams) -> dict:
    """The inert rows of one instance for ``p`` (numpy; zero-width when the
    plane is off): the values ``init_batch`` gives every instance."""
    w = p.adv_windows if p.adversary else 0
    n = p.n_nodes if p.adversary else 0
    return dict(
        adv_sched=np.zeros((w, ADV_FIELDS), np.int32),
        adv_link=np.zeros((n, n), np.int32),
        adv_group=np.zeros((n,), np.int32),
        adv_heal=np.zeros((1 if p.adversary else 0,), np.int32),
    )
