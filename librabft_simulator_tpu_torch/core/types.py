"""Tensor state containers for the batched LibraBFTv2 simulator: the port of
``librabft_simulator_tpu/core/types.py``.

Every container is a dataclass of tensors with the JAX package's leaf
names, shapes and order, plus the instance dim ``[B]`` written out in front
(JAX adds it with ``vmap``).  Leaf dtypes: JAX ``bool`` is ``torch.bool``,
``int32`` is ``torch.int32``, and ``uint32`` is ``torch.int32`` with the same
bit pattern (the names are listed in each class's ``U32``).

Torch promotes ``int32 op int64`` to int64 where JAX keeps int32, so every
leaf written back is int32: index math runs on int64 tensors and is cast
before it is stored.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..utils import hashing as H
from ..utils import quantile
from ..utils.xops import zeros as _cached_zeros

Array = Any
I32 = torch.int32
BOOL = torch.bool

NEVER = 2**31 - 1  # NodeTime::never() (bft-lib/src/base_types.rs:57)


def sat_add(a, b):
    """min(a + b, NEVER) without int32 wraparound, for b in [0, NEVER] and a
    of either sign: the subtrahend is clamped to ``max(a, 0)``."""
    room = NEVER - a.clamp(min=0)
    if isinstance(b, torch.Tensor):
        return a + torch.minimum(b, room)
    return a + room.clamp(max=int(b))


# Event kinds; priority at equal time is DESCENDING kind.
KIND_NOTIFY = 0
KIND_REQUEST = 1
KIND_RESPONSE = 2
KIND_TIMER = 3

# Election states.
ELECTION_ONGOING = 0
ELECTION_WON = 1
ELECTION_CLOSED = 2

#: The delay-family field defaults that ``structural()`` normalizes out.
DELAY_KEY_DEFAULTS = dict(delay_kind="lognormal", delay_mean=10.0,
                          delay_variance=4.0, delay_pareto_scale=5.0,
                          delay_pareto_alpha=1.5)

#: Width of one attack-schedule window row (adversary/plane.py):
#: (mode, lo, hi, behavior, target_lo, target_hi, arg).
ADV_FIELDS = 7
#: Columns of one flight-recorder row (telemetry/plane.py).
FR_COLS = 5


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static simulation parameters; field names and defaults equal the JAX
    package's ``SimParams``.

    The lowering fields (``select_kernel``, ``unroll``, ``packed``,
    ``dense_writes``, ``gate_handlers``) pick between bit-identical forms in
    the JAX package and have no effect in the port.  ``macro_k`` (serial
    engine), ``wrap`` / ``ring_k`` and ``mp_authors`` are the sharded
    runtime's (parallel/sharded.py; resolved by ``utils/xops.py::
    resolve_params``); ``shuffle_receivers`` and ``macro_k > 1`` are
    serial-engine knobs that the lane engine refuses, as in the JAX package.

    ``scenario`` makes the delay table and the commit rule per-instance
    data (the ``sc_*`` leaves, read through :class:`TracedParams`);
    ``adversary`` adds the per-instance attack rows (``adv_*``,
    adversary/plane.py).  Off, their leaves are zero-width and the engines
    run nothing for them."""

    n_nodes: int = 3
    window: int = 16          # W: record-store round window
    variants: int = 2         # V: slots per round
    queue_cap: int = 32       # CM: in-flight messages per instance
    chain_k: int = 4          # K: rounds of (block, QC) tail in a sync response
    commit_log: int = 32      # H: per-node committed-state ring
    commands_per_epoch: int = 30000
    target_commit_interval: int = 100000
    delta: int = 20
    gamma: float = 2.0
    lam: float = 0.5          # lambda; fixed-point applied as (lam_fp * d) >> 16
    commit_chain: int = 3     # 3 = LibraBFTv2 3-chain; 2 = HotStuff-style 2-chain
    epoch_handoff: bool = True
    handoff_epochs: int = 2
    select_kernel: str = "xla"
    unroll: bool = False
    packed: bool | None = None
    dense_writes: str = "auto"
    gate_handlers: bool | None = None
    mp_authors: bool = False
    shuffle_receivers: bool = False
    inbox_cap: int = 0
    active_lanes: int = 0
    drain_k: int = 0
    delay_kind: str = "lognormal"
    delay_mean: float = 10.0
    delay_variance: float = 4.0
    delay_pareto_scale: float = 5.0
    delay_pareto_alpha: float = 1.5
    drop_prob: float = 0.0
    max_clock: int = 1000
    dur_table_size: int = 64
    trace_cap: int = 0        # round-switch trace entries (0 = tracing off)
    telemetry: bool = False
    flight_cap: int = 32
    macro_k: int | None = None
    wrap: str | None = None
    ring_k: int | None = None
    watchdog: bool = False
    watchdog_stall_events: int = 512
    scenario: bool = False
    adversary: bool = False
    adv_windows: int = 4

    def __post_init__(self):
        if self.epoch_handoff and self.handoff_epochs < 1:
            raise ValueError(
                "handoff_epochs must be >= 1 when epoch_handoff is on "
                f"(got {self.handoff_epochs})")
        if self.telemetry and self.flight_cap < 1:
            raise ValueError(
                f"flight_cap must be >= 1 when telemetry is on (got {self.flight_cap})")
        if self.macro_k is not None and self.macro_k < 1:
            raise ValueError(f"macro_k must be >= 1 (got {self.macro_k})")
        if self.wrap is not None and self.wrap not in ("host", "device"):
            raise ValueError(f"wrap must be 'host' or 'device' (got {self.wrap!r})")
        if self.ring_k is not None and self.ring_k < 1:
            raise ValueError(f"ring_k must be >= 1 (got {self.ring_k})")
        if self.watchdog and self.watchdog_stall_events < 1:
            raise ValueError(
                "watchdog_stall_events must be >= 1 when the watchdog is on "
                f"(got {self.watchdog_stall_events})")
        if self.adversary and self.adv_windows < 1:
            raise ValueError(
                f"adv_windows must be >= 1 when the adversary plane is on "
                f"(got {self.adv_windows})")
        if self.adversary and self.n_nodes > 64:
            raise ValueError(
                f"the adversary plane's author target masks cover 64 nodes "
                f"(n_nodes={self.n_nodes})")
        if self.scenario and self.commit_chain not in (2, 3):
            raise ValueError(
                f"commit_chain must be 2 or 3 when the scenario plane is on, "
                f"got {self.commit_chain}")

    @property
    def lam_fp(self) -> int:
        return int(self.lam * 65536)

    @property
    def drop_u32(self) -> int:
        return min(int(self.drop_prob * 4294967296.0), 0xFFFFFFFF)

    def structural(self) -> "SimParams":
        """The shape-relevant projection: fields that only parameterize data
        (tables, drop rate, horizon) normalized to defaults."""
        out = dataclasses.replace(
            self, drop_prob=0.0, max_clock=0, delta=20, gamma=2.0,
            **DELAY_KEY_DEFAULTS)
        if self.scenario:
            out = dataclasses.replace(out, commit_chain=3)
        return out

    def delay_table(self) -> np.ndarray:
        if self.delay_kind == "pareto":
            return quantile.make_table(
                "pareto", scale=self.delay_pareto_scale, alpha=self.delay_pareto_alpha)
        if self.delay_kind == "uniform":
            return quantile.make_table(
                "uniform",
                low=max(self.delay_mean - 3 * self.delay_variance ** 0.5, 0.0),
                high=self.delay_mean + 3 * self.delay_variance ** 0.5,
            )
        if self.delay_kind == "constant":
            return quantile.make_table("constant", value=int(self.delay_mean))
        return quantile.make_table(
            "lognormal", mean=self.delay_mean, variance=self.delay_variance)

    def duration_table(self) -> np.ndarray:
        """round-duration(n) = delta * n^gamma, precomputed in float64 on host."""
        n = np.arange(self.dur_table_size, dtype=np.float64)
        vals = np.floor(float(self.delta) * np.power(np.maximum(n, 0), self.gamma))
        return np.minimum(vals, float(NEVER // 2)).astype(np.int32)


# ---------------------------------------------------------------------------
# Per-instance scenario and adversary planes (serve/scenario.py,
# adversary/plane.py): the knob-default rows of ``shape`` instances, or
# zero-width leaves when the plane is off.  The all-zero adversary rows are
# the inert program: a window with hi = 0 never activates, a zero link
# matrix adds nothing, equal groups with heal = 0 never cut.
# ---------------------------------------------------------------------------


def sc_delay_init(p: SimParams, shape, device):
    """``sc_delay`` ``[*shape, T]``: the params' own delay table per
    instance (``[*shape, 0]`` off)."""
    shape = tuple(shape)
    if not p.scenario:
        return _z(shape + (0,), I32, device)
    table = torch.as_tensor(p.delay_table(), device=device)
    return table.expand(shape + tuple(table.shape)).contiguous()


def sc_commit_init(p: SimParams, shape, device):
    """``sc_commit`` ``[*shape, 1]``: the params' commit_chain per instance
    (``[*shape, 0]`` off)."""
    shape = tuple(shape)
    if not p.scenario:
        return _z(shape + (0,), I32, device)
    return _full(shape + (1,), p.commit_chain, device)


def adv_sched_init(p: SimParams, shape, device):
    """Inert attack schedule ``[*shape, W, ADV_FIELDS]`` (W = 0 off)."""
    return _z(tuple(shape) + (p.adv_windows if p.adversary else 0, ADV_FIELDS),
              I32, device)


def adv_link_init(p: SimParams, shape, device):
    """Zero per-link extra delays ``[*shape, n, n]`` (n = 0 off)."""
    n = p.n_nodes if p.adversary else 0
    return _z(tuple(shape) + (n, n), I32, device)


def adv_group_init(p: SimParams, shape, device):
    """One partition group for all ``[*shape, n]`` (n = 0 off)."""
    return _z(tuple(shape) + (p.n_nodes if p.adversary else 0,), I32, device)


def adv_heal_init(p: SimParams, shape, device):
    """Heal at 0, never partitioned: ``[*shape, 1]`` (``[*shape, 0]`` off)."""
    return _z(tuple(shape) + (1 if p.adversary else 0,), I32, device)


def plane_leaves(p: SimParams, shape, device) -> dict:
    """The ``sc_*`` and ``adv_*`` leaves of a fresh state."""
    return dict(
        sc_delay=sc_delay_init(p, shape, device),
        sc_commit=sc_commit_init(p, shape, device),
        adv_sched=adv_sched_init(p, shape, device),
        adv_link=adv_link_init(p, shape, device),
        adv_group=adv_group_init(p, shape, device),
        adv_heal=adv_heal_init(p, shape, device),
    )


class TracedParams:
    """A :class:`SimParams` view whose ``commit_chain`` is a per-row int32
    tensor (``[B]`` instances, or ``[B*A]`` lane rows): the scenario
    plane's ``sc_commit``.

    The engines build one per step and hand it to the protocol code in
    place of the params; every other attribute delegates to the params.
    core/store.py branches on ``isinstance(commit_chain, int)``: an int
    keeps the static walk as it is; a tensor walks to the deepest rule
    once and selects the 2- or 3-chain predicate per row.  Never hashed."""

    __slots__ = ("_p", "commit_chain")

    def __init__(self, p: SimParams, commit_chain):
        self._p = p
        self.commit_chain = commit_chain

    def __getattr__(self, name):
        return getattr(self._p, name)

    __hash__ = None  # type: ignore[assignment]


# ---------------------------------------------------------------------------
# Containers.
# ---------------------------------------------------------------------------


class Tree:
    """Dataclass-of-tensors base: ``replace`` and leaf iteration in field
    order (the JAX pytree order).  ``U32`` names the uint32 leaves."""

    U32: frozenset = frozenset()

    def replace(self, **kw):
        """A copy with the given fields replaced (the other leaves are
        shared, never copied)."""
        out = object.__new__(type(self))
        out.__dict__.update(self.__dict__)
        out.__dict__.update(kw)
        return out


def tree_fields(t: Tree):
    return [f.name for f in dataclasses.fields(t)]


def leaves_with_path(t, prefix: str = ""):
    """``[(path, tensor, is_u32)]`` in JAX leaf order; paths like
    ``"store.blk_round"``."""
    out = []
    for name in tree_fields(t):
        v = getattr(t, name)
        path = f"{prefix}{name}"
        if isinstance(v, Tree):
            out.extend(leaves_with_path(v, path + "."))
        else:
            out.append((path, v, name in t.U32))
    return out


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over trees of one structure."""
    t0 = trees[0]
    kw = {}
    for name in tree_fields(t0):
        vals = [getattr(t, name) for t in trees]
        if isinstance(vals[0], Tree):
            kw[name] = tree_map(fn, *vals)
        else:
            kw[name] = fn(*vals)
    return type(t0)(**kw)


def _z(shape, dtype, device):
    return _cached_zeros(tuple(shape), dtype, device)


def _full(shape, value, device, dtype=I32):
    return torch.full(tuple(shape), int(value), dtype=dtype, device=device)


@dataclasses.dataclass
class BlockMsg(Tree):
    valid: Array
    round: Array
    author: Array
    prev_round: Array
    prev_tag: Array
    time: Array
    cmd_proposer: Array
    cmd_index: Array
    tag: Array

    U32 = frozenset({"prev_tag", "tag"})

    @classmethod
    def empty(cls, shape, device):
        return cls(
            valid=_z(shape, BOOL, device), round=_z(shape, I32, device),
            author=_z(shape, I32, device), prev_round=_z(shape, I32, device),
            prev_tag=_z(shape, I32, device), time=_z(shape, I32, device),
            cmd_proposer=_z(shape, I32, device), cmd_index=_z(shape, I32, device),
            tag=_z(shape, I32, device),
        )


@dataclasses.dataclass
class QcMsg(Tree):
    valid: Array
    epoch: Array
    round: Array
    blk_tag: Array
    state_depth: Array
    state_tag: Array
    commit_valid: Array
    commit_depth: Array
    commit_tag: Array
    votes_lo: Array
    votes_hi: Array
    author: Array
    tag: Array

    U32 = frozenset({"blk_tag", "state_tag", "commit_tag", "votes_lo",
                     "votes_hi", "tag"})

    @classmethod
    def empty(cls, shape, device):
        b, i = (lambda: _z(shape, BOOL, device)), (lambda: _z(shape, I32, device))
        return cls(valid=b(), epoch=i(), round=i(), blk_tag=i(), state_depth=i(),
                   state_tag=i(), commit_valid=b(), commit_depth=i(),
                   commit_tag=i(), votes_lo=i(), votes_hi=i(), author=i(), tag=i())


@dataclasses.dataclass
class VoteMsg(Tree):
    valid: Array
    epoch: Array
    round: Array
    blk_tag: Array
    state_depth: Array
    state_tag: Array
    commit_valid: Array
    commit_depth: Array
    commit_tag: Array
    author: Array

    U32 = frozenset({"blk_tag", "state_tag", "commit_tag"})

    @classmethod
    def empty(cls, shape, device):
        b, i = (lambda: _z(shape, BOOL, device)), (lambda: _z(shape, I32, device))
        return cls(valid=b(), epoch=i(), round=i(), blk_tag=i(), state_depth=i(),
                   state_tag=i(), commit_valid=b(), commit_depth=i(),
                   commit_tag=i(), author=i())


@dataclasses.dataclass
class TimeoutsMsg(Tree):
    round: Array        # per-instance round shared by the batch
    valid: Array        # [N] bool
    hcbr: Array         # [N]

    @classmethod
    def empty(cls, n, shape, device):
        return cls(round=_z(shape, I32, device),
                   valid=_z(tuple(shape) + (n,), BOOL, device),
                   hcbr=_z(tuple(shape) + (n,), I32, device))


@dataclasses.dataclass
class Payload(Tree):
    """Superset of DataSyncNotification / Request / Response, fixed shape."""

    epoch: Array
    hcc: QcMsg
    hqc: QcMsg
    hcc_blk: BlockMsg
    prop_blk: BlockMsg
    vote: VoteMsg
    tc_to: TimeoutsMsg
    cur_to: TimeoutsMsg
    chain_blk: BlockMsg   # fields have trailing [K]
    chain_qc: QcMsg       # fields have trailing [K]
    req_hqc_round: Array
    req_hcr: Array

    @classmethod
    def empty(cls, n, k, shape, device):
        shape = tuple(shape)
        return cls(
            epoch=_z(shape, I32, device),
            hcc=QcMsg.empty(shape, device), hqc=QcMsg.empty(shape, device),
            hcc_blk=BlockMsg.empty(shape, device),
            prop_blk=BlockMsg.empty(shape, device),
            vote=VoteMsg.empty(shape, device),
            tc_to=TimeoutsMsg.empty(n, shape, device),
            cur_to=TimeoutsMsg.empty(n, shape, device),
            chain_blk=BlockMsg.empty(shape + (k,), device),
            chain_qc=QcMsg.empty(shape + (k,), device),
            req_hqc_round=_z(shape, I32, device), req_hcr=_z(shape, I32, device),
        )


@dataclasses.dataclass
class Store(Tree):
    """Per-node record store (RecordStoreState).  Shapes below are for one
    node; in SimState each gains ``[B, N]`` in front."""

    # Verified blocks table [W, V].
    blk_valid: Array
    blk_round: Array
    blk_author: Array
    blk_prev_round: Array
    blk_prev_tag: Array
    blk_time: Array
    blk_cmd_proposer: Array
    blk_cmd_index: Array
    blk_tag: Array
    # Verified QCs table [W, V].
    qc_valid: Array
    qc_round: Array
    qc_blk_var: Array
    qc_state_depth: Array
    qc_state_tag: Array
    qc_commit_valid: Array
    qc_commit_depth: Array
    qc_commit_tag: Array
    qc_votes_lo: Array
    qc_votes_hi: Array
    qc_author: Array
    qc_tag: Array
    # Votes at the current round, per author [N].
    vt_valid: Array
    vt_blk_var: Array
    vt_state_depth: Array
    vt_state_tag: Array
    vt_commit_valid: Array
    vt_commit_depth: Array
    vt_commit_tag: Array
    # Ballot [V, 2].
    bal_used: Array
    bal_weight: Array
    bal_state_depth: Array
    bal_state_tag: Array
    # Timeouts at the current round, per author [N].
    to_valid: Array
    to_hcbr: Array
    to_weight: Array
    # Snapshot of the highest TC, per author [N].
    tc_valid: Array
    tc_hcbr: Array
    # Scalars.
    epoch_id: Array
    initial_round: Array
    initial_tag: Array
    initial_state_depth: Array
    initial_state_tag: Array
    current_round: Array
    proposed_var: Array
    election: Array
    won_var: Array
    won_slot: Array
    hqc_round: Array
    hqc_var: Array
    htc_round: Array
    hcr: Array
    hcc_valid: Array
    hcc_round: Array
    hcc_var: Array
    anchored: Array

    U32 = frozenset({
        "blk_prev_tag", "blk_tag", "qc_state_tag", "qc_commit_tag",
        "qc_votes_lo", "qc_votes_hi", "qc_tag", "vt_state_tag",
        "vt_commit_tag", "bal_state_tag", "initial_tag", "initial_state_tag"})

    #: Values derived from a store and cached on it (core/store.py), each
    #: with the fields it is computed from: a replace that touches one of
    #: them drops the cached value.
    DERIVED = {
        "_parents": frozenset({"blk_prev_round", "blk_prev_tag", "qc_valid",
                               "qc_round", "qc_tag", "initial_round",
                               "initial_tag"}),
        "_leader": frozenset({"current_round"}),
    }

    def replace(self, **kw):
        out = Tree.replace(self, **kw)
        d = out.__dict__
        for key, deps in self.DERIVED.items():
            if key in d and not deps.isdisjoint(kw):
                del d[key]
        return out

    @classmethod
    def initial(cls, p: SimParams, shape, device):
        shape = tuple(shape)
        W, V, N = p.window, p.variants, p.n_nodes
        wv, na, v2 = shape + (W, V), shape + (N,), shape + (V, 2)

        def b(s):
            return _z(s, BOOL, device)

        def i(s):
            return _z(s, I32, device)

        return cls(
            blk_valid=b(wv), blk_round=i(wv), blk_author=i(wv),
            blk_prev_round=i(wv), blk_prev_tag=i(wv), blk_time=i(wv),
            blk_cmd_proposer=i(wv), blk_cmd_index=i(wv), blk_tag=i(wv),
            qc_valid=b(wv), qc_round=i(wv), qc_blk_var=i(wv),
            qc_state_depth=i(wv), qc_state_tag=i(wv), qc_commit_valid=b(wv),
            qc_commit_depth=i(wv), qc_commit_tag=i(wv), qc_votes_lo=i(wv),
            qc_votes_hi=i(wv), qc_author=i(wv), qc_tag=i(wv),
            vt_valid=b(na), vt_blk_var=i(na), vt_state_depth=i(na),
            vt_state_tag=i(na), vt_commit_valid=b(na), vt_commit_depth=i(na),
            vt_commit_tag=i(na),
            bal_used=b(v2), bal_weight=i(v2), bal_state_depth=i(v2),
            bal_state_tag=i(v2),
            to_valid=b(na), to_hcbr=i(na), to_weight=i(shape),
            tc_valid=b(na), tc_hcbr=i(na),
            epoch_id=i(shape), initial_round=i(shape),
            initial_tag=_full(shape, H.epoch_initial_tag(0), device),
            initial_state_depth=i(shape),
            initial_state_tag=_full(shape, H.initial_state_tag(), device),
            current_round=_full(shape, 1, device),  # rounds start at 1
            proposed_var=_full(shape, -1, device),
            election=i(shape), won_var=i(shape), won_slot=i(shape),
            hqc_round=i(shape), hqc_var=i(shape), htc_round=i(shape),
            hcr=i(shape), hcc_valid=b(shape), hcc_round=i(shape),
            hcc_var=i(shape), anchored=b(shape),
        )


@dataclasses.dataclass
class Pacemaker(Tree):
    active_epoch: Array
    active_round: Array
    active_leader: Array       # -1 = none
    round_start: Array
    round_duration: Array

    @classmethod
    def initial(cls, shape, device):
        shape = tuple(shape)
        return cls(
            active_epoch=_z(shape, I32, device), active_round=_z(shape, I32, device),
            active_leader=_full(shape, -1, device),
            round_start=_z(shape, I32, device), round_duration=_z(shape, I32, device),
        )


@dataclasses.dataclass
class NodeExtra(Tree):
    latest_voted_round: Array
    locked_round: Array
    latest_query_all: Array
    tracker_epoch: Array
    tracker_hcr: Array
    tracker_commit_time: Array

    @classmethod
    def initial(cls, shape, device):
        z = _z(tuple(shape), I32, device)
        return cls(latest_voted_round=z, locked_round=z, latest_query_all=z,
                   tracker_epoch=z, tracker_hcr=z, tracker_commit_time=z)


@dataclasses.dataclass
class Context(Tree):
    next_cmd_index: Array
    commit_count: Array
    last_depth: Array
    last_tag: Array
    sync_jumps: Array
    skipped_commits: Array
    log_round: Array          # [H]
    log_depth: Array          # [H]
    log_tag: Array            # [H]

    U32 = frozenset({"last_tag", "log_tag"})

    @classmethod
    def initial(cls, p: SimParams, shape, device):
        shape = tuple(shape)
        h = shape + (p.commit_log,)
        z = _z(shape, I32, device)
        return cls(
            next_cmd_index=z, commit_count=z, last_depth=z,
            last_tag=_full(shape, H.initial_state_tag(), device),
            sync_jumps=z, skipped_commits=z,
            log_round=_z(h, I32, device), log_depth=_z(h, I32, device),
            log_tag=_z(h, I32, device),
        )


@functools.lru_cache(maxsize=None)
def _layout(n_nodes: int, chain_k: int):
    """``(leaves, plan)`` of one packed Payload row: ``leaves`` is
    ``[(path, shape, kind, column, width)]`` in pack order (kind "i32",
    "u32" or "bool"); ``plan`` is the nested
    ``(class, [(field, plan | (column, width, shape, is_bool))])`` that
    unpack_payload walks."""
    leaves = []
    off = 0

    def plan(t, prefix):
        nonlocal off
        items = []
        for name in tree_fields(t):
            v = getattr(t, name)
            if isinstance(v, Tree):
                items.append((name, plan(v, f"{prefix}{name}.")))
                continue
            n = int(np.prod(v.shape)) if v.dim() else 1
            kind = "u32" if name in t.U32 else ("bool" if v.dtype == BOOL else "i32")
            leaves.append((prefix + name, tuple(v.shape), kind, off, n))
            items.append((name, (off, n, tuple(v.shape), kind == "bool")))
            off += n
        return (type(t), items)

    tree = plan(Payload.empty(n_nodes, chain_k, (), "cpu"), "")
    return tuple(leaves), tree


@functools.lru_cache(maxsize=None)
def _offsets(n_nodes: int, chain_k: int) -> dict:
    return {path: (off, n) for path, _, _, off, n in _layout(n_nodes, chain_k)[0]}


def payload_offsets(p: SimParams) -> dict:
    """``{path: (column, width)}`` of each Payload leaf in a packed row."""
    return _offsets(p.n_nodes, p.chain_k)


def payload_width(p: SimParams) -> int:
    """Packed width F of one Payload (see pack_payload)."""
    return sum(leaf[4] for leaf in _layout(p.n_nodes, p.chain_k)[0])


def pack_payload(pay: Payload) -> torch.Tensor:
    """Flatten a batched Payload into one int32 ``[B, F]`` row per instance,
    bit-preserving, in the JAX package's leaf order."""
    parts = []
    for _, leaf, _ in leaves_with_path(pay):
        flat = leaf.reshape(leaf.shape[0], -1)
        if flat.dtype != I32:
            flat = flat.to(I32)
        parts.append(flat)
    return torch.cat(parts, dim=1)


def unpack_payload(p: SimParams, vec: torch.Tensor) -> Payload:
    """Inverse of pack_payload for ``[B, F]`` rows."""
    b = vec.shape[0]

    def build(plan):
        cls, items = plan
        kw = {}
        for name, sub in items:
            if len(sub) == 2:
                kw[name] = build(sub)
                continue
            off, n, shape, is_bool = sub
            piece = vec[:, off:off + n]
            if shape != (n,):
                piece = piece.reshape((b,) + shape)
            kw[name] = piece != 0 if is_bool else piece
        return cls(**kw)

    return build(_layout(p.n_nodes, p.chain_k)[1])


@dataclasses.dataclass
class Queue(Tree):
    """Fixed-capacity network-message table.  Payloads are packed rows."""

    valid: Array     # [CM] bool
    time: Array      # [CM]
    kind: Array      # [CM]
    stamp: Array     # [CM]
    sender: Array    # [CM]
    receiver: Array  # [CM]
    payload: Array   # [CM, F] int32

    @classmethod
    def initial(cls, p: SimParams, shape, device):
        cm = tuple(shape) + (p.queue_cap,)
        return cls(
            valid=_z(cm, BOOL, device), time=_z(cm, I32, device),
            kind=_z(cm, I32, device), stamp=_z(cm, I32, device),
            sender=_z(cm, I32, device), receiver=_z(cm, I32, device),
            payload=_z(cm + (payload_width(p),), I32, device),
        )


@dataclasses.dataclass
class SimState(Tree):
    """A batch of instances: N nodes + network each.  The planes that are
    off (metrics, flight, wd, sc_*, adv_*) keep their zero-width shapes, so
    the leaf set equals the JAX package's."""

    store: Store
    pm: Pacemaker
    node: NodeExtra
    ctx: Context
    queue: Queue
    ho_pay: Array         # [N, E, F] packed Payload rows (E = 0 when off)
    ho_epoch: Array       # [N, E]; -1 = none
    timer_time: Array     # [N]
    timer_stamp: Array    # [N]
    startup: Array        # [N]
    weights: Array        # [N]
    byz_equivocate: Array # [N] bool
    byz_silent: Array     # [N] bool
    byz_forge_qc: Array   # [N] bool
    clock: Array
    stamp_ctr: Array
    halted: Array         # bool
    seed: Array           # uint32 instance seed
    max_clock: Array
    drop_u32: Array       # uint32 drop threshold
    n_events: Array
    n_msgs_sent: Array
    n_msgs_dropped: Array
    n_queue_full: Array
    trace_node: Array     # [T]
    trace_round: Array    # [T]
    trace_time: Array     # [T]
    trace_count: Array
    metrics: Array        # [M] telemetry plane ([0] when off)
    flight: Array         # [K, FR_COLS] flight ring (K = 0 when off)
    wd: Array             # [WD] watchdog plane ([0] when off)
    sc_delay: Array       # [T] delay table row ([0] when off)
    sc_commit: Array      # [1] commit chain, 2 or 3 ([0] when off)
    adv_sched: Array      # [W, ADV_FIELDS] attack schedule ([0, F] off)
    adv_link: Array       # [n, n] per-link extra delay ([0, 0] off)
    adv_group: Array      # [n] partition group ([0] off)
    adv_heal: Array       # [1] partition heal time ([0] off)

    U32 = frozenset({"seed", "drop_u32"})
