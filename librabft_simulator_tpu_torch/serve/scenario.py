"""Per-slot scenario planes: the port of
``librabft_simulator_tpu/serve/scenario.py``.

The batch dim multiplies instances; with ``SimParams.scenario`` on it also
multiplies scenarios.  Every per-instance knob of a run (the delay table,
the 2- or 3-chain commit rule, the Byzantine schedule, the drop rate, the
seed, the horizon and, with ``SimParams.adversary`` on, the attack
program) is one row of a :class:`ScenarioPlane`, and the engines read
these rows from the state (``sc_delay``, ``sc_commit``, ``max_clock``,
``drop_u32``, the ``byz_*`` masks and the ``adv_*`` leaves).  Each slot's
trajectory equals a dedicated static run of its scenario
(``ScenarioSpec.to_params`` with its program installed) in every leaf but
``sc_*``.

Installing a scenario into a slot of a fleet is a masked write
(:func:`install_rows`), or with the admitted rows alone an indexed one
(:func:`install_at`, the resident service's admission).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..adversary import dsl as adsl
from ..adversary import plane as aplane
from ..core.types import DELAY_KEY_DEFAULTS, SimParams, Tree, tree_fields, tree_map
from ..sim import byzantine
from ..sim import parallel_sim as lane_ops
from ..sim import simulator as sim_ops
from ..utils import hashing as H
from ..utils.quantile import TABLE_BITS
from ..utils.xops import arange

I32 = torch.int32


@dataclasses.dataclass
class ScenarioPlane(Tree):
    """One scenario per row, as tensors.  An unbatched row describes one
    slot; a leading ``[B]`` dim describes a fleet.  uint32 values are int32
    bit patterns (``U32``), as in the engines' states."""

    seed: torch.Tensor            # uint32 instance rng stream
    delay_table: torch.Tensor     # [T] int32 delay quantile table
    drop_u32: torch.Tensor        # uint32 drop threshold
    max_clock: torch.Tensor       # int32 horizon
    commit_chain: torch.Tensor    # int32: 2 (HotStuff-style) | 3 (LibraBFTv2)
    byz_equivocate: torch.Tensor  # [N] bool
    byz_silent: torch.Tensor      # [N] bool
    byz_forge_qc: torch.Tensor    # [N] bool
    # The slot's lowered attack program (zero-width when the base params'
    # adversary plane is off).
    adv_sched: torch.Tensor       # [W, ADV_FIELDS] int32
    adv_link: torch.Tensor        # [N, N] int32
    adv_group: torch.Tensor       # [N] int32
    adv_heal: torch.Tensor        # [1] int32

    U32 = frozenset({"seed", "drop_u32"})


#: The SimParams fields a spec overrides on its base (everything else is
#: shape or lowering, shared by the fleet).
_SPEC_PARAM_FIELDS = ("delay_kind", "delay_mean", "delay_variance",
                      "delay_pareto_scale", "delay_pareto_alpha",
                      "drop_prob", "commit_chain", "max_clock")


def _i32(v) -> torch.Tensor:
    return torch.tensor(H.to_i32(int(v)), dtype=I32)


@functools.lru_cache(maxsize=256)
def _delay_table(*delay_fields) -> np.ndarray:
    """The delay table of ``DELAY_KEY_DEFAULTS``' fields (in that order),
    built once per family and parameters: a serve admission wave builds a
    row for every request, and a table costs ~0.4 ms of host time."""
    return SimParams(**dict(zip(DELAY_KEY_DEFAULTS, delay_fields))).delay_table()


def _rows(table, drop_u32, max_clock, commit_chain, seed,
          masks, adv) -> ScenarioPlane:
    eq, silent, forge = (torch.as_tensor(np.asarray(m, bool)) for m in masks)
    return ScenarioPlane(
        seed=_i32(seed & 0xFFFFFFFF),
        delay_table=torch.as_tensor(np.asarray(table, np.int32)),
        drop_u32=_i32(drop_u32), max_clock=_i32(max_clock),
        commit_chain=_i32(commit_chain),
        byz_equivocate=eq, byz_silent=silent, byz_forge_qc=forge,
        **{k: torch.as_tensor(v) for k, v in adv.items()})


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A host-side scenario: the unit a fleet is built from.

    ``to_params(base)`` gives the static params of a dedicated run of just
    this scenario (scenario plane off), the reference each slot equals;
    ``plane_row(base)`` gives its row."""

    delay_kind: str = "lognormal"
    delay_mean: float = 10.0
    delay_variance: float = 4.0
    delay_pareto_scale: float = 5.0
    delay_pareto_alpha: float = 1.5
    drop_prob: float = 0.0
    commit_chain: int = 3
    max_clock: int = 1000
    byz_kind: str = "honest"      # one of sim/byzantine.SCHEDULES
    byz_f: int = 0
    byz_authors: tuple | None = None
    seed: int = 0
    #: Attack program (the ``AttackProgram.from_dict`` grammar); needs a base
    #: with the adversary plane armed.  None: no attack.
    attack: dict | None = None

    def __post_init__(self):
        if self.byz_kind not in byzantine.SCHEDULES:
            raise ValueError(
                f"unknown Byzantine schedule {self.byz_kind!r}; want one "
                f"of {byzantine.SCHEDULES}")
        if self.commit_chain not in (2, 3):
            raise ValueError(
                f"commit_chain must be 2 or 3, got {self.commit_chain}")
        # The grammar is checked here; capacities and node ids when the
        # program is lowered against the base params.  The parsed program is
        # kept (not a field): a served request reads it at submission,
        # admission and egress.
        prog = adsl.AttackProgram.from_dict(self.attack) if self.attack is not None else None
        object.__setattr__(self, "_program", prog)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        """Build from a request row; unknown keys fail loud (a misspelt knob
        must not run the default scenario)."""
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(
                f"unknown scenario field(s) {sorted(extra)}; known: "
                f"{sorted(known)}")
        if "byz_authors" in d and d["byz_authors"] is not None:
            d = dict(d, byz_authors=tuple(d["byz_authors"]))
        return cls(**d)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_params(self, base: SimParams) -> SimParams:
        """The static params of a dedicated run of this scenario (scenario
        plane off)."""
        return dataclasses.replace(
            base, scenario=False,
            **{f: getattr(self, f) for f in _SPEC_PARAM_FIELDS})

    def byz_masks(self, base: SimParams):
        return byzantine.schedule_masks(
            base, self.byz_kind, self.byz_f,
            list(self.byz_authors) if self.byz_authors is not None else None)

    def attack_program(self) -> "adsl.AttackProgram | None":
        """The parsed attack program (None: no attack)."""
        return self._program

    def adv_rows(self, base: SimParams) -> dict:
        """This scenario's lowered adversary rows (inert without an attack;
        an attack on a base without the plane raises)."""
        prog = self.attack_program()
        if prog is None:
            return aplane.default_rows(base)
        if not base.adversary:
            raise ValueError(
                "scenario carries an attack program but the base params "
                "have adversary=False — arm SimParams.adversary on the "
                "fleet's base config (the adv_* plane leaves are "
                "zero-width otherwise)")
        return prog.lower(base)

    def honest_mask(self, base: SimParams) -> np.ndarray:
        """``[N]`` bool: the nodes the safety check holds to agreement, all
        but the static Byzantine authors and every node a Byzantine window
        of the attack can activate."""
        eq, silent, forge = self.byz_masks(base)
        byz = np.asarray(eq) | np.asarray(silent) | np.asarray(forge)
        prog = self.attack_program()
        if prog is not None:
            byz = byz | np.isin(np.arange(base.n_nodes), sorted(adsl.byz_targets(prog)))
        return ~byz

    def plane_row(self, base: SimParams) -> ScenarioPlane:
        """This scenario as one (unbatched) row."""
        return tree_map(lambda x: x[0], plane_rows(base, [self]))


def plane_rows(base: SimParams, specs) -> ScenarioPlane:
    """The ``[B]`` plane of ``specs``, row i ``specs[i].plane_row(base)``,
    built column by column in numpy (one tensor per leaf)."""
    specs = list(specs)
    if not specs:
        raise ValueError("plane_rows needs at least one scenario")
    cols = {k: [] for k in ("seed", "delay_table", "drop_u32", "max_clock", "commit_chain",
                            "byz_equivocate", "byz_silent", "byz_forge_qc")}
    adv = []
    for spec in specs:
        ded = spec.to_params(base)
        cols["seed"].append(H.to_i32(int(spec.seed) & 0xFFFFFFFF))
        cols["delay_table"].append(_delay_table(*(getattr(ded, f) for f in DELAY_KEY_DEFAULTS)))
        for k, v in (("drop_u32", ded.drop_u32), ("max_clock", ded.max_clock),
                     ("commit_chain", ded.commit_chain)):
            cols[k].append(H.to_i32(int(v)))
        for k, m in zip(("byz_equivocate", "byz_silent", "byz_forge_qc"), spec.byz_masks(base)):
            cols[k].append(np.asarray(m, bool))
        adv.append(spec.adv_rows(base))
    out = {k: torch.as_tensor(np.asarray(v, np.int32)) for k, v in cols.items()
           if k in ("seed", "drop_u32", "max_clock", "commit_chain")}
    out["delay_table"] = torch.as_tensor(np.stack(cols["delay_table"]).astype(np.int32))
    out.update({k: torch.as_tensor(np.stack(cols[k]))
                for k in ("byz_equivocate", "byz_silent", "byz_forge_qc")})
    out.update({k: torch.as_tensor(np.stack([a[k] for a in adv])) for k in adv[0]})
    return ScenarioPlane(**out)


def default_row(p: SimParams, seed: int = 0) -> ScenarioPlane:
    """The scenario the base params describe themselves (a fleet of these
    equals a plain static run)."""
    z = np.zeros((p.n_nodes,), bool)
    return _rows(p.delay_table(), p.drop_u32, p.max_clock, p.commit_chain,
                 int(seed), (z, z, z), aplane.default_rows(p))


def stack_rows(rows) -> ScenarioPlane:
    """Stack unbatched rows into a ``[B]``-leading plane."""
    rows = list(rows)
    if not rows:
        raise ValueError("stack_rows needs at least one scenario row")
    return tree_map(lambda *xs: torch.stack(xs), *rows)


def honest_masks(base: SimParams, specs) -> np.ndarray:
    """``[B, N]`` bool: each spec's :meth:`ScenarioSpec.honest_mask`, the
    per-instance masks ``byzantine.check_safety`` takes."""
    return np.stack([s.honest_mask(base) for s in specs])


def _require_scenario(p: SimParams) -> None:
    if not p.scenario:
        raise ValueError(
            "scenario-plane state needs SimParams.scenario=True (the "
            "sc_delay/sc_commit leaves are zero-width otherwise); arm it "
            "with dataclasses.replace(p, scenario=True)")


def init_rows(p: SimParams, plane: ScenarioPlane, engine=None, device="cuda"):
    """A fleet state with one instance per row of the ``[B]`` plane, on
    ``engine`` (``sim.simulator``, the default, or ``sim.parallel_sim``).

    It is the engine's ``init_batch`` of the rows' seeds and masks, with the
    startup draws replayed against each row's own table (the same formula),
    and each row's knobs written into the leaves the step reads."""
    _require_scenario(p)
    eng = engine if engine is not None else sim_ops
    host = tree_map(lambda x: x.cpu(), plane)
    st = eng.init_batch(
        p, host.seed.numpy(), byz_equivocate=host.byz_equivocate.numpy(),
        byz_silent=host.byz_silent.numpy(), byz_forge_qc=host.byz_forge_qc.numpy(),
        device=device)
    dev = st.clock.device
    rows = tree_map(lambda x: x.to(dev), host)
    draws = H.rng_u32(rows.seed.unsqueeze(-1), arange(p.n_nodes, dev))
    startup = rows.delay_table.gather(1, H.as_u32(draws) >> (32 - TABLE_BITS)) + 1
    return st.replace(
        startup=startup, timer_time=startup,
        max_clock=rows.max_clock, drop_u32=rows.drop_u32,
        sc_delay=rows.delay_table, sc_commit=rows.commit_chain.unsqueeze(1),
        adv_sched=rows.adv_sched, adv_link=rows.adv_link,
        adv_group=rows.adv_group, adv_heal=rows.adv_heal)


def init_slot(p: SimParams, row: ScenarioPlane, engine=None, device="cuda"):
    """One slot running ``row``'s scenario: a batch of one."""
    return init_rows(p, stack_rows([row]), engine=engine, device=device)


def init_specs(p: SimParams, specs, seeds=None, engine=None, device="cuda"):
    """A heterogeneous fleet straight from :class:`ScenarioSpec`s (seeds
    default to each spec's own ``seed``)."""
    specs = list(specs)
    if seeds is not None:
        specs = [dataclasses.replace(s, seed=int(sd)) for s, sd in zip(specs, seeds)]
    return init_rows(p, plane_rows(p, specs), engine=engine, device=device)


def install_rows(st, mask, donor):
    """Replace the masked slots of a fleet state with the donor's rows:
    ``torch.where`` on a ``[B]`` bool mask per leaf, written into the
    resident state.  A lane state's inbox leaves are views of routing
    buffers, so their masked rows are copied in place; every other leaf
    gets a new tensor.  ``donor`` is a fleet-shaped state (e.g. from
    :func:`init_specs`) whose masked rows hold the admitted scenarios.
    Halted slots are inert, so installing over them between runs never
    perturbs the live ones."""
    inbox = set(lane_ops.INBOX) if isinstance(st, lane_ops.PSimState) else set()
    mask = torch.as_tensor(mask, dtype=torch.bool, device=st.clock.device)
    idx = mask.nonzero().squeeze(1)

    def put(tree, new_tree):
        kw = {}
        for name in tree_fields(tree):
            old, new = getattr(tree, name), getattr(new_tree, name)
            if isinstance(old, Tree):
                kw[name] = put(old, new)
            elif name in inbox:
                old.index_copy_(0, idx, new.index_select(0, idx))
                kw[name] = old
            else:
                m = mask.reshape((mask.shape[0],) + (1,) * (old.dim() - 1))
                kw[name] = torch.where(m, new, old)
        return type(tree)(**kw)

    return put(st, donor)


def install_at(st, idx, rows):
    """Replace the slots ``idx`` of a fleet state with the rows of ``rows``,
    a state of ``len(idx)`` instances on the fleet's device (e.g. from
    :func:`init_rows`): what :func:`install_rows` does with a fleet-shaped
    donor holding these rows at ``idx``, without building that donor.  A
    lane state's inbox leaves are written in place into their routing
    buffers; every other leaf gets a new tensor."""
    inbox = set(lane_ops.INBOX) if isinstance(st, lane_ops.PSimState) else set()
    at = torch.as_tensor(np.asarray(idx, np.int64), device=st.clock.device)

    def put(tree, new_tree):
        kw = {}
        for name in tree_fields(tree):
            old, new = getattr(tree, name), getattr(new_tree, name)
            if isinstance(old, Tree):
                kw[name] = put(old, new)
            elif name in inbox:
                old.index_copy_(0, at, new)
                kw[name] = old
            else:
                kw[name] = old.index_copy(0, at, new)
        return type(tree)(**kw)

    return put(st, rows)
