"""The attack-program DSL: the port's own copy of
``librabft_simulator_tpu/adversary/dsl.py`` (numpy and plain Python; its
rows and its error messages are the JAX package's).

An :class:`AttackProgram` composes time-, event- or epoch-windowed
behaviors (:class:`Window`), a partition that heals (:class:`Partition`)
and a per-link extra-delay matrix.  Everything is validated on the host
(capacities, node ids, delay caps); :meth:`AttackProgram.lower` gives the
numpy rows of one instance's ``adv_*`` leaves, so a program is data:
``install`` stamps it onto every instance of a state, and a fleet takes one
program per slot through ``serve/scenario.py``.

Grammar (``AttackProgram.from_dict``)::

    {"windows": [{"behavior": "equivocate", "mode": "time",
                  "start": 100, "end": 400, "targets": [0]},
                 {"behavior": "delay_leader", "start": 0, "end": 800,
                  "arg": 25}],
     "partition": {"groups": [[0, 1], [2, 3]], "heal": 300},
     "link_delay": [[0, 5, 5, 5], [1, 0, 1, 1],
                    [1, 1, 0, 1], [1, 1, 1, 0]]}

A window's behavior applies to its ``targets`` (omitted: every node) while
its key (event time, ``mode="time"``, the default; the instance's event
count, ``"events"``, which the lane engine reads at the window start; or
the handled node's epoch, ``"epoch"``) lies in ``[start, end)``.
``equivocate`` / ``silent`` / ``forge_qc`` OR onto the static Byzantine
masks; ``delay`` adds ``arg`` to messages to the targeted receivers and
``delay_leader`` to messages to the sender's current-round leader
(overlapping delay windows compose by max).  ``link_delay[s][r]`` adds to
every message on that link; partition groups drop every crossing message
sent before ``heal``.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ..core.types import NEVER, SimParams
from . import plane

#: Windowable behaviors (BEH_NONE is the inert padding row, not a verb).
WINDOW_BEHAVIORS = tuple(b for b in plane.BEHAVIORS if b != "none")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class Window:
    """One windowed behavior: ``behavior`` applies to ``targets`` while
    the ``mode`` key is in ``[start, end)``.  ``targets=None`` = every
    node (``delay_leader`` ignores targets — the leader is the target);
    ``arg`` is the delay amount for the delay behaviors."""

    behavior: str
    start: int = 0
    end: int = int(NEVER)
    mode: str = "time"
    targets: tuple[int, ...] | None = None
    arg: int = 0

    def __post_init__(self):
        _require(self.behavior in WINDOW_BEHAVIORS,
                 f"unknown behavior {self.behavior!r}; want one of "
                 f"{WINDOW_BEHAVIORS}")
        _require(self.mode in plane.MODES,
                 f"unknown window mode {self.mode!r}; want one of "
                 f"{plane.MODES}")
        _require(0 <= self.start <= self.end <= int(NEVER),
                 f"window bounds must satisfy 0 <= start <= end <= NEVER "
                 f"(got [{self.start}, {self.end}))")
        _require(0 <= self.arg <= plane.DELAY_CAP,
                 f"window arg {self.arg} outside [0, {plane.DELAY_CAP}] "
                 "(adversarial delays are capped so int32 clocks cannot "
                 "wrap)")
        if self.targets is not None:
            object.__setattr__(self, "targets",
                               tuple(int(t) for t in self.targets))

    def validate(self, p: SimParams) -> None:
        for t in self.targets or ():
            _require(0 <= t < p.n_nodes,
                     f"window target {t} outside 0..{p.n_nodes - 1}")

    def _row(self, p: SimParams) -> list[int]:
        if self.targets is None:
            mask = (1 << p.n_nodes) - 1
        else:
            mask = 0
            for t in self.targets:
                mask |= 1 << t
        lo32 = mask & 0xFFFFFFFF
        hi32 = (mask >> 32) & 0xFFFFFFFF
        # numpy int32 rows: re-express the top bit as the two's-complement
        # value the device mask decode reads back bit-exactly.
        as_i32 = lambda u: u - (1 << 32) if u >= (1 << 31) else u  # noqa: E731
        return [plane.MODES.index(self.mode), int(self.start),
                int(min(self.end, int(NEVER))),
                plane.BEHAVIORS.index(self.behavior),
                as_i32(lo32), as_i32(hi32), int(self.arg)]


@dataclasses.dataclass(frozen=True)
class Partition:
    """Group assignment + heal time: messages crossing groups before
    ``heal`` are cut.  Nodes not listed in any group share one implicit
    extra group (they see each other, and nobody else, until heal)."""

    groups: tuple[tuple[int, ...], ...]
    heal: int = int(NEVER)

    def __post_init__(self):
        object.__setattr__(self, "groups",
                           tuple(tuple(int(n) for n in g)
                                 for g in self.groups))
        _require(0 <= self.heal <= int(NEVER),
                 f"heal time {self.heal} outside [0, NEVER]")
        seen: set[int] = set()
        for g in self.groups:
            for n in g:
                _require(n not in seen,
                         f"node {n} appears in two partition groups")
                seen.add(n)

    def validate(self, p: SimParams) -> None:
        for g in self.groups:
            for n in g:
                _require(0 <= n < p.n_nodes,
                         f"partition node {n} outside 0..{p.n_nodes - 1}")

    def assignment(self, p: SimParams) -> np.ndarray:
        group = np.full((p.n_nodes,), len(self.groups), np.int32)
        for gi, g in enumerate(self.groups):
            for n in g:
                group[n] = gi
        return group


@dataclasses.dataclass(frozen=True)
class AttackProgram:
    """A composed attack: windows + optional partition + optional
    per-link delay matrix.  ``lower(p)`` emits the ``adv_*`` plane rows;
    ``install(p, st)`` stamps them onto an engine state."""

    windows: tuple[Window, ...] = ()
    partition: Partition | None = None
    link_delay: tuple[tuple[int, ...], ...] | None = None

    def __post_init__(self):
        object.__setattr__(self, "windows", tuple(self.windows))
        if self.link_delay is not None:
            object.__setattr__(
                self, "link_delay",
                tuple(tuple(int(v) for v in row) for row in self.link_delay))

    def validate(self, p: SimParams) -> None:
        _require(p.adversary,
                 "attack programs need SimParams.adversary=True (the "
                 "adv_* plane leaves are zero-width otherwise)")
        _require(p.n_nodes <= 64,
                 f"attack-schedule target masks cover 64 authors "
                 f"(n_nodes={p.n_nodes})")
        _require(len(self.windows) <= p.adv_windows,
                 f"{len(self.windows)} windows exceed the plane capacity "
                 f"SimParams.adv_windows={p.adv_windows}")
        for w in self.windows:
            w.validate(p)
        if self.partition is not None:
            self.partition.validate(p)
        if self.link_delay is not None:
            _require(
                len(self.link_delay) == p.n_nodes
                and all(len(r) == p.n_nodes for r in self.link_delay),
                f"link_delay must be an {p.n_nodes}x{p.n_nodes} matrix")
            for row in self.link_delay:
                for v in row:
                    _require(0 <= v <= plane.DELAY_CAP,
                             f"link delay {v} outside "
                             f"[0, {plane.DELAY_CAP}]")

    def lower(self, p: SimParams) -> dict:
        """One instance's plane rows (numpy, the ``adv_*`` leaves' shapes
        without the batch dim): validate,
        stamp each window into ``adv_sched``, the matrix into
        ``adv_link``, the partition into ``adv_group``/``adv_heal``.
        Unused window rows stay the inert all-zero row."""
        self.validate(p)
        rows = plane.default_rows(p)
        for i, w in enumerate(self.windows):
            rows["adv_sched"][i] = np.asarray(w._row(p), np.int32)
        if self.link_delay is not None:
            rows["adv_link"][:] = np.asarray(self.link_delay, np.int32)
        if self.partition is not None:
            rows["adv_group"][:] = self.partition.assignment(p)
            rows["adv_heal"][0] = min(self.partition.heal, int(NEVER))
        return rows

    def install(self, p: SimParams, st):
        """Stamp this program onto every instance of a port state (a
        ``SimState`` or ``PSimState`` with the plane armed): the ``adv_*``
        leaves become its rows, ``[B]`` copies on the state's device.  A
        fleet with one program per slot is built by serve/scenario.py."""
        rows = self.lower(p)
        b, dev = st.clock.shape[0], st.clock.device
        return st.replace(**{
            k: torch.as_tensor(v, device=dev).expand((b,) + v.shape).contiguous()
            for k, v in rows.items()})

    def host_plane(self, p: SimParams) -> plane.HostPlane:
        """The oracle-side decode twin of exactly these lowered rows."""
        rows = self.lower(p)
        return plane.HostPlane(rows["adv_sched"], rows["adv_link"],
                               rows["adv_group"], rows["adv_heal"])

    # -- wire form ---------------------------------------------------------

    def to_dict(self) -> dict:
        out: dict = {"windows": [
            {k: v for k, v in dataclasses.asdict(w).items()
             if v is not None} for w in self.windows]}
        if self.partition is not None:
            out["partition"] = {"groups": [list(g) for g in
                                           self.partition.groups],
                                "heal": self.partition.heal}
        if self.link_delay is not None:
            out["link_delay"] = [list(r) for r in self.link_delay]
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "AttackProgram":
        """Parse the NDJSON/request form; unknown keys fail loud (a
        typo'd field must not silently weaken an attack)."""
        _require(isinstance(d, dict), "attack program must be an object")
        known = {"windows", "partition", "link_delay"}
        extra = set(d) - known
        _require(not extra,
                 f"unknown attack field(s) {sorted(extra)}; known: "
                 f"{sorted(known)}")
        wins = []
        wkeys = {f.name for f in dataclasses.fields(Window)}
        for i, wd in enumerate(d.get("windows", ())):
            _require(isinstance(wd, dict), f"windows[{i}] must be an object")
            wextra = set(wd) - wkeys
            _require(not wextra,
                     f"windows[{i}]: unknown field(s) {sorted(wextra)}; "
                     f"known: {sorted(wkeys)}")
            wd = dict(wd)
            if wd.get("targets") is not None:
                wd["targets"] = tuple(wd["targets"])
            wins.append(Window(**wd))
        part = None
        if d.get("partition") is not None:
            pd = d["partition"]
            _require(isinstance(pd, dict), "partition must be an object")
            pextra = set(pd) - {"groups", "heal"}
            _require(not pextra,
                     f"partition: unknown field(s) {sorted(pextra)}")
            part = Partition(groups=tuple(tuple(g) for g in pd["groups"]),
                             **({"heal": pd["heal"]} if "heal" in pd else {}))
        link = d.get("link_delay")
        return cls(windows=tuple(wins), partition=part,
                   link_delay=(tuple(tuple(r) for r in link)
                               if link is not None else None))


# ---------------------------------------------------------------------------
# Sweep front-end: parameter grids + seedable random programs.
# ---------------------------------------------------------------------------


def sweep(p: SimParams, *, behaviors=("equivocate", "silent"),
          starts=(0,), durations=(int(NEVER),), targets=((0,),),
          modes=("time",), args=(0,), partitions=(None,),
          link_delays=(None,)):
    """The grid front-end: the cartesian product of single-window attack
    parameters (x partition x link matrix), each yielded as a VALIDATED
    :class:`AttackProgram` (feed them to a fleet through
    serve/scenario.py).  Lazily generated, so a million-point grid costs
    nothing until consumed."""
    for beh, s, dur, tgt, mode, arg, part, link in itertools.product(
            behaviors, starts, durations, targets, modes, args,
            partitions, link_delays):
        prog = AttackProgram(
            windows=(Window(behavior=beh, start=s,
                            end=min(s + dur, int(NEVER)), mode=mode,
                            targets=tuple(tgt) if tgt is not None else None,
                            arg=arg),),
            partition=part, link_delay=link)
        prog.validate(p)
        yield prog


def sample_program(p: SimParams, rng, max_windows: int | None = None,
                   f_max: int | None = None, horizon: int = 1000,
                   p_partition: float = 0.3,
                   p_link: float = 0.4) -> AttackProgram:
    """One seedable random attack program (the JAX package's fuzz
    generator, draw for draw): 1..max_windows random windows whose Byzantine behaviors
    target at most ``f_max`` distinct nodes (so the safety invariant
    stays checkable against the honest remainder), plus an optional
    random partition-with-heal and per-link matrix."""
    n = p.n_nodes
    if f_max is None:
        f_max = max((n - 1) // 3, 0)
    if max_windows is None:
        max_windows = p.adv_windows
    byz_pool = rng.sample(range(n), f_max) if f_max else []
    wins = []
    for _ in range(rng.randrange(1, max_windows + 1)):
        beh = rng.choice(WINDOW_BEHAVIORS)
        mode = rng.choice(["time", "time", "events", "epoch"])
        if mode == "time":
            lo = rng.randrange(0, horizon)
            hi = min(lo + rng.randrange(1, horizon), int(NEVER))
        elif mode == "events":
            lo = rng.randrange(0, 400)
            hi = lo + rng.randrange(1, 800)
        else:
            lo, hi = 0, rng.randrange(1, 3)
        if beh in ("equivocate", "silent", "forge_qc"):
            if not byz_pool:
                continue
            tgt = tuple(rng.sample(byz_pool,
                                   rng.randrange(1, len(byz_pool) + 1)))
            arg = 0
        elif beh == "delay":
            tgt = tuple(rng.sample(range(n), rng.randrange(1, n + 1)))
            arg = rng.randrange(1, 60)
        else:  # delay_leader
            tgt = None
            arg = rng.randrange(1, 60)
        wins.append(Window(behavior=beh, start=lo, end=hi, mode=mode,
                           targets=tgt, arg=arg))
    part = None
    if rng.random() < p_partition and n >= 2:
        cutpoint = rng.randrange(1, n)
        ids = list(range(n))
        rng.shuffle(ids)
        part = Partition(
            groups=(tuple(ids[:cutpoint]), tuple(ids[cutpoint:])),
            heal=rng.choice([0, horizon // 4, horizon // 2, int(NEVER)]))
    link = None
    if rng.random() < p_link:
        link = tuple(tuple(0 if i == j else rng.randrange(0, 20)
                           for j in range(n)) for i in range(n))
    prog = AttackProgram(windows=tuple(wins), partition=part,
                         link_delay=link)
    prog.validate(p)
    return prog


def byz_targets(program: AttackProgram) -> set[int]:
    """Every node a Byzantine-behavior window (equivocate/silent/
    forge_qc) can activate — the complement is the honest mask safety
    checks run against."""
    out: set[int] = set()
    for w in program.windows:
        if w.behavior in ("equivocate", "silent", "forge_qc"):
            if w.targets is None:
                return set(range(64))
            out |= set(w.targets)
    return out
