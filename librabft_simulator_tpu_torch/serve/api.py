"""Serving API: submit / poll / drain as a library, NDJSON at the edges; the
port of ``librabft_simulator_tpu/serve/api.py``.

:class:`FleetService` is the operator-facing wrapper over
:class:`~librabft_simulator_tpu_torch.serve.service.ResidentFleet`: NDJSON
request-file ingestion (:func:`load_requests`, the ``serve.cli`` front end),
result emission, and checkpoint-based preemption.  The port reads no
environment variable: the JAX package's ``LIBRABFT_SERVE_*`` knobs are the
constructor's arguments, whose defaults are that package's unset defaults
(8 slots, 64-step chunks, no stream file, the base params' own dispatch
wrap).

Request schema (one JSON object per line)::

    {"id": "req-1", "delay_kind": "pareto", "delay_pareto_scale": 2.0,
     "drop_prob": 0.05, "commit_chain": 2, "byz_kind": "silent",
     "byz_f": 1, "seed": 7, "max_clock": 1200,
     "attack": {"windows": [{"behavior": "equivocate", "start": 100,
                             "end": 400, "targets": [0]}],
                "partition": {"groups": [[0, 1], [2, 3]], "heal": 300}}}

Every field except ``id`` is a :class:`serve.scenario.ScenarioSpec` field
(all optional: defaults are the base params' scenario); unknown fields
fail loud.  ``attack`` takes the adversary/dsl.py program grammar and
needs an adversary-armed base (``SimParams.adversary=True``); the egressed
result then carries the decoded program and, with the watchdog armed, the
per-request safety/liveness trip counts.
"""

from __future__ import annotations

import json

from ..core.types import SimParams
from . import scenario as sc
from .service import ResidentFleet

#: The JAX package's defaults when its LIBRABFT_SERVE_SLOTS /
#: LIBRABFT_SERVE_CHUNK are unset.
SLOTS_DEFAULT = 8
CHUNK_DEFAULT = 64


def load_requests(path: str):
    """Read an NDJSON request file -> ``[(id, ScenarioSpec), ...]``.

    ``id`` defaults to the 1-based line number; malformed lines and
    unknown scenario fields raise with the offending line number (a typo
    must not silently run the default scenario)."""
    out = []
    seen: dict[str, int] = {}
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not JSON ({e})") from None
            if not isinstance(obj, dict):
                raise ValueError(f"{path}:{i}: want a JSON object per line")
            rid = str(obj.pop("id", i))
            if rid in seen:
                raise ValueError(
                    f"{path}:{i}: duplicate request id {rid!r} (first at "
                    f"line {seen[rid]}); ids key the result stream")
            seen[rid] = i
            try:
                spec = sc.ScenarioSpec.from_dict(obj)
            except (TypeError, ValueError) as e:
                raise ValueError(f"{path}:{i}: {e}") from None
            out.append((rid, spec))
    if not out:
        raise ValueError(f"{path}: no requests (empty or comments only)")
    return out


class FleetService:
    """submit/poll/drain over a resident fleet.

    ``base_params`` fixes the structural shape every scenario shares
    (n_nodes, capacities); per-request knobs ride the scenario plane.
    ``device`` places the default one-shard mesh (``"cuda"``, or ``"cpu"``
    when asked for)."""

    def __init__(self, base_params: SimParams | None = None,
                 slots: int | None = None, chunk: int | None = None,
                 mesh=None, engine=None, out: str | None = None, device="cuda"):
        self.p = base_params if base_params is not None else SimParams(n_nodes=4)
        self.fleet = ResidentFleet(
            self.p,
            slots=slots if slots is not None else SLOTS_DEFAULT,
            chunk=chunk if chunk is not None else CHUNK_DEFAULT,
            mesh=mesh, engine=engine, out=out, device=device)

    def submit(self, spec, request_id: str | None = None) -> str:
        return self.fleet.submit(spec, request_id=request_id)

    def submit_file(self, path: str) -> list[str]:
        """Queue every request of an NDJSON file; returns the ids."""
        return [self.fleet.submit(spec, request_id=rid)
                for rid, spec in load_requests(path)]

    def poll(self, request_id: str) -> dict:
        return self.fleet.poll(request_id)

    def serve(self, max_chunks: int | None = None):
        kw = {} if max_chunks is None else {"max_chunks": max_chunks}
        self.fleet.serve(**kw)
        return self

    def drain(self, max_chunks: int | None = None) -> dict:
        kw = {} if max_chunks is None else {"max_chunks": max_chunks}
        return self.fleet.drain(**kw)

    def preempt(self, path: str) -> None:
        """Checkpoint-based eviction: persist the resident state + serve
        bookkeeping (``path`` and ``path + ".serve.json"``)."""
        self.fleet.save(path)

    @classmethod
    def resume(cls, path: str, base_params: SimParams, mesh=None,
               engine=None, out: str | None = None, device="cuda") -> "FleetService":
        """A service restored from :meth:`preempt`'s files; ``base_params``'
        wrap and ring_k decide its pump."""
        svc = cls.__new__(cls)
        svc.p = base_params
        svc.fleet = ResidentFleet.restore(path, base_params, mesh=mesh, engine=engine,
                                          out=out, device=device)
        return svc

    def close(self) -> None:
        self.fleet.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
