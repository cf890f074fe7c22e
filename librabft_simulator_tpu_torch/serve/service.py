"""ResidentFleet: the never-exiting fleet loop with an admission queue; the
port of ``librabft_simulator_tpu/serve/service.py``.

A batch-mode fleet run is init -> run to global halt -> land results; a
service that many users submit scenarios to is continuously batched instead:

* one resident fleet of ``slots`` scenario-armed instances on a mesh
  (``parallel/mesh.py``), held by the sharded chunk runner
  (``parallel/sharded.make_sharded_run_fn``) between chunks; every slot
  starts halted and free;
* the host loop is ``run_sharded``'s double-buffered discipline (chunk k+1
  is dispatched before chunk k's ``[13]`` digest is polled: one read per
  chunk, ``sharded._poll_digest``), or under the params' ``wrap="device"`` the ring
  (one ``[ring_k, 13]`` read per outer call, ``sharded._poll_ring``), but it
  never exits: between chunks it reads the polled digest's ``halted`` count,
  egresses finished slots' results (request-tagged; only the finished rows
  land on the host, one gather per leaf and shard), pops pending
  :class:`ScenarioRequest`s and installs their rows into the freed slots
  (one ``init_rows`` call for the wave, then ``scenario.install_at``);
* the request lifecycle (submit -> admit -> first chunk -> egress) is
  recorded as runtime-ledger ``admit`` / ``egress`` spans and as
  ``kind="request"`` rows on the digest NDJSON stream.

Halted slots are inert (every engine write is gated on ``live``), so
installing over them between chunks leaves every live slot's trajectory
equal to an undisturbed run, leaf for leaf (tests/test_torch_serve.py).

Every read of device data the service makes goes through :func:`_host_read`
(the digest per polled chunk, the ring per outer call, the ``[slots]``
halted plane when the digest says an active slot halted, and the finished
rows); the ring's lagged halt reads are ``sharded._poll_halt``'s, counted by
``ledger.ring_stats``.  The port's meshes live in one process, so the JAX
package's multi-process branches (a cross-process gather of the halted
plane, per-host result landing, the refusal to save across processes) have
nothing to do here and are absent.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from collections import deque

import numpy as np
import torch

from ..core.types import SimParams
from ..parallel import mesh as mesh_ops
from ..parallel import sharded
from ..sim import byzantine
from ..sim import simulator as sim_ops
from ..telemetry import ledger as tledger
from ..telemetry import schema as tschema
from ..telemetry import stream as tstream
from ..utils import xops
from . import scenario as sc

#: Per-serve-call chunk ceiling: a runaway scenario (horizon never reached
#: because the caller admitted an effectively-unbounded max_clock) must not
#: wedge the host loop forever.
MAX_CHUNKS_DEFAULT = 10_000

#: Seed of the free slots' filler rows (pre-halted, never run).
_FILL_SEED = 0x5EAF


def _host_read(kind: str, fn, *args):
    """Every read of device data by the service, one seam: ``kind`` is
    ``"digest"`` (one ``[13]`` vector per polled chunk), ``"ring"`` (one
    ``[ring_k, 13]`` ring per outer call), ``"halted"`` (the ``[slots]``
    halted plane, read only when the digest says an active slot halted),
    ``"rows"`` (the finished rows at egress) or ``"state"`` (the whole
    fleet, by :meth:`ResidentFleet.save`).  Returns ``fn(*args)``."""
    return fn(*args)


@dataclasses.dataclass
class ScenarioRequest:
    """One queued scenario: id + spec + host-side lifecycle timestamps."""

    request_id: str
    spec: sc.ScenarioSpec
    submitted_t: float = 0.0
    admitted_t: float | None = None
    first_chunk_t: float | None = None
    egressed_t: float | None = None
    slot: int | None = None
    #: Global index of the first dispatched chunk whose INPUT holds this
    #: request's installed rows (admission at a boundary lands after the
    #: in-flight chunk, so the request's first executed chunk is the NEXT
    #: dispatch): first_chunk/ttfc stamp only once that chunk is polled,
    #: and _boundary uses it to ignore the digest lag.
    admit_dispatch: int | None = None

    @property
    def status(self) -> str:
        if self.egressed_t is not None:
            return "egressed"
        if self.admitted_t is not None:
            return "admitted"
        return "pending"

    def ttfc_s(self) -> float | None:
        """Admission-to-first-polled-chunk latency (the serving ttfc)."""
        if self.admitted_t is None or self.first_chunk_t is None:
            return None
        return round(self.first_chunk_t - self.admitted_t, 6)


class ResidentFleet:
    """A resident, continuously batched scenario-serving fleet.

    ``slots`` fleet slots (rounded up to the mesh size) start halted and
    free; :meth:`submit` queues scenarios; :meth:`serve` pumps the chunk
    loop until the queue and fleet drain (or ``max_chunks``); results land
    in :attr:`results` keyed by request id.  ``out`` streams the digest
    timeline + request rows as NDJSON.  ``mesh`` defaults to one shard on
    ``device``; ``engine`` is ``sim.simulator`` (default) or
    ``sim.parallel_sim``."""

    def __init__(self, p: SimParams, slots: int = 8, mesh=None, chunk: int = 64,
                 engine=None, out=None, fresh_state: bool = True, device="cuda"):
        self.engine = engine if engine is not None else sim_ops
        self.p = dataclasses.replace(p, scenario=True)
        # The params' wrap/ring_k pick the pump.  Under the device wrap,
        # admission/egress land only at outer-call boundaries, up to ring_k
        # chunks apart.
        rp = xops.resolve_params(self.p)
        self._ring_k = rp.ring_k if rp.wrap == "device" else None
        self.mesh = mesh if mesh is not None else mesh_ops.make_mesh(n_dp=1, devices=[device])
        self.slots = -(-slots // self.mesh.size) * self.mesh.size
        self._per = self.slots // self.mesh.size   # slot s is row s % per of shard s // per
        self.chunk = int(chunk)
        self._run = sharded.make_sharded_run_fn(self.p, self.mesh, self.chunk,
                                                engine=self.engine)
        # Per slot: whether its scenario can equivocate / forge a QC (the
        # chunk runner's skip flags are the OR over active slots, set from
        # the host rows at admission: no device read).
        self._byz = np.zeros((self.slots, 2), bool)
        self._run.set_flags((False, False))
        # All slots start as pre-halted knob-default rows: free capacity,
        # inert until a scenario is installed (``fresh_state=False`` is
        # restore()'s path: the checkpoint replaces them at once).
        if fresh_state:
            parts = []
            for i, dev in enumerate(self.mesh.flat):
                st = self.engine.init_batch(
                    self.p, sharded.fleet_seeds(_FILL_SEED, self._per, start=i * self._per),
                    device=dev)
                parts.append(st.replace(halted=torch.ones(self._per, dtype=torch.bool,
                                                          device=st.clock.device)))
            self._run.parts = parts
        self._pending: deque[ScenarioRequest] = deque()
        self._active: dict[int, ScenarioRequest] = {}
        self.requests: dict[str, ScenarioRequest] = {}
        self.results: dict[str, dict] = {}
        # The admission-queue lock: submit()/poll() may run on another
        # thread than the serve() pump, so every mutation of the
        # queue-facing state (_pending, requests, results) holds it.
        # _active and the slot bookkeeping stay serve-loop-private.
        self._qlock = threading.RLock()
        self.chunks_polled = 0
        # Global dispatch counter: equals chunks_polled between serve()
        # calls; mid-loop it is one ahead (the in-flight chunk), and the
        # dispatch-span labels and admit_dispatch indices ride it.
        self._dispatched = 0
        self._ids = itertools.count()
        self._t0 = time.perf_counter()
        self._recorder = tstream.TimelineRecorder(
            self.p, total_instances=self.slots, out=out,
            meta={"serve": True, "chunk": self.chunk, "slots": self.slots})
        self._lg = tledger.get()
        self._rid = self._lg.new_run(
            "resident_fleet", devices=self.mesh.size, instances=self.slots,
            pipeline=self._ring_k is None, chunk_steps=self.chunk,
            **({"ring_k": self._ring_k} if self._ring_k is not None else {}))

    # ------------------------------------------------------------------
    # Submission / inspection.
    # ------------------------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def submit(self, spec, request_id: str | None = None) -> str:
        """Queue one scenario; returns its request id."""
        if isinstance(spec, dict):
            spec = sc.ScenarioSpec.from_dict(spec)
        # The attack is checked against THIS fleet's params here, while the
        # queue is untouched: at admission it would raise mid-loop with
        # requests already popped.
        spec.adv_rows(self.p)
        with self._qlock:
            if request_id is not None:
                rid = request_id
            else:
                # Skip past restored ids: a resumed service's counter
                # restarts, and a collision would overwrite an old result.
                rid = f"r{next(self._ids)}"
                while rid in self.requests:
                    rid = f"r{next(self._ids)}"
            if rid in self.requests:
                raise ValueError(f"duplicate request id {rid!r}")
            req = ScenarioRequest(rid, spec, submitted_t=self._now())
            self._pending.append(req)
            self.requests[rid] = req
        self._emit_request(req, "submitted")
        return rid

    def poll(self, request_id: str) -> dict:
        """Status (and result, once egressed) of one request."""
        req = self.requests[request_id]
        out = {"request_id": request_id, "status": req.status,
               "slot": req.slot, "ttfc_s": req.ttfc_s()}
        if request_id in self.results:
            out["result"] = self.results[request_id]
        return out

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def steps_dispatched(self) -> int:
        """Event steps (windows, on the lane engine) dispatched per shard by
        this fleet object, a ring's chunk past the halt included."""
        k = sim_ops.macro_k_of(self._run.p) if self.engine is sim_ops else 1
        return self._run.dispatched * self.chunk * k

    def occupancy(self) -> dict:
        return {"slots": self.slots, "active": len(self._active),
                "free": self.slots - len(self._active),
                "pending": len(self._pending),
                "egressed": len(self.results)}

    def _emit_request(self, req: ScenarioRequest, event: str, **extra) -> None:
        self._recorder.emit({
            "kind": "request", "event": event, "id": req.request_id,
            "t_s": round(self._now(), 6), "slot": req.slot,
            "status": req.status, "ttfc_s": req.ttfc_s(),
            **self.occupancy(), **extra})

    # ------------------------------------------------------------------
    # The resident loop.
    # ------------------------------------------------------------------

    @torch.no_grad()
    def serve(self, max_chunks: int = MAX_CHUNKS_DEFAULT):
        """Pump the double-buffered chunk loop until the admission queue
        AND the fleet drain (graceful drain), or ``max_chunks`` chunks.
        Safe to call repeatedly: the resident state persists between
        calls."""
        # Pre-loop admission: free capacity is host-known, no read.
        self._admit()
        if self._ring_k is not None:
            return self._serve_ring(max_chunks)
        dg = self._dispatch()
        dispatched = 1
        while dispatched < max_chunks and (self._pending or self._active):
            dg_next = self._dispatch()           # dispatch k+1 ...
            d = self._poll_one(dg)               # ... then poll chunk k
            dg = dg_next
            dispatched += 1
            self._boundary(d)
        d = self._poll_one(dg)                   # the final in-flight chunk
        self._boundary(d)
        return self

    def _dispatch(self) -> "sharded._HostCopy":
        """Dispatch one chunk of every shard; its digest is copied to the
        host without blocking."""
        with self._lg.span(tledger.DISPATCH, run=self._rid, chunk=self._dispatched):
            copy = sharded._HostCopy(self._run.chunk())
        self._dispatched += 1
        return copy

    def _serve_ring(self, max_chunks: int):
        """The device-wrap pump: one outer call retires up to ``ring_k``
        chunks (stopping when the whole fleet halts), the host reads the
        ``[ring_k, 13]`` digest ring once, and admission/egress run at the
        outer-call boundary on the LAST retired chunk's digest.  No
        double-buffering: the boundary needs the freshest state."""
        dispatched, oi = 0, 0
        while dispatched < max_chunks and (self._pending or self._active):
            cap = min(self._ring_k, max_chunks - dispatched)
            with self._lg.span(tledger.DISPATCH, run=self._rid,
                               chunk=self._dispatched, outer=oi, cap=cap):
                ring, retired = self._run.ring(cap, self.slots, run=self._rid,
                                               chunk=self._dispatched)
            with self._lg.span(tledger.POLL, run=self._rid,
                               chunk=self._dispatched, outer=oi, cap=cap) as sp:
                rows, n = _host_read("ring", sharded._poll_ring, ring, retired)
                sp.attrs["retired"] = n
            self._dispatched += n
            dispatched += n
            oi += 1
            base = self.chunks_polled
            self.chunks_polled += n
            recs = self._recorder.record_ring(
                rows, n, steps=[(base + i + 1) * self.chunk for i in range(n)])
            # Sequential dispatch: every admission has run by this boundary.
            self._stamp_first_chunks(self.chunks_polled - 1)
            self._boundary(recs[-1])
        return self

    def drain(self, max_chunks: int = MAX_CHUNKS_DEFAULT) -> dict:
        """Graceful drain: serve until everything queued has egressed;
        returns ``results``."""
        self.serve(max_chunks=max_chunks)
        if self._pending or self._active:
            raise RuntimeError(
                f"drain incomplete after {max_chunks} chunks: "
                f"{len(self._pending)} pending, {len(self._active)} active "
                "(raise max_chunks, or a scenario's max_clock horizon is "
                "effectively unbounded)")
        return self.results

    def _poll_one(self, copy) -> dict:
        """The one blocking [13]-digest read per chunk (the run_sharded poll
        contract, through ``sharded._poll_digest``)."""
        with self._lg.span(tledger.POLL, run=self._rid, chunk=self.chunks_polled):
            vec = _host_read("digest", sharded._poll_digest, copy)
        self.chunks_polled += 1
        row = self._recorder.record(vec, steps=self.chunks_polled * self.chunk)
        self._stamp_first_chunks(self.chunks_polled - 1)
        return row

    def _stamp_first_chunks(self, polled: int) -> None:
        """first_chunk stamps only when a chunk that actually ran the
        request's rows has been polled: a boundary admission lands after
        the in-flight chunk, so the poll of that chunk (where the slot still
        ran halted) must not count."""
        t = self._now()
        for req in self._active.values():
            if (req.first_chunk_t is None and req.admitted_t is not None
                    and polled >= (req.admit_dispatch or 0)):
                req.first_chunk_t = t
                self._emit_request(req, "first_chunk")

    def _boundary(self, digest_row: dict) -> None:
        """Between-chunks work: egress finished slots, admit pending.

        The digest's ``halted`` count is the trigger: only when it says
        some ACTIVE slot halted (halted > free slots) does the host pay the
        one [slots] halted-plane read that identifies which."""
        free_before = self.slots - len(self._active)
        # Digest lag: the polled chunk predates any admission issued after
        # its dispatch, so slots admitted since then are still counted
        # halted by this digest; subtract them, or every admission wave
        # would trigger a spurious halted-plane read.
        polled = self.chunks_polled - 1
        stale = sum(1 for r in self._active.values()
                    if (r.admit_dispatch or 0) > polled)
        finished = int(digest_row["halted"]) - free_before - stale
        if finished > 0 and self._active:
            self._egress()
        if self._pending and len(self._active) < self.slots:
            self._admit()

    # ------------------------------------------------------------------
    # Egress.
    # ------------------------------------------------------------------

    def _fleet(self) -> mesh_ops.ShardedState:
        return mesh_ops.ShardedState(self.mesh, self._run.parts)

    def _halted_plane(self) -> np.ndarray:
        return np.concatenate([s.halted.cpu().numpy() for s in self._run.parts])

    def _egress(self) -> None:
        from ..distributed import egress as degress

        with self._lg.span(tledger.EGRESS, run=self._rid):
            halted = _host_read("halted", self._halted_plane)
            done = [s for s, req in sorted(self._active.items()) if bool(halted[s])]
            if not done:
                return
            # Land ONLY the finished rows: one gather per leaf and shard over
            # the k finished slots, never the whole fleet.
            _, rows = _host_read("rows", degress.local_rows, self._fleet(), done)
            reqs = [self._active[s] for s in done]
            summary = self._summaries(reqs, rows)
            self._byz[done] = False
            self._run.set_flags(self._byz.any(axis=0))
            for j, slot in enumerate(done):
                req = self._active.pop(slot)
                # A scenario that halts within its first executed chunk can
                # reach egress (this read sees the freshest state) before
                # the first_chunk stamp's condition holds: it demonstrably
                # ran, so stamp it here.
                if req.first_chunk_t is None and req.admitted_t is not None:
                    req.first_chunk_t = self._now()
                    self._emit_request(req, "first_chunk")
                req.egressed_t = self._now()
                res = self._result_of(req, rows, j, summary)
                with self._qlock:
                    self.results[req.request_id] = res
                self._emit_request(
                    req, "egressed",
                    latency_s=round(req.egressed_t - req.submitted_t, 6),
                    result=self.results.get(req.request_id))

    def _summaries(self, reqs, rows) -> dict:
        """The egressed rows' result columns on the host: safety with each
        request's honest mask (the reference check, row by row), counters,
        commits and watchdog trips."""
        honest = np.stack([r.spec.honest_mask(self.p) for r in reqs])
        return {
            "safe": byzantine.check_safety_reference(rows, honest),
            "events": rows.n_events.numpy(), "clock": rows.clock.numpy(),
            "commits": rows.ctx.commit_count.numpy(),
            "hcr": rows.store.hcr.reshape(len(reqs), -1).amax(dim=1).numpy(),
            "sent": rows.n_msgs_sent.numpy(), "dropped": rows.n_msgs_dropped.numpy(),
            "wd": rows.wd.reshape(len(reqs), -1).numpy(),
        }

    def _result_of(self, req: ScenarioRequest, rows, j: int, cols: dict) -> dict:
        """Per-request result summary from row ``j`` of the landed rows."""
        p = self.p
        prog = req.spec.attack_program()
        out = {
            "request_id": req.request_id,
            "spec": req.spec.to_dict(),
            "slot": req.slot,
            "events": int(cols["events"][j]),
            "clock": int(cols["clock"][j]),
            "commits": [int(c) for c in cols["commits"][j]],
            "committed_round_max": int(cols["hcr"][j]),
            "msgs_sent": int(cols["sent"][j]),
            "msgs_dropped": int(cols["dropped"][j]),
            "safe": bool(cols["safe"][j]),
            "ttfc_s": req.ttfc_s(),
        }
        if p.watchdog:
            # The slot's in-graph trip counters: the per-request safety and
            # liveness verdict (telemetry/stream.py WD_SLOTS).
            wd = cols["wd"][j]
            trips = {name: int(wd[tstream.WD_SLOTS.index(name)])
                     for name in tstream.WD_DETECTORS}
            out["watchdog"] = dict(
                trips,
                safety_ok=(trips["safety_conflict"] == 0
                           and trips["round_regress"] == 0),
                liveness_ok=trips["stall"] == 0)
        if prog is not None:
            # The decoded attack program rides the result row: what exactly
            # this slot was subjected to, independent of the request file.
            out["attack"] = prog.host_plane(p).describe()
        if p.telemetry:
            from ..telemetry import report as tel_report

            out["telemetry"] = tel_report.metrics_dict(p, rows, instance=j)
        return out

    # ------------------------------------------------------------------
    # Admission.
    # ------------------------------------------------------------------

    def _admit(self) -> None:
        """Install up to free-slot-count pending scenarios: the wave's rows
        from ONE ``init_rows`` call over its stacked plane rows, written into
        the freed slots of each shard (``scenario.install_at``)."""
        free = [s for s in range(self.slots) if s not in self._active]
        with self._qlock:
            k = min(len(free), len(self._pending))
            if k == 0:
                return
            taken = [self._pending.popleft() for _ in range(k)]
        with self._lg.span(tledger.ADMIT, run=self._rid, requests=k):
            slots = free[:k]
            plane = sc.plane_rows(self.p, [req.spec for req in taken])
            self._install(np.asarray(slots), plane)
            self._byz[slots] = sim_ops.byz_rows(self.p, plane).numpy()
            self._run.set_flags(self._byz.any(axis=0))
            for slot, req in zip(slots, taken):
                req.slot = slot
                self._active[slot] = req
            t = self._now()
            for req in taken:
                req.admitted_t = t
                req.admit_dispatch = self._dispatched
                self._emit_request(req, "admitted")

    def _install(self, slots: np.ndarray, plane) -> None:
        """The rows of ``plane`` (one per slot of ``slots``) built on the
        first receiving shard's device and written into each shard."""
        parts = self._run.parts
        shard = slots // self._per
        rows = sc.init_rows(self.p, plane, engine=self.engine,
                            device=parts[int(shard[0])].clock.device)
        for j in np.unique(shard):
            sel = np.flatnonzero(shard == j)
            dev = parts[j].clock.device
            mine = rows if len(sel) == len(slots) else sim_ops.select_instances(rows, sel)
            if mine.clock.device != dev:
                mine = mesh_ops.rows_of(mine, 0, len(sel), dev)
            parts[j] = sc.install_at(parts[j], slots[sel] % self._per, mine)

    # ------------------------------------------------------------------
    # Checkpoint-based preemption / eviction.
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        """Preemption-safe eviction: the resident state checkpoints through
        sim/checkpoint.py (the JAX package's keys) and the serve bookkeeping
        (slot table, pending specs, finished results) lands in a JSON
        sidecar ``<path>.serve.json``; :meth:`restore` resumes it and every
        live slot continues bit for bit."""
        from ..sim import checkpoint as ckpt

        ckpt.save(path, _host_read("state", mesh_ops.concat, self._run.parts, "cpu"))

        def req_dict(r: ScenarioRequest) -> dict:
            return {"request_id": r.request_id, "spec": r.spec.to_dict(),
                    "slot": r.slot, "status": r.status}

        # The queue-facing state is read under the admission lock: an
        # operator thread may be submit()ing while eviction saves.
        with self._qlock:
            side = {
                "serve_version": tschema.SERVE_VERSION,
                "slots": self.slots,
                "chunk": self.chunk,
                # Informational: the dispatch wrap is not pinned by the
                # checkpoint; the restore params decide.
                "ring_k": self._ring_k,
                "chunks_polled": self.chunks_polled,
                "active": {str(s): req_dict(r)
                           for s, r in self._active.items()},
                "pending": [req_dict(r) for r in self._pending],
                "results": dict(self.results),
            }
        with open(path + ".serve.json", "w") as f:
            json.dump(side, f, indent=1)

    @classmethod
    def restore(cls, path: str, p: SimParams, mesh=None, engine=None,
                out=None, device="cuda") -> "ResidentFleet":
        """Resume a preempted service from :meth:`save`'s artifact pair."""
        from ..sim import checkpoint as ckpt

        with open(path + ".serve.json") as f:
            side = json.load(f)
        tschema.require_serve_version(side.get("serve_version"),
                                      what=f"{path}.serve.json")
        svc = cls(p, slots=side["slots"], mesh=mesh, chunk=side["chunk"],
                  engine=engine, out=out, fresh_state=False, device=device)
        # Loaded on the host, each shard's rows then placed on its device.
        host = ckpt.load(path, svc.p, device="cpu")
        active = np.asarray(sorted(int(s) for s in side.get("active", {})), np.int64)
        if len(active):
            svc._byz[active] = sim_ops.byz_rows(
                svc.p, sim_ops.select_instances(host, active)).numpy()
        svc._run.set_flags(svc._byz.any(axis=0))
        svc._run.parts = mesh_ops.shard_batch(svc.mesh, host).shards
        svc.chunks_polled = int(side.get("chunks_polled", 0))
        svc._dispatched = svc.chunks_polled
        svc.results = dict(side.get("results", {}))
        # Egressed requests re-register too (their spec rides the saved
        # result): poll() keeps answering for them after a resume, and the
        # duplicate-id guards see their ids.
        for rid, res in svc.results.items():
            req = ScenarioRequest(
                rid, sc.ScenarioSpec.from_dict(res["spec"]),
                slot=res.get("slot"), admitted_t=0.0, first_chunk_t=0.0,
                egressed_t=0.0)
            svc.requests[rid] = req
        for s, rd in side.get("active", {}).items():
            req = ScenarioRequest(
                rd["request_id"], sc.ScenarioSpec.from_dict(rd["spec"]),
                slot=int(s), admitted_t=0.0, first_chunk_t=0.0)
            svc._active[int(s)] = req
            svc.requests[req.request_id] = req
        for rd in side.get("pending", []):
            req = ScenarioRequest(
                rd["request_id"], sc.ScenarioSpec.from_dict(rd["spec"]))
            svc._pending.append(req)
            svc.requests[req.request_id] = req
        return svc

    def close(self) -> None:
        self._recorder.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
