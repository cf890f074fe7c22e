"""Sharded fleet runtime: dp over instances, mp over the author dimension.
The port of ``librabft_simulator_tpu/parallel/sharded.py``.

* **Fleet semantics**: :func:`pad_to_multiple` pads the batch to the mesh
  size with pre-halted instances (every engine write is gated on
  ``live = ~halted``, so padding adds no event, message or plane count);
  :func:`fleet_seeds` derives per-instance seeds from one base seed and the
  global instance index, so a fleet is the same however it is sharded.
* **Chunk runner** (:func:`make_sharded_run_fn`): ``wrap="shard_map"`` runs
  the engine's chunk runner (``make_scan_fn``) on every shard, each on its
  own device with its own buffers, and folds the shards' ``[13]`` digests on
  the first shard's device (telemetry/stream.py::merge_digests) with no
  host fetch.  The port has no partitioner: ``wrap="jit"`` runs the fleet as
  one batch on the mesh's first device, which gives the same result by
  construction.
* **Host loop** (:func:`run_sharded`): pipelined by default, chunk k+1 is
  dispatched before chunk k's digest is read; each digest is copied to
  pinned host memory without blocking, behind a CUDA event, and the host
  waits on that event only when it polls (:func:`_poll_digest`, one ``[13]``
  vector per chunk).  ``SimParams.wrap="device"`` retires up to ``ring_k``
  chunks per outer call into a ``[ring_k, 13]`` digest ring on the device
  and fetches it once (:func:`_poll_ring`).  Eager PyTorch has no graph
  loop to stop in, so before each further chunk of an outer call the host
  reads a lagged ``halted`` slot (:func:`_poll_halt`, a 4-byte copy started
  without blocking).  The ring thus keeps one host read per chunk and cuts
  the host's waits on the device to one per outer call, plus any halt read
  whose copy had not landed (``ledger.ring_stats`` counts both).
* **mp**: the quorum sites sum over the author group that each shard's
  chunk binds (core/config.py); the runtime refuses ``mp_authors`` on a
  mesh with n_mp > 1, where the batch would split over mp too.
  :func:`sharded_count_votes` / :func:`sharded_quorum_reached` sum an
  author-split mask over the mesh's mp shards.

Every loop records its spans on the runtime ledger (telemetry/ledger.py).
A device may hold several shards (parallel/mesh.py): that is how these paths
run on the CPU and on one card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config
from ..sim import parallel_sim as P, simulator as S
from ..telemetry import ledger as tledger, stream as tstream
from ..utils import hashing as H
from ..utils.xops import resolve_params
from . import mesh as mesh_ops
from .mesh import AXES, Mesh, ShardedState

#: Salt of the padding instances' seeds (golden-ratio constant): a padded
#: fleet never takes a real instance's rng stream.
_PAD_SALT = 0x9E3779B9

#: The digest slot the halt polls read.
HALTED = [name for name, _ in tstream.DIGEST_SLOTS].index("halted")


def fleet_seeds(base_seed: int, n: int, start: int = 0) -> np.ndarray:
    """Per-instance seeds from one base seed: instance *i*'s is
    ``mix32(base_seed, start + i)``, a function of the global index only,
    so every dp layout gets the same streams (uint32)."""
    idx = torch.arange(start, start + n, dtype=torch.int64)
    return H.mix32(base_seed, idx).numpy().view(np.uint32)


def batch_size(state) -> int:
    """Leading (instance) dim of a batched engine state or sharded fleet."""
    return state.batch if isinstance(state, ShardedState) else state.clock.shape[0]


def pad_to_multiple(p, state, multiple: int, engine=None):
    """Pad the batch to a multiple of ``multiple`` with pre-halted instances
    on the state's device (a CPU state pads on the host); returns
    ``(padded_state, n_valid)``.  The filler instances come from
    :data:`_PAD_SALT` seeds at global indices ``b, b + 1, ...``, made by
    ``engine`` (default: the engine of the state)."""
    b = batch_size(state)
    pad = (-b) % max(int(multiple), 1)
    if pad == 0:
        return state, b
    if isinstance(state, ShardedState):
        state = mesh_ops.concat(state.shards, "cpu")
    eng = engine if engine is not None else (P if isinstance(state, P.PSimState) else S)
    dev = state.clock.device
    filler = eng.init_batch(p, fleet_seeds(_PAD_SALT, pad, start=b), device=dev)
    filler = filler.replace(halted=torch.ones(pad, dtype=torch.bool, device=dev))
    return mesh_ops.concat([state, filler], dev), b


def unpad(state, n_valid: int):
    """Drop the padding instances of :func:`pad_to_multiple`.  A sharded
    fleet lands on the host (CPU tensors), shard by shard: its trimmed batch
    no longer tiles the mesh, and the post-run state is for reports and
    checkpoints (``checkpoint.load_sharded`` places a host state on a mesh
    again).  A plain state keeps its device."""
    if batch_size(state) == n_valid:
        return state
    if isinstance(state, ShardedState):
        return mesh_ops.concat(state.shards, "cpu", stop=n_valid)
    return mesh_ops.rows_of(state, 0, n_valid, state.clock.device)


class _HostCopy:
    """A device tensor copied to the host without blocking: into pinned
    memory behind a CUDA event on the card, a plain copy on the CPU."""

    def __init__(self, x: torch.Tensor):
        self.event = None
        if x.is_cuda:
            self.buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.buf.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(x.device))
        else:
            self.buf = x.clone()

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def value(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.buf


class _Runner:
    """The sharded chunk runner of :func:`make_sharded_run_fn`.  It holds
    the fleet while a loop runs (``parts``: one state per shard, for
    ``wrap="jit"`` one state on the first device), so that each state has
    one owner and is freed as soon as its next chunk replaces it, as JAX
    donates a chunk's buffers.  ``dispatched`` counts the chunks run.
    ``flags`` are the Byzantine skip flags of the chunks (None: read from
    the shards when the first chunk runs); :meth:`set_flags` changes them
    between chunks."""

    def __init__(self, p, mesh: Mesh, num_steps: int, eng, wrap: str):
        self.p, self.mesh, self.num_steps, self.eng, self.wrap = p, mesh, num_steps, eng, wrap
        self.axes = AXES if wrap == "shard_map" else ()
        self.dispatched = 0
        self.parts = None
        self.flags = None
        self._scans = None

    def set_flags(self, flags) -> None:
        """Run the next chunks with the skip flags ``flags`` ((any_equivocate,
        any_forge)); the chunk runners are rebuilt only if they change."""
        flags = tuple(bool(f) for f in flags)
        if flags != self.flags:
            self.flags, self._scans = flags, None

    def chunk(self) -> torch.Tensor:
        """One chunk of every shard; returns the fleet's [13] digest on the
        first shard's device."""
        parts = self.parts
        if self._scans is None:
            self._scans = [self.eng.make_scan_fn(self.p, self.num_steps, s, flags=self.flags)
                           for s in parts]
        with config.bound_axes(self.axes):
            for j, run in enumerate(self._scans):
                parts[j] = run(parts[j])
        self.dispatched += 1
        return tstream.merge_digests([tstream.compute_digest(self.p, s) for s in parts])

    def ring(self, cap: int, total: int, run=None, chunk: int = 0):
        """``wrap="device"``: retire up to ``cap`` chunks, each chunk's digest
        into row ``retired`` of a ``[ring_k, 13]`` int32 ring on the first
        shard's device; ``retired`` counts the chunks up to and including the
        first whose ``halted`` slot reaches ``total``, as JAX's in-graph loop
        counts them.  The device decides what is retired; the host only stops
        dispatching.  Before each chunk after the first it reads a chunk's
        halted slot (:func:`_poll_halt`, a ``halt_poll`` span on the ledger
        with ``run`` and the index ``chunk`` + i of the chunk it gates), so it
        runs at most one chunk past the halt.  That chunk changes no state
        (writes are gated on ``live``) and its digest is not written.
        Returns (ring, retired)."""
        dev = self.parts[0].clock.device
        ring = torch.zeros((self.p.ring_k, tstream.DIGEST_WIDTH), dtype=torch.int32, device=dev)
        retired = torch.zeros((), dtype=torch.int32, device=dev)
        alive = torch.ones((), dtype=torch.bool, device=dev)
        lg = tledger.get()
        seen = []
        for i in range(cap):
            if i:
                with lg.span(tledger.HALT_POLL, run=run, chunk=chunk + i) as sp:
                    halted, sp.attrs["lag"], sp.attrs["waited"] = _poll_halt(seen)
                if halted is not None and halted >= total:
                    break
            dg = self.chunk()
            ring[i] = torch.where(alive, dg, 0)
            retired += alive.to(torch.int32)
            alive = alive & (dg[HALTED] < total)
            seen.append(_HostCopy(dg[HALTED]))
        return ring, retired


def make_sharded_run_fn(p, mesh: Mesh, num_steps: int, engine=None, wrap: str = "shard_map"):
    """The sharded chunk runner: set ``.parts`` to the shard states, then
    ``.chunk() -> digest`` runs a chunk of each, and with
    ``SimParams.wrap="device"`` ``.ring(cap, total) -> (ring, retired)``.
    ``num_steps`` counts macro-steps (serial ``macro_k``).  Refuses what
    the JAX package refuses, with its words."""
    eng = engine if engine is not None else S
    if p.mp_authors and wrap != "shard_map":
        raise ValueError(
            "SimParams.mp_authors requires wrap='shard_map' (the 'mp' "
            "mesh axis must be bound for the quorum psum)")
    if p.mp_authors and mesh.shape.get("mp", 1) > 1:
        raise ValueError(
            "SimParams.mp_authors with n_mp > 1 is unsupported in the dp "
            "fleet runtime (instances would psum quorum weights across "
            "each other); use n_mp == 1, or the standalone "
            "sharded_count_votes/sharded_quorum_reached helpers for "
            "author-sharded quorums")
    rp = resolve_params(p)
    if rp.wrap == "device" and wrap != "shard_map":
        raise ValueError(
            "SimParams.wrap='device' requires the shard_map SPMD form "
            f"(got wrap={wrap!r}); the in-graph ring loop's halt "
            "predicate needs the mesh axes bound")
    if wrap not in ("shard_map", "jit"):
        raise ValueError(f"unknown wrap mode {wrap!r}; want 'shard_map' or 'jit'")
    return _Runner(rp, mesh, num_steps, eng, wrap)


def _poll_digest(copy: _HostCopy) -> np.ndarray:
    """Wait for one chunk's ``[13]`` digest on the host: the host wrap's only
    fetch per chunk (tests count the calls)."""
    return copy.value().numpy()


def _poll_ring(ring: torch.Tensor, retired: torch.Tensor) -> tuple[np.ndarray, int]:
    """Fetch one outer call's ``[ring_k, 13]`` digest ring and its retired
    count in one transfer, a wait on the device: the device wrap's one
    digest fetch per outer call (its halt reads are :func:`_poll_halt`)."""
    flat = torch.cat([ring.flatten(), retired.view(1)]).cpu().numpy()
    return flat[:-1].reshape(ring.shape), int(flat[-1])


def _poll_halt(seen: list) -> tuple[int | None, int, bool]:
    """The device wrap's lagged halt read, before it dispatches another chunk
    of an outer call: the newest chunk's ``halted`` copy if it has landed,
    else the previous chunk's, which the host waits for if it has not landed
    either.  Returns (the halted count or None, lag, waited): ``lag`` is 1 or
    2 chunks, or 0 when nothing was read (one chunk in flight, its copy not
    landed); ``waited`` whether the host waited on the device.  Each read is
    a host fetch (tests count the calls)."""
    if seen[-1].ready():
        return int(seen[-1].value()), 1, False
    if len(seen) < 2:
        return None, 0, False
    waited = not seen[-2].ready()
    return int(seen[-2].value()), 2, waited


def _place(state, mesh: Mesh, wrap: str) -> list:
    """The shard states a loop runs: one per mesh cell, or for ``"jit"``
    the whole fleet as one state on the first device."""
    if wrap == "jit":
        if isinstance(state, ShardedState):
            return [mesh_ops.concat(state.shards, mesh.flat[0])]
        return mesh_ops.shard_batch(Mesh(((mesh.flat[0],),)), state).shards
    if isinstance(state, ShardedState):
        return state.shards
    return mesh_ops.shard_batch(mesh, state).shards


@torch.no_grad()
def run_sharded(p, mesh: Mesh, state, num_steps: int, chunk: int = 256, engine=None,
                pipeline: bool = True, wrap: str = "shard_map", pad: bool = True,
                stream=None):
    """Run a fleet on ``mesh`` until it halts or ``num_steps`` macro-steps
    (``num_steps * macro_k`` events on the serial engine) are reached;
    returns the final state, unpadded.

    ``state`` is a batched engine state (on any device) or a
    :class:`ShardedState` (run in place; one of another mesh is first
    gathered on the host); either is taken over, so do not use it again.
    ``pad=True`` pads a batch the mesh does not divide with pre-halted
    instances and drops them on return, which lands the fleet on the host
    (:func:`unpad`); a batch the mesh divides comes back as a ShardedState,
    with no copy of the whole fleet on one device.

    The default loop is pipelined: chunk k+1 is dispatched before chunk k's
    digest is polled, so the one extra chunk it may run after the halt is a
    no-op; ``pipeline=False`` polls each chunk before dispatching the next.
    Every dispatched chunk is polled once, the last one too.  With
    ``SimParams.wrap="device"`` each outer call retires up to ``ring_k``
    chunks and the host reads the ring once per call, and a lagged halted
    slot before each further chunk of the call (``pipeline`` is ignored).
    ``stream`` (a TimelineRecorder) gets every digest, with ``steps`` in
    event steps.  Trajectories equal the unsharded engines'
    ``run_to_completion`` in every leaf, in every loop and wrap.

    ``run_sharded.last_steps`` is the event steps dispatched per shard, and
    ``run_sharded.last_chunks`` the chunks (each of ``chunk`` macro-steps)."""
    eng = engine if engine is not None else S
    run = make_sharded_run_fn(p, mesh, chunk, engine=eng, wrap=wrap)
    rp = run.p
    if isinstance(state, ShardedState) and state.mesh != mesh:
        state = mesh_ops.concat(state.shards, "cpu")
    n_valid = batch_size(state)
    if pad:
        state, n_valid = pad_to_multiple(p, state, mesh.size, engine=eng)
    b_total = batch_size(state)
    if b_total % mesh.size:
        raise ValueError(
            f"batch {b_total} not divisible over the mesh's {mesh.size} "
            "devices; pass pad=True (default) or pre-pad with "
            "parallel.sharded.pad_to_multiple")
    run.parts = _place(state, mesh, wrap)
    del state   # the runner owns the fleet now
    run_sharded.last_steps = run_sharded.last_chunks = 0
    if num_steps <= 0:  # a zero step budget runs nothing (placement only)
        return unpad(_fleet(mesh, run.parts, wrap), n_valid)
    k = S.macro_k_of(rp) if eng is S else 1
    if stream is not None:
        stream.set_fleet(total=b_total, n_valid=n_valid)
    lg = tledger.get()
    rid = lg.new_run("run_sharded", devices=mesh.size, instances=b_total,
                     pipeline=bool(pipeline), chunk_steps=chunk, dispatch_wrap=rp.wrap,
                     **({"ring_k": rp.ring_k} if rp.wrap == "device" else {}))
    if rp.wrap == "device":
        _ring_loop(run, num_steps, chunk, k, b_total, stream, lg, rid)
    else:
        _digest_loop(run, num_steps, chunk, k, b_total, pipeline, stream, lg, rid)
    run_sharded.last_chunks = run.dispatched
    run_sharded.last_steps = run.dispatched * chunk * k
    with lg.span(tledger.HOST_MERGE, run=rid):
        return unpad(_fleet(mesh, run.parts, wrap), n_valid)


def _fleet(mesh: Mesh, parts: list, wrap: str) -> ShardedState:
    """The loop's shard states as the fleet on ``mesh``."""
    return mesh_ops.shard_batch(mesh, parts[0]) if wrap == "jit" else ShardedState(mesh, parts)


run_sharded.last_steps = run_sharded.last_chunks = 0


def _ring_loop(run, num_steps, chunk, k, b_total, stream, lg, rid):
    """The device wrap: outer calls of up to ``ring_k`` chunks, one ring
    fetch each; the POLL span carries ``retired`` and ``cap`` for
    ``ledger.ring_stats``, and the halt reads inside a call's DISPATCH span
    are HALT_POLL spans."""
    done, ci, oi = 0, 0, 0
    while done < num_steps:
        cap = min(run.p.ring_k, -((done - num_steps) // chunk))
        with lg.span(tledger.DISPATCH, run=rid, chunk=ci, outer=oi, cap=cap):
            ring, retired = run.ring(cap, b_total, run=rid, chunk=ci)
        with lg.span(tledger.POLL, run=rid, chunk=ci, outer=oi, cap=cap) as sp:
            rows, n = _poll_ring(ring, retired)
            sp.attrs["retired"] = n
        if stream is not None:
            stream.record_ring(rows, n, steps=[(ci + i + 1) * chunk * k for i in range(n)])
        done += n * chunk
        ci += n
        oi += 1
        if int(rows[n - 1][HALTED]) >= b_total:
            break


def _digest_loop(run, num_steps, chunk, k, b_total, pipeline, stream, lg, rid):
    """The host wrap: one ``[13]`` digest poll per dispatched chunk,
    pipelined (chunk k+1 dispatched before chunk k is polled) or not."""
    def dispatch(ci):
        with lg.span(tledger.DISPATCH, run=rid, chunk=ci):
            return _HostCopy(run.chunk())

    def poll(copy, done_steps, ci) -> bool:
        with lg.span(tledger.POLL, run=rid, chunk=ci):
            d = _poll_digest(copy)
        if stream is not None:
            stream.record(d, steps=done_steps * k)
        return int(d[HALTED]) >= b_total

    dg = dispatch(0)
    done, ci = chunk, 0
    if pipeline:
        while done < num_steps:
            lagged = dg
            dg = dispatch(ci + 1)  # dispatch chunk k+1, then poll chunk k
            done += chunk
            ci += 1
            if poll(lagged, done - chunk, ci - 1):
                break
        poll(dg, done, ci)  # the last (possibly in-flight) chunk
    else:
        while not poll(dg, done, ci) and done < num_steps:
            dg = dispatch(ci + 1)
            done += chunk
            ci += 1


# ---------------------------------------------------------------------------
# Author-dim (mp) quorum aggregation over the mesh's mp shards.
# ---------------------------------------------------------------------------


def _author_blocks(mesh: Mesh, weights, author_mask):
    """Per mp shard: its contiguous block of the author axis, on its device
    (the mp cells of the first dp row)."""
    n_mp = mesh.shape["mp"]
    if weights.shape[-1] % n_mp:
        raise ValueError(f"{weights.shape[-1]} authors do not split over n_mp={n_mp}")
    return [(w.to(d), m.to(d)) for w, m, d in zip(
        torch.tensor_split(weights, n_mp, dim=-1),
        torch.tensor_split(author_mask, n_mp, dim=-1), mesh.devices[0])]


def _sum_on_first(parts):
    dev = parts[0].device
    return torch.stack([x.to(dev) for x in parts]).sum(dim=0, dtype=torch.int32)


def sharded_count_votes(mesh: Mesh, weights, author_mask):
    """count_votes (configuration.rs:43) with the author axis split over
    the mesh's mp shards: each shard sums its own authors
    (``config.count_votes``), and the partial sums add up on the first."""
    return _sum_on_first([config.count_votes(w, m) for w, m in
                          _author_blocks(mesh, weights, author_mask)])


def sharded_quorum_reached(mesh: Mesh, weights, author_mask):
    """Whether the masked authors reach the 2N/3 + 1 quorum, both sums
    taken over the mp shards (the predicate of the step's quorum sites)."""
    blocks = _author_blocks(mesh, weights, author_mask)
    got = _sum_on_first([config.count_votes(w, m) for w, m in blocks])
    total = _sum_on_first([config.total_votes(w) for w, _ in blocks])
    return got >= torch.div(2 * total, 3, rounding_mode="floor") + 1
