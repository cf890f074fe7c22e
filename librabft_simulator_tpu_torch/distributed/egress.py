"""Per-host shard-local egress: the port of the host-side functions of
``librabft_simulator_tpu/distributed/egress.py``.

A fleet on a mesh (``parallel/mesh.py``) is one engine state per shard, each
on its device; these functions land the rows a process owns, never the whole
fleet at once:

* :func:`local_spans` names the global batch rows this process owns (mesh
  arithmetic, no tensor read), and :func:`local_state` lands exactly those
  rows on the host, padding trimmed.
* :func:`local_rows` / :func:`local_rows_at` land specific global rows: one
  small row gather per (leaf, shard) on the shard's device, O(k) host
  transfer (the resident service's egress).
* :func:`host_stream_path` / :func:`host_meta` name each process's NDJSON
  digest stream and tag its rows.
* :func:`save_shards` writes this process's checkpoint shard and
  :func:`merge_shards` assembles a shard set into one batched checkpoint
  that ``sim/checkpoint.py`` (and the JAX package's) loads.
* :func:`fold_metric_dicts` merges per-host ``merged_metrics`` partials.

The port's meshes live in one process, so every device belongs to process
0. JAX's ``make_halted_gather`` (a cross-process all-gather of the halted
plane) is not ported: it has no use without several processes.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..parallel import mesh as mesh_ops, sharded
from ..parallel.mesh import ShardedState


def _process_index(device) -> int:
    """The process a mesh device belongs to: torch devices are all local."""
    return getattr(device, "process_index", 0)


def local_spans(mesh, batch: int, n_valid: int | None = None,
                process_index: int | None = None) -> list[tuple[int, int]]:
    """The global ``[start, stop)`` batch row spans owned by this process
    on ``mesh``, in ascending order, trimmed to ``n_valid`` (padding rows
    never egress).  The batch is split over the mesh cells in
    ``mesh.flat`` order: cell *d* owns rows ``[d*b, (d+1)*b)``."""
    devices = mesh.flat
    if batch % len(devices):
        raise ValueError(
            f"batch {batch} does not tile the mesh's {len(devices)} "
            "devices (pad first: parallel.sharded.pad_to_multiple)")
    per = batch // len(devices)
    pid = 0 if process_index is None else process_index
    n_valid = batch if n_valid is None else n_valid
    spans = []
    for i, d in enumerate(devices):
        if _process_index(d) != pid:
            continue
        start, stop = i * per, min((i + 1) * per, n_valid)
        if stop > start:
            spans.append((start, stop))
    # Adjacent spans merge so shard files stay compact.
    merged: list[tuple[int, int]] = []
    for s, e in spans:
        if merged and merged[-1][1] == s:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return [tuple(se) for se in merged]


def _on_host(state) -> bool:
    """A plain state on the CPU is a host tree (what :func:`local_state`
    returns); a sharded fleet is a device fleet wherever its shards are."""
    return not isinstance(state, ShardedState) and state.clock.device.type == "cpu"


def local_state(state, n_valid: int):
    """Land this process's valid rows of a fleet on the host (CPU tensors):
    the shards' blocks in order, trimmed to ``n_valid``.  A host state
    passes through unchanged (it holds the local rows already)."""
    if _on_host(state):
        return state
    if isinstance(state, ShardedState):
        return mesh_ops.concat(state.shards, "cpu", stop=n_valid)
    return mesh_ops.rows_of(state, 0, n_valid, "cpu")


def local_rows(state, indices):
    """Land specific global rows from this process's shards as ONE host
    state: ``(held, rows)``, ``held`` the sorted indices this process holds
    and ``rows`` a CPU state of ``len(held)`` instances in that order (None
    if it holds none).  One row gather per (leaf, shard) on the shard's
    device, then one copy of those rows to the host: never the whole
    shard.  A lane state's inbox rows lose their routing pad (the rows are
    for reading)."""
    idx = sorted(set(int(i) for i in indices))
    shards = state.shards if isinstance(state, ShardedState) else [state]
    held, blocks = [], []
    start = 0
    for sh in shards:
        n = int(sh.clock.shape[0])
        offs = [(g, g - start) for g in idx if start <= g < start + n]
        start += n
        if not offs:
            continue
        at = torch.as_tensor([o for _, o in offs], device=sh.clock.device)
        blocks.append(mesh_ops.map_state(
            lambda xs, inbox: xs[0].index_select(0, at).cpu(), [sh]))
        held += [g for g, _ in offs]
    if not blocks:
        return [], None
    if len(blocks) > 1:
        blocks = [mesh_ops.map_state(lambda xs, inbox: torch.cat(xs), blocks)]
    return held, blocks[0]


def local_rows_at(state, indices) -> dict:
    """Land specific global rows from this process's shards:
    ``{global_index: state of that one instance on the CPU}`` for every
    index this process holds (others are absent), gathered as
    :func:`local_rows` gathers them."""
    held, rows = local_rows(state, indices)
    return {g: mesh_ops.map_state(lambda xs, inbox, j=j: xs[0][j:j + 1], [rows])
            for j, g in enumerate(held)}


# ---------------------------------------------------------------------------
# Per-host digest streams.
# ---------------------------------------------------------------------------


def host_stream_path(base: str, process_id: int) -> str:
    """The per-host NDJSON stream path convention:
    ``fleet.ndjson`` -> ``fleet.p3.ndjson``."""
    root, ext = os.path.splitext(base)
    return f"{root}.p{process_id}{ext or '.ndjson'}"


def host_meta(ctx) -> dict:
    """The meta fields a per-host TimelineRecorder carries so merged
    views can tag every row with its writer."""
    return {"process_id": ctx.process_id,
            "process_count": ctx.process_count}


# ---------------------------------------------------------------------------
# Checkpoint shards (save per host; merge on host 0).
# ---------------------------------------------------------------------------

SHARD_VERSION = 1


def _shard_paths(d: str, pid: int) -> tuple[str, str]:
    return (os.path.join(d, f"shard-{pid}.npz"),
            os.path.join(d, f"shard-{pid}.json"))


def save_shards(d: str, state, n_valid: int, mesh, ctx) -> str:
    """Write THIS process's checkpoint shard: its local valid rows (one
    block per owned span) + a sidecar naming the spans.  Returns the .npz
    path.  ``state`` may be the fleet on its mesh or the host state
    ``run_sharded`` already landed."""
    from ..convert import to_reference
    from ..sim import checkpoint as ckpt

    os.makedirs(d, exist_ok=True)
    # A device fleet carries the padded batch; a host state holds local
    # rows only, so the padded batch is re-derived from the mesh (the
    # pad_to_multiple rule).
    padded = (_padded_batch(mesh, n_valid) if _on_host(state)
              else sharded.batch_size(state))
    host = local_state(state, n_valid)
    spans = local_spans(mesh, padded, n_valid, process_index=ctx.process_id)
    rows = sum(e - s for s, e in spans)
    have = int(host.clock.shape[0])
    if have != rows:
        raise ValueError(
            f"local state holds {have} rows but "
            f"this process owns spans {spans} ({rows} rows) — state and "
            "mesh disagree")
    arrays = {ckpt._key(k): v for k, v in to_reference(host).items()}
    blob = {}
    off = 0
    for j, (s, e) in enumerate(spans):
        for key, arr in arrays.items():
            blob[f"b{j}:{key}"] = arr[off:off + (e - s)]
        off += e - s
    bin_path, meta_path = _shard_paths(d, ctx.process_id)
    tmp = bin_path + ".tmp.%d.npz" % os.getpid()
    np.savez_compressed(tmp, **blob)
    os.replace(tmp, bin_path)
    side = {
        "shard_version": SHARD_VERSION,
        "process_id": ctx.process_id,
        "process_count": ctx.process_count,
        "n_valid": int(n_valid),
        "spans": [[int(s), int(e)] for s, e in spans],
    }
    tmp = meta_path + ".tmp.%d" % os.getpid()
    with open(tmp, "w") as f:
        json.dump(side, f, indent=1)
    os.replace(tmp, meta_path)
    return bin_path


def _padded_batch(mesh, n_valid: int) -> int:
    per = max(int(mesh.size), 1)
    return -(-n_valid // per) * per


def merge_shards(d: str, out_path: str | None = None) -> str:
    """The host-0 merge step: assemble every ``shard-<pid>`` pair in
    ``d`` into ONE standard batched checkpoint (.npz, the
    ``sim/checkpoint.py`` format) covering rows ``[0, n_valid)`` exactly.
    Refuses gaps, overlaps, and mixed fleets.  Returns the merged path
    (default ``<d>/merged.npz``)."""
    sidecars = []
    for name in sorted(os.listdir(d)):
        if name.startswith("shard-") and name.endswith(".json"):
            with open(os.path.join(d, name)) as f:
                sidecars.append(json.load(f))
    if not sidecars:
        raise FileNotFoundError(f"no checkpoint shards under {d}")
    for side in sidecars:
        if side.get("shard_version") != SHARD_VERSION:
            raise ValueError(
                f"{d}: shard-{side.get('process_id')} has shard_version "
                f"{side.get('shard_version')} != {SHARD_VERSION}")
    n_valid = {side["n_valid"] for side in sidecars}
    if len(n_valid) != 1:
        raise ValueError(f"{d}: shards disagree on n_valid ({n_valid}) — "
                         "mixed fleets?")
    n_valid = n_valid.pop()
    covered: list[tuple[int, int]] = []
    pieces: dict[str, list[tuple[int, np.ndarray]]] = {}
    for side in sidecars:
        pid = side["process_id"]
        bin_path = _shard_paths(d, pid)[0]
        # A shard written by a process killed mid-write is an expected
        # input here: refuse it with a recovery hint.
        try:
            data = np.load(bin_path)
            arrays = {key: data[key] for key in data.files}
        except Exception as e:  # noqa: BLE001 — zipfile/OSError/pickle
            raise ValueError(
                f"{bin_path}: unreadable checkpoint shard "
                f"({type(e).__name__}: {e}) — the writer was likely "
                "killed mid-write; recover the shard from the owning "
                "host or re-checkpoint before resuming") from None
        for j, (s, e) in enumerate(side["spans"]):
            covered.append((s, e))
            n_keys = 0
            for key, arr in arrays.items():
                if not key.startswith(f"b{j}:"):
                    continue
                n_keys += 1
                if int(arr.shape[0]) != e - s:
                    raise ValueError(
                        f"{bin_path}: block b{j}:{key.split(':', 1)[1]} "
                        f"holds {int(arr.shape[0])} rows but the sidecar "
                        f"span [{s}, {e}) promises {e - s} — shard "
                        "payload and sidecar disagree (mixed checkpoint "
                        "generations in one dir?); re-checkpoint")
                pieces.setdefault(key.split(":", 1)[1], []).append((s, arr))
            if n_keys == 0:
                raise ValueError(
                    f"{bin_path}: sidecar promises span [{s}, {e}) as "
                    f"block b{j} but the archive has no b{j}:* arrays — "
                    "shard payload and sidecar disagree; re-checkpoint")
    covered.sort()
    pos = 0
    for s, e in covered:
        if s != pos:
            raise ValueError(
                f"{d}: shard set covers rows up to {pos} then jumps to "
                f"{s} — missing or overlapping shard (a failover restart "
                "needs every host's shard; recover the missing "
                f"shard-<pid> files or re-checkpoint)")
        pos = e
    if pos != n_valid:
        raise ValueError(f"{d}: shard set covers [0, {pos}) but n_valid="
                         f"{n_valid} — incomplete shard set")
    merged = {key: np.concatenate(
        [arr for _, arr in sorted(blocks, key=lambda kv: kv[0])], axis=0)
        for key, blocks in pieces.items()}
    out_path = out_path or os.path.join(d, "merged.npz")
    tmp = out_path + ".tmp.%d.npz" % os.getpid()
    np.savez_compressed(tmp, **merged)
    os.replace(tmp, out_path)
    return out_path


# ---------------------------------------------------------------------------
# Telemetry fold merge (host-0 step over per-host partial dicts).
# ---------------------------------------------------------------------------


def fold_metric_dicts(p, dicts: list[dict]) -> dict:
    """Merge per-host ``telemetry.report.merged_metrics`` partials into
    the fleet view: counters/histograms sum, high-water marks max — the
    registry's aggregation per metric."""
    from ..telemetry import plane

    dicts = list(dicts)
    if not dicts:
        raise ValueError("fold_metric_dicts needs at least one partial")
    out: dict = {}
    for name, (_, size, agg) in plane.np_registry(p).items():
        vals = [d[name] for d in dicts]
        if size == 1:
            out[name] = (max(vals) if agg == plane.MAX else sum(vals))
        else:
            cols = list(zip(*vals))
            out[name] = [
                (max(c) if agg == plane.MAX else sum(c)) for c in cols]
    return out
