"""Byzantine fault injection and the safety check (BASELINE config #4): the
port of ``librabft_simulator_tpu/sim/byzantine.py``.

The attacks live in the engines as three per-instance ``[N]`` bool masks
(``byz_equivocate``: a conflicting proposal to the upper half of the
receivers; ``byz_silent``: never sends; ``byz_forge_qc``: notifications carry
a quorum-less forged QC).  This module builds fault-masked fleets, runs
f-sweeps, and checks the safety invariant: no two honest nodes commit
different state tags at the same depth.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import SimParams
from ..utils.xops import arange
from . import simulator as S

#: The attack-schedule registry (the JAX package's ``SCHEDULES``).
SCHEDULES = ("honest", "equivocate", "silent", "forge_qc")


def schedule_masks(p: SimParams, kind: str = "honest", f: int = 0, authors=None):
    """(equivocate, silent, forge_qc) ``[N]`` bool masks for a named attack
    schedule.  ``"honest"`` is all-clear whatever ``f``; the other kinds mark
    ``f`` authors (or the explicit ``authors``) faulty via :func:`byz_masks`."""
    if kind not in SCHEDULES:
        raise ValueError(f"unknown Byzantine schedule {kind!r}; want one of {SCHEDULES}")
    if kind == "honest":
        z = np.zeros((p.n_nodes,), bool)
        return z, z, z
    return byz_masks(p, f, kind, authors)


def byz_masks(p: SimParams, f: int, kind: str = "equivocate", authors=None):
    """(equivocate, silent, forge_qc) masks marking ``f`` authors as faulty
    (the first ``f``, unless ``authors`` names them)."""
    idx = np.arange(p.n_nodes)
    m = np.isin(idx, np.asarray(authors)) if authors is not None else idx < f
    z = np.zeros_like(m)
    return (m if kind == "equivocate" else z, m if kind == "silent" else z,
            m if kind == "forge_qc" else z)


def init_fault_batch(p: SimParams, seeds, f: int, kind: str = "equivocate",
                     authors=None, device="cuda"):
    """A serial-engine batch whose instances all carry the same fault masks."""
    eq, silent, forge = byz_masks(p, f, kind, authors)
    return S.init_batch(p, seeds, byz_equivocate=eq, byz_silent=silent,
                        byz_forge_qc=forge, device=device)


def _safety_device(log_depth, log_tag, commit_count, honest):
    """Per instance: sort the honest nodes' (depth, tag) commit entries by
    depth, then tag; a violation is two adjacent entries with equal depth
    and different tags.  The JAX ``lexsort((tag, depth))`` is two stable
    sorts, by tag and then by depth."""
    b, n, h = log_depth.shape
    dev = log_depth.device
    valid = ((arange(h, dev) < commit_count.clamp(max=h).unsqueeze(-1))
             & honest.view(1, n, 1)).reshape(b, n * h)
    # Invalid entries get distinct negative depths, so they never collide.
    uniq = (-1 - arange(n * h, dev)).to(log_depth.dtype)
    depth = torch.where(valid, log_depth.reshape(b, n * h), uniq)
    tag = log_tag.reshape(b, n * h)
    by_tag = torch.argsort(tag, dim=1, stable=True)
    depth, tag = depth.gather(1, by_tag), tag.gather(1, by_tag)
    by_depth = torch.argsort(depth, dim=1, stable=True)
    d_s, t_s = depth.gather(1, by_depth), tag.gather(1, by_depth)
    conflict = (d_s[:, 1:] == d_s[:, :-1]) & (t_s[:, 1:] != t_s[:, :-1])
    return ~conflict.any(dim=1)


def _honest(st, honest_mask):
    n = st.ctx.log_depth.shape[1]
    return np.ones((n,), bool) if honest_mask is None else np.asarray(honest_mask, bool)


def check_safety(st, honest_mask=None) -> np.ndarray:
    """Per-instance safety of a batched SimState or PSimState: across the
    honest nodes, committed tags agree at equal depth (over each node's ring
    log, its last ``commit_log`` commits).  Runs on the state's device with
    one host read at the end; returns a bool ``[B]`` numpy array."""
    honest = torch.as_tensor(_honest(st, honest_mask), device=st.ctx.log_depth.device)
    safe = _safety_device(st.ctx.log_depth, st.ctx.log_tag, st.ctx.commit_count, honest)
    return safe.cpu().numpy()


def check_safety_reference(st, honest_mask=None) -> np.ndarray:
    """Pure-Python reference of :func:`check_safety`."""
    log_depth = st.ctx.log_depth.cpu().numpy()
    log_tag = st.ctx.log_tag.cpu().numpy()
    commit_count = st.ctx.commit_count.cpu().numpy()
    b, n, h = log_depth.shape
    honest = _honest(st, honest_mask)
    safe = np.ones((b,), bool)
    for i in range(b):
        seen: dict[int, int] = {}
        for a in range(n):
            if not honest[a]:
                continue
            cc = int(commit_count[i, a])
            for j in range(max(cc - h, 0), cc):
                d, t = int(log_depth[i, a, j % h]), int(log_tag[i, a, j % h])
                if d in seen and seen[d] != t:
                    safe[i] = False
                seen[d] = t
    return safe


@dataclasses.dataclass
class SweepResult:
    f: int
    kind: str
    instances: int
    safe_fraction: float
    live_fraction: float   # fraction of instances with >= 1 honest commit
    mean_commits: float


def f_sweep(p: SimParams, n_instances: int, f_values=None, kind: str = "equivocate",
            seed0: int = 0, device="cuda"):
    """Sweep the number of faulty authors; per-f safety and liveness."""
    if f_values is None:
        f_values = list(range(0, p.n_nodes // 3 + 2))
    out = []
    for f in f_values:
        seeds = np.arange(seed0, seed0 + n_instances, dtype=np.uint32)
        st = S.run_to_completion(p, init_fault_batch(p, seeds, f, kind, device=device))
        honest = np.arange(p.n_nodes) >= f
        safe = check_safety(st, honest)
        cc = st.ctx.commit_count.cpu().numpy()[:, honest]
        out.append(SweepResult(
            f=f, kind=kind, instances=n_instances,
            safe_fraction=float(safe.mean()),
            live_fraction=float((cc.max(axis=1) > 0).mean()),
            mean_commits=float(cc.mean()),
        ))
    return out
