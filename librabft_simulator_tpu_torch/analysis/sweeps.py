"""The BASELINE.json configurations as sweeps: the port of
``librabft_simulator_tpu/analysis/sweeps.py`` (single-device path).

Config 1: LibraBFTv2, 3 nodes, 1 instance, default (lognormal) delays.
Config 2: 4 nodes, 10k instances, uniform delay.
Config 3: 64 nodes, 1k instances, Pareto delay + 5% drop (lane engine).
Config 4: f equivocating authors swept over f in [0, n/3], 10k instances.
Config 5: two-chain HotStuff variant, 16 nodes, 10k instances (lane engine).

    python -m librabft_simulator_tpu_torch.analysis.sweeps --scale 0.01
    python -m librabft_simulator_tpu_torch.analysis.sweeps --device cpu --scale 0.001

It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ..core.types import SimParams
from ..sim import byzantine as B
from ..sim import parallel_sim as P
from ..sim import simulator as S


def _fleet_stats(p: SimParams, st, elapsed: float) -> dict:
    g = lambda x: x.cpu().numpy()  # noqa: E731
    cc = g(st.ctx.commit_count)
    rounds = (g(st.store.current_round).max(axis=-1) - 1).sum()
    return {
        "instances": int(cc.shape[0]),
        "n_nodes": p.n_nodes,
        "total_commits": int(cc.sum()),
        "mean_commits_per_node": float(cc.mean()),
        "min_commits": int(cc.min()),
        "total_rounds": int(rounds),
        "elapsed_s": round(elapsed, 3),
        "rounds_per_sec": round(float(rounds) / elapsed, 1) if elapsed else None,
        "msgs_sent": int(g(st.n_msgs_sent).sum()),
        "msgs_dropped": int(g(st.n_msgs_dropped).sum()),
        # Shared-queue overflow (serial) / per-receiver inbox overflow
        # (lanes): sends lost to capacity.
        "queue_full": int(g(st.n_queue_full if hasattr(st, "n_queue_full")
                            else st.n_inbox_full).sum()),
        "sync_jumps": int(g(st.ctx.sync_jumps).sum()),
    }


def _not_ported(flag: str, where: str):
    raise NotImplementedError(f"{flag} is not ported yet; it lands with {where}")


def run_config(p: SimParams, n_instances: int, seed0: int = 0, f: int = 0,
               byz_kind: str = "equivocate", engine=S, dp: int = 0, stream=None,
               device="cuda") -> dict:
    """One configuration on one device: init, run to completion, fleet
    stats (and the safe fraction when ``f > 0``)."""
    if dp > 0:
        _not_ported("dp > 0 (a dp-sharded fleet)", "the multi-GPU slice")
    if stream is not None:
        _not_ported("stream= (the digest timeline)", "the telemetry-plane slice")
    seeds = np.arange(seed0, seed0 + n_instances, dtype=np.uint32)
    if f > 0:
        if engine is not S:
            raise NotImplementedError(
                "byzantine fault batches build serial SimStates "
                "(byzantine.init_fault_batch); run f>0 sweeps on the serial engine")
        st = B.init_fault_batch(p, seeds, f, byz_kind, device=device)
    else:
        st = engine.init_batch(p, seeds, device=device)
    t0 = time.perf_counter()
    st = engine.run_to_completion(p, st, batched=True)
    if st.clock.is_cuda:
        torch.cuda.synchronize(st.clock.device)
    out = _fleet_stats(p, st, time.perf_counter() - t0)
    if f > 0:
        honest = np.arange(p.n_nodes) >= f
        out["f"] = f
        out["byz_kind"] = byz_kind
        out["safe_fraction"] = float(B.check_safety(st, honest).mean())
    return out


def baseline_configs(scale: float = 1.0) -> dict:
    """The five BASELINE.json configs (the JAX package's ``SimParams``);
    ``scale`` shrinks instance counts (1.0 = the stated sizes)."""
    k = lambda n: max(int(n * scale), 1)  # noqa: E731
    return {
        "1_default_3node": (SimParams(n_nodes=3, max_clock=1000), k(1), 0),
        "2_uniform_4node_10k": (
            SimParams(n_nodes=4, max_clock=1000, delay_kind="uniform"), k(10000), 0),
        # Wide fleets run on the lane engine (per-receiver inboxes; the
        # serial shared queue needs O(n^2) capacity to stop overflowing).
        "3_pareto_drop_64node_1k": (
            SimParams(n_nodes=64, max_clock=1000, delay_kind="pareto",
                      drop_prob=0.05), k(1000), "parallel"),
        "4_byzantine_sweep_10k": (
            SimParams(n_nodes=4, max_clock=1000), k(10000), "sweep"),
        # inbox_cap 1024 is lossless at analysis scales; a full 10k-instance
        # fleet takes the 256 of the benchmark regime (overflow is counted
        # and reported in ``queue_full``).
        "5_hotstuff2_16node_10k": (
            SimParams(n_nodes=16, max_clock=1000, commit_chain=2,
                      inbox_cap=1024 if k(10000) <= 2000 else 256),
            k(10000), "parallel"),
    }


def run_all(scale: float = 1.0, out_path: str | None = None,
            telemetry: bool = False, dp: int = 0,
            stream_out: str | None = None, watchdog: bool = False,
            macro_k: int = 0, device="cuda") -> dict:
    """Every BASELINE configuration in turn; config #4 is an f-sweep over
    f in [0, n/3]."""
    for on, flag, where in (
            (telemetry, "--telemetry", "the telemetry-plane slice"),
            (watchdog, "--watchdog", "the telemetry-plane slice"),
            (stream_out, "--stream-out", "the telemetry-plane slice"),
            (dp > 0, "--dp", "the multi-GPU slice"),
            (macro_k > 0, "--macro-k", "the sharded-runtime slice")):
        if on:
            _not_ported(flag, where)
    results = {}
    for name, (p, n, f_mode) in baseline_configs(scale).items():
        if f_mode == "sweep":
            results[name] = [
                dataclasses.asdict(r)
                for r in B.f_sweep(p, n, f_values=list(range(p.n_nodes // 3 + 1)),
                                   device=device)
            ]
        else:
            results[name] = run_config(
                p, n, engine=P if f_mode == "parallel" else S, device=device)
        print(f"[sweep] {name}: done", file=sys.stderr)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
    return results


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scale", type=float, default=0.01,
                    help="instance-count scale factor (1.0 = full BASELINE sizes)")
    ap.add_argument("--out", default=None, help="write JSON to this path")
    ap.add_argument("--telemetry", action="store_true",
                    help="not ported yet (the telemetry-plane slice)")
    ap.add_argument("--dp", type=int, default=0,
                    help="not ported yet (the multi-GPU slice)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device the fleets run on")
    ap.add_argument("--stream-out", default=None, metavar="PATH",
                    help="not ported yet (the telemetry-plane slice)")
    ap.add_argument("--watchdog", action="store_true",
                    help="not ported yet (the telemetry-plane slice)")
    ap.add_argument("--macro-k", type=int, default=0, metavar="K",
                    help="not ported yet (the sharded-runtime slice)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    results = run_all(args.scale, args.out, telemetry=args.telemetry,
                      dp=args.dp, stream_out=args.stream_out,
                      watchdog=args.watchdog, macro_k=args.macro_k,
                      device=args.device)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
