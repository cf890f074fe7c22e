"""Simulator CLI of the PyTorch port, mirroring ``librabft_simulator_tpu/main.py``
(same flags and defaults; ``--device`` replaces ``--platform``):

    python -m librabft_simulator_tpu_torch.main --device cpu --nodes 3 --max_clock 1000 --json
    python -m librabft_simulator_tpu_torch.main --instances 10000 --nodes 4 --delay uniform --json

It runs on the GPU unless ``--device cpu`` is given.  ``--byzantine_f f``
marks the first ``f`` authors faulty (``--byzantine_kind``) and adds the
safe fraction to the summary; ``--output_data_files DIR`` turns on the
round-switch trace and writes instance 0's data files there.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import numpy as np
import torch

from .core.types import SimParams
from .sim import byzantine as B
from .sim import simulator as S


def build_parser():
    ap = argparse.ArgumentParser(
        prog="librabft_simulator_tpu_torch",
        description="A monte-carlo simulation of the LibraBFT consensus protocol "
                    "(PyTorch/CUDA batched port)")
    ap.add_argument("--max_clock", type=int, default=1000,
                    help="Time at which to stop the simulation")
    ap.add_argument("--mean", type=float, default=10.0,
                    help="Mean of the network delay distribution")
    ap.add_argument("--variance", type=float, default=4.0,
                    help="Variance of the network delay distribution")
    ap.add_argument("--seed", type=int, default=None,
                    help="Seed for the randomness in the simulation")
    ap.add_argument("--nodes", type=int, default=3, help="Number of nodes")
    ap.add_argument("--commands_per_epoch", type=int, default=30000,
                    help="Commands per epoch (epoch switch trigger)")
    ap.add_argument("--target_commit_interval", type=int, default=100000)
    ap.add_argument("--delta", type=int, default=20,
                    help="Base duration of rounds")
    ap.add_argument("--gamma", type=float, default=2.0,
                    help="Exponent in round duration delta * n^gamma")
    ap.add_argument("--lambda", dest="lam", type=float, default=0.5,
                    help="Query-all period as a fraction of round duration")
    ap.add_argument("--output_data_files", default=None,
                    help="Directory for round-switch CSV + message counts")
    ap.add_argument("--instances", type=int, default=1,
                    help="Number of independent simulations run as one batch")
    ap.add_argument("--delay", default="lognormal",
                    choices=["lognormal", "uniform", "pareto", "constant"])
    ap.add_argument("--drop_prob", type=float, default=0.0)
    ap.add_argument("--commit_chain", type=int, default=3,
                    help="3 = LibraBFTv2 3-chain, 2 = HotStuff-style 2-chain")
    ap.add_argument("--byzantine_f", type=int, default=0,
                    help="Number of faulty authors (0..n/3)")
    ap.add_argument("--byzantine_kind", default="equivocate",
                    choices=list(B.SCHEDULES))
    ap.add_argument("--json", action="store_true", help="JSON summary to stdout")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device the fleet runs on")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    seed = args.seed if args.seed is not None else random.getrandbits(32)
    print(f"seed: {seed}", file=sys.stderr)
    p = SimParams(
        n_nodes=args.nodes,
        max_clock=args.max_clock,
        delay_kind=args.delay,
        delay_mean=args.mean,
        delay_variance=args.variance,
        drop_prob=args.drop_prob,
        commands_per_epoch=args.commands_per_epoch,
        target_commit_interval=args.target_commit_interval,
        delta=args.delta,
        gamma=args.gamma,
        lam=args.lam,
        commit_chain=args.commit_chain,
        # In-flight messages scale ~n^2 (each update may broadcast to n-1
        # peers); 16n keeps 16-64-node fleets live.
        queue_cap=max(32, 16 * args.nodes),
        trace_cap=4096 if args.output_data_files else 0,
    )
    seeds = np.uint32(seed) + np.arange(args.instances, dtype=np.uint32)
    t0 = time.perf_counter()
    if args.byzantine_f > 0:
        st = B.init_fault_batch(p, seeds, args.byzantine_f, args.byzantine_kind,
                                device=args.device)
    else:
        st = S.init_batch(p, seeds, device=args.device)
    st = S.run_to_completion(p, st, batched=True)
    if st.clock.is_cuda:
        torch.cuda.synchronize(st.clock.device)
    elapsed = time.perf_counter() - t0

    cc = st.ctx.commit_count.cpu().numpy()
    # As the JAX CLI: the batched [1, N] list for one instance, else the mean.
    per_node = cc.tolist() if args.instances == 1 else cc.mean(axis=0).tolist()
    print(f"Commands executed per node: {per_node}", file=sys.stderr)
    summary = {
        "seed": int(seed),
        "instances": args.instances,
        "nodes": args.nodes,
        "elapsed_s": round(elapsed, 3),
        "mean_commits_per_node": float(cc.mean()),
        "total_events": int(st.n_events.sum()),
        "msgs_sent": int(st.n_msgs_sent.sum()),
        "msgs_dropped": int(st.n_msgs_dropped.sum()),
    }
    if args.byzantine_f > 0:
        honest = np.arange(p.n_nodes) >= args.byzantine_f
        summary["safe_fraction"] = float(B.check_safety(st, honest).mean())
    if args.output_data_files:
        from .analysis.data_writer import DataWriter

        DataWriter(p, args.output_data_files).write(st, instance=0)
        print(f"wrote data files to {args.output_data_files}", file=sys.stderr)
    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"{k}: {v}", file=sys.stderr)
    return summary


if __name__ == "__main__":
    main()
