"""Times the select kernel of several checkouts of this repo on one GPU, in
one run, so that their numbers can be compared.

    python3 chip_select_compare.py DIR [DIR ...] [--instances 10000 40000]

Each DIR is a checkout of the repo: "." for this one, or an earlier commit
unpacked with ``git archive`` into a directory that .gitignore lists.  For
each instance count B, every DIR runs in a process of its own, in turns
(DIR 1 .. DIR n, then DIR n .. DIR 1).  A process builds the DIR's kernel
from the DIR's sources and times it with chip_smoke.py's methods (of this
checkout): the device time of one call after an L2 flush (``ms``) and the
device time per call over back-to-back calls on inputs cold in L2
(``cold_ms``), for

  - ``select_events`` on [B, 68] and [B, 36] rows (chip_smoke's row sets);
  - the engine's select step on its queue and timers at BASELINE config #2
    (cm = 64, n = 4, the [B, 64] views of [B, 65] buffers that scatter_set
    leaves): ``select_queue_events`` where the DIR has it, else the step
    that DIR's engine ran (where + 3 cat + ``select_events``).

Every timed function is first held bit for bit against the plain version
on the same inputs.  Prints one line per process, the card's name and
power limit, and last a JSON object with the mean of each DIR's two turns.
Exits non-zero without a GPU or when any process fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CM, N, KIND_TIMER = 64, 4, 3   # config #2's queue_cap and n_nodes; core/types.py KIND_TIMER
TAG = "RESULT "


def worker(root, b):
    """Time one checkout's kernel; print its numbers as one tagged JSON line."""
    import torch

    import chip_smoke as cs  # this checkout's timing helpers, before the path changes

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from librabft_simulator_tpu_torch.ops import select_events as sel
    if not os.path.abspath(sel.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {sel.__file__}, not the kernel of {root}")
    sel.build()
    sel.load()
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cs.spin_up()
    out = {}
    for m in (68, 36):
        nsets = max(cs.COLD_SETS, int(cs.COLD_BYTES // (3 * b * m * 4)) + 1)
        sets = [cs.select_inputs(b, m, 500 + i, dev) for i in range(nsets)]
        cs.check_equal(sel.select_events(*sets[0]), sel.select_events_plain(*sets[0]),
                       f"select_events M={m}")
        out[f"select_events M={m}"] = dict(
            ms=cs.device_ms(lambda: sel.select_events(*sets[0]), 25, flush),
            cold_ms=cs.cold_ms(lambda x: sel.select_events(*x), sets))
        del sets

    def plain_step(valid, time_, kind, stamp, t_time, t_stamp):
        kinds = torch.full_like(t_time, KIND_TIMER)
        return sel.select_events_plain(
            torch.cat([torch.where(valid, time_, cs.NEVER), t_time], dim=1),
            torch.cat([kind, kinds], dim=1), torch.cat([stamp, t_stamp], dim=1))

    if hasattr(sel, "select_queue_events"):
        name = "select_queue_events"
        step = lambda x: sel.select_queue_events(*x, KIND_TIMER)  # noqa: E731
    else:
        name = "where + 3 cat + select_events"
        step = lambda x: cs.former_select_step(*x, KIND_TIMER)  # noqa: E731
    q_sets = [cs.queue_inputs(b, CM, N, KIND_TIMER, 700 + i, dev) for i in range(cs.COLD_SETS)]
    cs.check_equal(step(q_sets[0]), plain_step(*q_sets[0]), f"select step ({name})")
    out["select step"] = dict(
        entry=name, ms=cs.device_ms(lambda: step(q_sets[0]), 25, flush),
        cold_ms=cs.cold_ms(step, q_sets))
    print(TAG + json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", help="checkouts of the repo to compare")
    ap.add_argument("--instances", type=int, nargs="+", default=[10000],
                    help="batch sizes B to time at")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.dirs[0], args.instances[0])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_select_compare: no CUDA device visible to torch", file=sys.stderr)
        return 2
    import chip_smoke as cs

    smi = cs.nvidia_smi()
    print(f"nvidia-smi: {smi}", flush=True)
    summary = []
    for b in args.instances:
        runs = {d: [] for d in args.dirs}
        for d in args.dirs + args.dirs[::-1]:
            res = subprocess.run(
                [sys.executable, os.path.join(HERE, "chip_select_compare.py"), "--worker",
                 d, "--instances", str(b)],
                capture_output=True, text=True, timeout=600, cwd=HERE)
            lines = [ln for ln in res.stdout.splitlines() if ln.startswith(TAG)]
            if res.returncode != 0 or not lines:
                print(res.stdout[-4000:], res.stderr[-4000:], sep="\n", file=sys.stderr)
                raise RuntimeError(f"{d} at B={b}: worker exited {res.returncode}")
            got = json.loads(lines[-1][len(TAG):])
            runs[d].append(got)
            print(f"B={b} {d}: " + "; ".join(
                f"{k}: ms {v['ms']:.5f}, cold_ms {v['cold_ms']:.5f}" for k, v in got.items()),
                flush=True)
        for d, pair in runs.items():
            summary.append(dict(dir=d, instances=b, **{
                k: dict(pair[0][k], ms=(pair[0][k]["ms"] + pair[1][k]["ms"]) / 2,
                        cold_ms=(pair[0][k]["cold_ms"] + pair[1][k]["cold_ms"]) / 2)
                for k in pair[0]}))
    print(smi)
    print(json.dumps({"compare": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
