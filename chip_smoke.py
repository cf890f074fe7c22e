"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--max_clock 1000]

Phases, each printed with its seconds:
  1. card: nvidia-smi name and power limit, torch's device name;
  2. build: nvcc builds the select-events kernel library from this checkout;
  3. kernel vs plain: the kernel against its plain PyTorch version at the
     main path's shapes (B = instances, M = queue_cap + n_nodes = 68, and
     M = 36), random rows with ~30% NEVER, tie rows and all-NEVER rows,
     bit for bit; CUDA-event times of both beside the kernel's bytes bound;
  4. main path: the port's init_batch + run_to_completion at BASELINE
     config #2 (4 nodes, uniform delay, queue_cap 64 as the CLI sets it,
     consecutive seeds); the kernel's launch count must equal the batch
     steps run;
  5. card vs CPU: four of those instances re-run on the CPU with the plain
     select, every leaf compared bit for bit with the card's final rows;
  6. where the time goes: 8 batch steps of a fresh fleet under
     torch.profiler (device busy share, kernels per step, top kernels).

Prints the kernel table as one JSON line, the card's name and power limit,
and last the result line.  Any mismatch or exception exits non-zero; with no
GPU it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

NEVER = 2**31 - 1
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
INT_OPS_PER_S = 67e12          # H100 non-tensor 32-bit rate (data sheet, fp32)
KERNEL_TPU = "librabft_simulator_tpu/ops/pallas_queue.py:33"
KERNEL_SRC = "librabft_simulator_tpu_torch/csrc/select_events.cu"
INSTANCES = 10000              # BASELINE config #2's fleet (README quick start)


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(name, t0):
    print(f"   {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def select_inputs(b, m, seed, device):
    """Random rows (~30% NEVER) with tie rows and all-NEVER rows at the top."""
    rng = np.random.default_rng(seed)
    times = rng.integers(0, 100, (b, m)).astype(np.int32)
    times[rng.random((b, m)) < 0.3] = NEVER
    kinds = rng.integers(-1, 4, (b, m)).astype(np.int32)
    stamps = np.argsort(rng.random((b, m)), axis=1).astype(np.int32)
    ties = min(256, b // 4)
    # Tie rows: equal times and kinds on a few columns, equal stamps that
    # only the column order separates.
    for r in range(ties):
        cols = rng.choice(m, size=min(4, m), replace=False)
        times[r, cols] = 5
        kinds[r, cols] = 3
        stamps[r, cols] = 7
        times[r, times[r] < 5] = 6
    # All-NEVER rows: the winner is decided by kind, stamp and column.
    times[ties:2 * ties] = NEVER
    stamps[ties:2 * ties:2] = 0
    return [torch.as_tensor(x, device=device) for x in (times, kinds, stamps)]


def device_ms(fn, reps, flush):
    """Median device time (ms) of one call of ``fn``, each after an L2 flush.
    A spin kernel queued first keeps the card busy while the host issues
    the two events and the call, so the events bracket device work only."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.fill_(1)
        torch.cuda._sleep(5_000_000)  # ~3 ms of spinning on the card
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def spin_up(seconds=1.0):
    """Keep the card busy for a moment so its clocks leave idle before the
    kernel timings."""
    x = torch.ones(1 << 24, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        x.mul_(1.0000001)
    torch.cuda.synchronize()


def time_cuda(fn, reps, flush):
    """Median ms of ``reps`` single calls between two CUDA events, each
    after an L2 flush: the device time plus the host's time to issue the
    call, which the card waits for."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_steps(p, seeds, steps):
    """Batch steps from a fresh fleet under torch.profiler: wall and device
    time per step, the device's busy share, launches per step and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from librabft_simulator_tpu_torch.sim import simulator as S

    dt, du = S.tables(p, "cuda")
    st = S.init_batch(p, seeds, device="cuda")
    with torch.inference_mode():
        for _ in range(4):  # warm the allocator and caches
            st = S.step(p, dt, du, st, False, False)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                st = S.step(p, dt, du, st, False, False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0)
        if getattr(evt, "device_type", None) is not None and \
                str(evt.device_type).endswith("CUDA") and dev_us > 0:
            rows.append((dev_us, evt.count, evt.key))
    print(f"   {steps} batch steps: wall {wall / steps * 1e3:.3f} ms/step")
    if not rows:
        print("   device time: not measured (the profiler saw no device kernels)")
        return
    dev = sum(r[0] for r in rows) / 1e3 / steps
    launches = sum(r[1] for r in rows) / steps
    print(f"   device kernel time {dev:.3f} ms/step, busy share "
          f"{dev / (wall / steps * 1e3):.4f}, kernels launched {launches:.1f}/step")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"   {dev_us / 1e3 / steps:9.4f} ms/step {count / steps:8.1f}/step  {key[:90]}")


def leaves_equal(ref: dict, got: dict, rows, label):
    bad = []
    for path, a in ref.items():
        b = got[path][rows]
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
            bad.append(path)
    if bad:
        raise AssertionError(f"{label}: {len(bad)} leaves differ, first {bad[:5]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max_clock", type=int, default=1000,
                    help="horizon of the main path (cut only to fit the time limit)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2

    from librabft_simulator_tpu_torch.convert import to_reference
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.ops import select_events as sel
    from librabft_simulator_tpu_torch.sim import simulator as S

    dev = torch.device("cuda")
    t = phase("1. card")
    smi = nvidia_smi()
    print(f"   nvidia-smi: {smi}")
    print(f"   torch: {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    done("card", t)

    t = phase("2. build")
    sel.build(verbose=True)
    sel.load()
    done("build", t)

    p = SimParams(n_nodes=4, delay_kind="uniform", queue_cap=max(32, 16 * 4),
                  max_clock=args.max_clock)
    b = INSTANCES
    m_main = p.queue_cap + p.n_nodes
    t = phase("3. kernel vs plain")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    spin_up()
    max_err = 0
    row = None
    for m in (m_main, 32 + 4):
        ins = select_inputs(b, m, 1234 + m, dev)
        idx_k, tmin_k = sel.select_events(*ins)
        idx_p, tmin_p = sel.select_events_plain(*ins)
        torch.cuda.synchronize()
        err = max(int((idx_k.long() - idx_p.long()).abs().max()),
                  int((tmin_k.long() - tmin_p.long()).abs().max()))
        if not (torch.equal(idx_k, idx_p) and torch.equal(tmin_k, tmin_p)):
            raise AssertionError(f"select kernel != plain at B={b} M={m}: max err {err}")
        max_err = max(max_err, err)
        ms = device_ms(lambda: sel.select_events(*ins), 25, flush)
        plain_ms = device_ms(lambda: sel.select_events_plain(*ins), 25, flush)
        print(f"   B={b} M={m}: with the host's issue time (CUDA events around "
              f"one call): kernel {time_cuda(lambda: sel.select_events(*ins), 25, flush):.4f} ms, "
              f"plain {time_cuda(lambda: sel.select_events_plain(*ins), 25, flush):.4f} ms")
        nbytes = 3 * b * m * 4 + 2 * b * 4
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = 4 * b * m / INT_OPS_PER_S * 1e3
        bound_ms = max(bound_bytes_ms, bound_ops_ms)
        print(f"   B={b} M={m}: equal (incl. tie and all-NEVER rows); device time "
              f"(card busy before the call, L2 flushed): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, "
              f"bytes bound {bound_ms:.4f} ms "
              f"({nbytes} B); library call: none (no single PyTorch op "
              f"computes this lexicographic argmin)")
        if m == m_main:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations")
    done("kernel vs plain", t)

    t = phase("4. main path")
    seeds = np.arange(b, dtype=np.uint32)
    if args.max_clock != 1000:
        print(f"   max_clock cut from the CLI default 1000 to {args.max_clock}")
    sel.select_events.launches = 0
    t_run = time.perf_counter()
    st = S.init_batch(p, seeds, device="cuda")
    st = S.run_to_completion(p, st, batched=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = sel.select_events.launches
    steps = S.run_to_completion.last_steps
    events = int(st.n_events.sum())
    halted = bool(st.halted.all())
    cc = st.ctx.commit_count.float()
    # Rounds completed per instance: the highest round any node reached
    # (rounds start at 1), summed over the fleet, as bench.py counts them.
    rounds = int((st.store.current_round.max(dim=1).values - 1).sum())
    print(f"   config #2: n=4 uniform queue_cap={p.queue_cap} B={b} max_clock={p.max_clock}")
    print(f"   events {events}, rounds {rounds}, batch steps {steps}, wall {wall:.3f} s, "
          f"events/s {events / wall:.1f}, rounds/s {rounds / wall:.1f}, "
          f"ms/batch step {wall / steps * 1e3:.3f}")
    print(f"   all halted {halted}, mean commits/node {float(cc.mean()):.3f}, "
          f"min commits/node {int(st.ctx.commit_count.min())}, "
          f"queue-full {int(st.n_queue_full.sum())}, peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"   select_events.launches {launches} (batch steps {steps})")
    if not halted or launches <= 0 or launches != steps:
        raise AssertionError(f"main path: halted={halted} launches={launches} steps={steps}")
    if not float(cc.mean()) > 0:
        raise AssertionError("main path: the fleet committed nothing")
    done("main path", t)

    t = phase("5. card vs CPU")
    rng = np.random.default_rng(0)
    picks = sorted({0, b - 1, *rng.choice(np.arange(1, b - 1), 2, replace=False).tolist()})
    gpu = to_reference(st)
    cpu_st = S.run_to_completion(p, S.init_batch(p, seeds[picks], device="cpu"))
    leaves_equal(to_reference(cpu_st), gpu, picks, "card vs CPU")
    print(f"   instances {picks}: every leaf equal ({len(gpu)} leaves)")
    done("card vs CPU", t)

    t = phase("6. where the time goes")
    profile_steps(p, seeds, steps=8)
    done("where the time goes", t)

    kernels = [dict(name="select_events", route="cuda", source=KERNEL_SRC,
                    replaces=KERNEL_TPU, launches=launches, max_abs_err=max_err,
                    ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=None)]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
