"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--max_clock 300] [--byz_clock 150] [--c3_clock 30] [--c5_clock 65]

Phases, each printed with its seconds:
  1. card: nvidia-smi name and power limit, torch's device name;
  2. build: nvcc builds the select-events kernel library from this checkout
     (one source, both entries);
  3. kernel vs plain: both entries of the kernel against their plain
     PyTorch versions, bit for bit, at the main paths' shapes (B =
     instances): select_events on [B, M] rows (M = queue_cap + n_nodes =
     68, M = 36, and a row-strided [B, 68] view), random rows with ~30%
     NEVER, tie rows and all-NEVER rows; select_queue_events on queue
     leaves made by scatter_set as the engine makes them ([B, 64] views of
     [B, 65] buffers, and the contiguous leaves of the first step), with
     stale invalid slots, message/timer ties, all-invalid rows with
     all-NEVER timers and full queues, at B and at B - 3 (a last tile whose
     span is not a multiple of 16 bytes); both entries on wide rows, whose
     tile needs more than the default 48 KB of shared memory (M = cm = 400)
     or more than a block may have, so that the kernel reads them with
     plain loads (M = cm = 640); and select_queue_events as the lane engine
     calls it ([B*A, 256] inbox rows and one timer column, at configs #3
     and #5) against the lane engine's plain ``_earliest``.  Times, beside
     each entry's bytes bound: the device time of one call after an L2
     flush (device_ms; the "ms" of the kernel line), with that method's
     floor, and the device time per call over back-to-back calls on inputs
     that are cold in L2 (cold_ms; "cold_ms" in the line), of each entry and
     its plain version; and the engine's former select step (where + 3 cat
     + select_events) against select_queue_events on the same states, in
     turns;
  4. main path, serial: init_batch + run_to_completion at BASELINE config
     #2 (4 nodes, uniform delay, queue_cap 64 as the CLI sets it,
     consecutive seeds); select_queue_events' launch count must equal the
     batch steps run;
  5. card vs CPU: four of those instances re-run on the CPU with the plain
     select, every leaf compared bit for bit with the card's final rows;
  6. where the time goes (serial): 8 batch steps of a fresh fleet under
     torch.profiler (device busy share, kernels per step, top kernels);
  7. config #4: byzantine.f_sweep for f in {0, 1} (4 nodes, the sweep's
     SimParams, 10,000 instances); safe fraction 1, live fraction > 0, the
     device safety check equal to the Python reference on every instance of
     the f=1 run, and one planted conflict caught on the card;
  8. config #3 on the lane engine at full width (64 nodes, Pareto delay, 5%
     drop, 1,000 instances, 256-slot inboxes, 16 lanes, drain 8):
     select_queue_events launches = drain x windows; windows, ms per
     window, events/s, rounds/s, drops, inbox-full, peak memory; then 3
     instances re-run on the CPU, every leaf equal; then a few windows of a
     fresh fleet under torch.profiler;
  9. config #5 on the lane engine at full width (16 nodes, 2-chain, uniform
     delay, 256-slot inboxes, 10,000 instances), as phase 8 without the
     profile.

Only the horizon (max_clock) of a main path is cut, to fit the time limit;
each cut is printed.  Every path is driven with the launch counts set to 0
just before it and read just after.  Prints the kernel table as one JSON
line, the card's name and power limit, and last the result line.  Any
mismatch or exception exits non-zero; with no GPU it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
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
COLD_SETS = 10                 # input sets cycled by cold_ms (at least),
COLD_BYTES = 80e6              # and together at least this much: > the 50 MB L2
WIDE_M = (400, 640)            # wide rows: staged above 48 KB; past a block's shared memory
PLAIN_CALLS = 16               # calls per cold_ms round of a plain version (~20 kernels each)
FULL_CLOCK = 1000              # the BASELINE configs' horizon
LANE_PICKS = 3                 # lane instances re-run on the CPU


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


def queue_inputs(b, cm, n, kind_timer, seed, device, in_place=True):
    """The engine's queue leaves and timers at [B, cm] and [B, n].

    Rows: message/timer ties (a valid message equal to a timer in time and
    stamp, with the timer's kind or a lower one), all-invalid rows with
    all-NEVER timers, full queues, then random rows with ~50% valid slots.
    Invalid slots keep small stale times, kinds and stamps (their times lie
    below every valid one).  With ``in_place`` the leaves are [B, cm] views
    of [B, cm + 1] buffers made by scatter_set as the engine's step makes
    them (2n + 1 targets per row, the sentinel cm for unused ones);
    otherwise they are the contiguous leaves of the first step."""
    from librabft_simulator_tpu_torch.utils.xops import scatter_set

    rng = np.random.default_rng(seed)
    valid = rng.random((b, cm)) < 0.5
    time_ = rng.integers(5, 100, (b, cm)).astype(np.int32)
    kind = rng.integers(0, 4, (b, cm)).astype(np.int32)
    stamp = rng.integers(0, 1 << 20, (b, cm)).astype(np.int32)
    stale = ~valid
    time_[stale] = rng.integers(0, 3, int(stale.sum()))
    stamp[stale] = rng.integers(0, 3, int(stale.sum()))
    t_time = rng.integers(5, 100, (b, n)).astype(np.int32)
    t_stamp = rng.integers(0, 1 << 20, (b, n)).astype(np.int32)
    e = min(256, b // 8)
    ties = np.arange(e)
    col, tcol = rng.integers(0, cm, e), rng.integers(0, n, e)
    t_time[ties, tcol] = 4
    valid[ties, col] = True
    time_[ties, col] = 4
    stamp[ties, col] = t_stamp[ties, tcol]
    kind[ties, col] = np.where(ties % 2 == 0, kind_timer, kind_timer - 1)
    dead = np.arange(e, 2 * e)           # all invalid, all-NEVER timers
    valid[dead] = False
    t_time[dead] = NEVER
    stamp[dead] = rng.integers(0, 3, (e, cm))
    t_stamp[dead] = rng.integers(0, 3, (e, n))
    valid[2 * e:3 * e] = True            # full queues
    leaves = [torch.as_tensor(x, device=device)
              for x in (valid, time_, kind, stamp, t_time, t_stamp)]
    if in_place:
        k = 2 * n + 1
        tgt = np.full((b, k), cm, np.int32)
        slots = np.argsort(rng.random((b, cm)), axis=1)[:, :3].astype(np.int32)
        tgt[3 * e:, :3] = slots[3 * e:]
        tgt = torch.as_tensor(tgt, device=device)
        src = [torch.as_tensor(x, device=device) for x in (
            rng.integers(5, 100, (b, k)).astype(np.int32),
            rng.integers(0, 4, (b, k)).astype(np.int32),
            rng.integers(1 << 20, 1 << 21, (b, k)).astype(np.int32))]
        leaves[0] = scatter_set(leaves[0], tgt, True)
        for i in range(3):
            leaves[1 + i] = scatter_set(leaves[1 + i], tgt, src[i])
    return leaves


def former_select_step(valid, time_, kind, stamp, t_time, t_stamp, kind_timer):
    """The engine's select step before select_queue_events: the [B, cm + n]
    rows built with where and three cats, then the select_events kernel."""
    from librabft_simulator_tpu_torch.ops import select_events as sel
    from librabft_simulator_tpu_torch.utils.xops import const

    b, n = t_time.shape
    msg_time = torch.where(valid, time_, NEVER)
    all_time = torch.cat([msg_time, t_time], dim=1)
    all_kind = torch.cat([kind, const((b, n), kind_timer, torch.int32, valid.device)], dim=1)
    all_stamp = torch.cat([stamp, t_stamp], dim=1)
    return sel.select_events(all_time, all_kind, all_stamp)


def check_equal(got, want, label):
    """Bit-for-bit equality of (idx, t_min) pairs; returns the max abs error."""
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{label}: kernel != plain, max err {err}")
    return err


def bound(nbytes, ops):
    """Least device time (ms) for the bytes and operations, and which bounds."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


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


def cold_ms(fn, sets, calls=64, rounds=5):
    """Median over ``rounds`` of the device time (ms) per call of ``fn(x)``,
    from CUDA events around ``calls`` back-to-back calls that cycle through
    the input ``sets``.  The sets together exceed the 50 MB L2, so each call
    finds its inputs cold, and no flush kernel leaves dirty lines for the
    call to write back.  A spin kernel queued first, four times as long as
    the host took to issue the warm-up calls, lets the host issue every call
    before the card reaches them (checked: the start event must still be
    pending after the last call is issued), so the events bracket device
    work only; the gaps between back-to-back kernels count.  ``calls``
    times the kernels per call must stay below the device's queue of
    pending launches (about a thousand), or the host waits for the spin."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in sets:
        fn(x)
    host_s = (time.perf_counter() - t0) / len(sets) * calls
    spin_cycles = int(min(4e9, max(2e7, 4 * host_s * 2e9)))  # <= 2 GHz clock
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(sets[i % len(sets)])
        end.record()
        if start.query():
            raise RuntimeError("cold_ms: the card reached the calls before the "
                               "host had issued them all")
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
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


def profile_device(step, st, steps, unit, warm=4):
    """``steps`` calls of ``step`` (one batch step or one window) after
    ``warm`` more, under torch.profiler: wall and device time per call, the
    device's busy share, launches per call and the kernels that take the
    most device time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        for _ in range(warm):  # warm the allocator and caches
            st = step(st)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                st = step(st)
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
    print(f"   {steps} {unit}s: wall {wall / steps * 1e3:.3f} ms/{unit}")
    if not rows:
        print("   device time: not measured (the profiler saw no device kernels)")
        return
    dev = sum(r[0] for r in rows) / 1e3 / steps
    launches = sum(r[1] for r in rows) / steps
    print(f"   device kernel time {dev:.3f} ms/{unit}, busy share "
          f"{dev / (wall / steps * 1e3):.4f}, kernels launched {launches:.1f}/{unit}")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"   {dev_us / 1e3 / steps:9.4f} ms/{unit} {count / steps:8.1f}/{unit}  {key[:90]}")


def lane_inputs(rows, ic, seed, device):
    """Lane inbox rows as a drain iteration gathers them ([rows, IC]):
    ~half the slots valid, stale times, kinds and stamps in the rest,
    message kinds 0-2, one timer per row; rows tie a message with the timer,
    or are empty with a NEVER timer."""
    rng = np.random.default_rng(seed)
    valid = rng.random((rows, ic)) < 0.5
    time_ = rng.integers(0, 100, (rows, ic)).astype(np.int32)
    kind = rng.integers(0, 3, (rows, ic)).astype(np.int32)
    stamp = rng.integers(0, 1 << 20, (rows, ic)).astype(np.int32)
    timer = rng.integers(0, 120, rows).astype(np.int32)
    e = min(256, rows // 8)
    valid[:e, 7], time_[:e, 7], timer[:e] = True, 0, 0
    valid[e:2 * e], timer[e:2 * e] = False, NEVER
    return [torch.as_tensor(x, device=device) for x in (valid, time_, kind, stamp, timer)]


def counted_run(sel, run):
    """``run()`` with both entries' launch counts set to 0 just before it;
    returns its result, its wall seconds and the counts just after."""
    sel.select_events.launches = 0
    sel.select_queue_events.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {"select_events": sel.select_events.launches,
                       "select_queue_events": sel.select_queue_events.launches}


def fleet_line(st, wall, steps, unit):
    """Events, rounds (per instance the highest round any node reached,
    minus 1, summed, as bench.py counts them), rates and losses."""
    events = int(st.n_events.sum())
    rounds = int((st.store.current_round.max(dim=1).values - 1).sum())
    full = st.n_queue_full if hasattr(st, "n_queue_full") else st.n_inbox_full
    print(f"   events {events}, rounds {rounds}, {unit}s {steps}, wall {wall:.3f} s, "
          f"events/s {events / wall:.1f}, rounds/s {rounds / wall:.1f}, "
          f"ms/{unit} {wall / steps * 1e3:.3f}")
    print(f"   all halted {bool(st.halted.all())}, mean commits/node "
          f"{float(st.ctx.commit_count.float().mean()):.3f}, min commits/node "
          f"{int(st.ctx.commit_count.min())}, sent {int(st.n_msgs_sent.sum())}, "
          f"dropped {int(st.n_msgs_dropped.sum())}, {'queue' if hasattr(st, 'n_queue_full') else 'inbox'}"
          f"-full {int(full.sum())}, peak mem "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")


def leaves_equal(ref: dict, got: dict, label):
    bad = []
    for path, a in ref.items():
        b = got[path]
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
            bad.append(path)
    if bad:
        raise AssertionError(f"{label}: {len(bad)} leaves differ, first {bad[:5]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max_clock", type=int, default=300,
                    help="horizon of config #2 (the BASELINE 1000, cut to fit the time limit)")
    ap.add_argument("--byz_clock", type=int, default=150, help="horizon of config #4")
    ap.add_argument("--c3_clock", type=int, default=30, help="horizon of config #3")
    ap.add_argument("--c5_clock", type=int, default=65, help="horizon of config #5")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2

    from librabft_simulator_tpu_torch.convert import to_reference
    from librabft_simulator_tpu_torch.core.types import KIND_TIMER, SimParams
    from librabft_simulator_tpu_torch.ops import select_events as sel
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
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
    # The lane configs as bench.py's BASELINE sweep runs them (bench.py:433-446).
    p3 = SimParams(n_nodes=64, delay_kind="pareto", drop_prob=0.05, max_clock=args.c3_clock)
    p5 = SimParams(n_nodes=16, delay_kind="uniform", commit_chain=2, inbox_cap=256,
                   max_clock=args.c5_clock)
    lane_cfgs = {"config #3": (p3, 1000), "config #5": (p5, 10000)}
    b = INSTANCES
    m_main = p.queue_cap + p.n_nodes
    t = phase("3. kernel vs plain")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    spin_up()
    tiny = torch.empty(1, device=dev)
    print(f"   floor of the single-call method (a 1-element fill): "
          f"{device_ms(lambda: tiny.fill_(1), 25, flush):.4f} ms; back to back: "
          f"{cold_ms(lambda x: x.fill_(1), [tiny]):.5f} ms per call")
    rows = {}
    # select_events: the TPU kernel's own [B, M] contract.
    for m, pad in ((m_main, 0), (32 + 4, 0), (m_main, 1)):
        base = select_inputs(b, m + pad, 1234 + m + pad, dev)
        ins = [x[:, :m] for x in base]
        label = f"select_events B={b} M={m}" + (f" (row stride {m + pad})" if pad else "")
        err = check_equal(sel.select_events(*ins), sel.select_events_plain(*ins), label)
        rows.setdefault("select_events", dict(max_abs_err=0))
        rows["select_events"]["max_abs_err"] = max(rows["select_events"]["max_abs_err"], err)
        ms = device_ms(lambda: sel.select_events(*ins), 25, flush)
        plain_ms = device_ms(lambda: sel.select_events_plain(*ins), 25, flush)
        print(f"   {label}: equal (incl. tie and all-NEVER rows); single call after a "
              f"dirty L2 flush: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
              f"with the host's issue time: kernel "
              f"{time_cuda(lambda: sel.select_events(*ins), 25, flush):.4f} ms")
        if m == m_main and not pad:
            rows["select_events"].update(ms=ms, plain_ms=plain_ms)
    for m in (m_main, 32 + 4):
        nsets = max(COLD_SETS, int(COLD_BYTES // (3 * b * m * 4)) + 1)
        s_sets = [select_inputs(b, m, 500 + i, dev) for i in range(nsets)]
        ms = cold_ms(lambda x: sel.select_events(*x), s_sets)
        plain_ms = cold_ms(lambda x: sel.select_events_plain(*x), s_sets, calls=PLAIN_CALLS)
        hot_ms = cold_ms(lambda x: sel.select_events(*x), s_sets[:1])
        nbytes = 3 * b * m * 4 + 2 * b * 4
        bound_ms, bound_by = bound(nbytes, 4 * b * m)
        print(f"   select_events B={b} M={m}, cold inputs back to back: kernel {ms:.5f} ms "
              f"({bound_ms / ms:.1%} of its bound), plain {plain_ms:.5f} ms; inputs in L2: "
              f"kernel {hot_ms:.5f} ms; bytes bound {bound_ms:.5f} ms ({nbytes} B)")
        if m == m_main:
            rows["select_events"].update(cold_ms=ms, plain_cold_ms=plain_ms,
                                         bound_ms=bound_ms, bound_by=bound_by)
        del s_sets
    # select_queue_events: the engine's queue and timers, read in place.
    cm, n = p.queue_cap, p.n_nodes
    err = 0
    for bq, in_place in ((b, True), (b, False), (b - 3, True)):
        q_ins = queue_inputs(bq, cm, n, KIND_TIMER, 99 + bq, dev, in_place)
        label = (f"select_queue_events B={bq} cm={cm} n={n} "
                 f"(row strides {[x.stride(0) for x in q_ins]})")
        got = sel.select_queue_events(*q_ins, KIND_TIMER)
        err = max(err, check_equal(got, sel.select_queue_events_plain(*q_ins, KIND_TIMER), label))
        check_equal(got, former_select_step(*q_ins, KIND_TIMER), label + " vs former step")
        print(f"   {label}: equal (ties, stale invalid slots, all-invalid rows, full queues)")
    # Wide rows: a tile above the default 48 KB of shared memory (the kernel
    # opts in), and one past a block's shared memory (plain loads instead).
    for wm in WIDE_M:
        wide = select_inputs(b, wm, 77, dev)
        rows["select_events"]["max_abs_err"] = max(
            rows["select_events"]["max_abs_err"],
            check_equal(sel.select_events(*wide), sel.select_events_plain(*wide),
                        f"select_events M={wm}"))
        wide = queue_inputs(b, wm, 20, KIND_TIMER, 78, dev)
        err = max(err, check_equal(sel.select_queue_events(*wide, KIND_TIMER),
                                   sel.select_queue_events_plain(*wide, KIND_TIMER),
                                   f"select_queue_events cm={wm}"))
        del wide
        print(f"   wide rows (select_events M={wm}, select_queue_events cm={wm} n=20, "
              f"B={b}): equal")
    q_sets = [queue_inputs(b, cm, n, KIND_TIMER, 700 + i, dev) for i in range(COLD_SETS)]
    q_ins = q_sets[0]
    q_ms = device_ms(lambda: sel.select_queue_events(*q_ins, KIND_TIMER), 25, flush)
    q_plain_ms = device_ms(lambda: sel.select_queue_events_plain(*q_ins, KIND_TIMER), 25, flush)
    print(f"   select_queue_events B={b} in place, single call after a dirty L2 flush: "
          f"kernel {q_ms:.4f} ms, plain {q_plain_ms:.4f} ms, "
          f"former step {device_ms(lambda: former_select_step(*q_ins, KIND_TIMER), 25, flush):.4f} ms; "
          f"with the host's issue time: kernel "
          f"{time_cuda(lambda: sel.select_queue_events(*q_ins, KIND_TIMER), 25, flush):.4f} ms")
    new = lambda x: sel.select_queue_events(*x, KIND_TIMER)  # noqa: E731
    former = lambda x: former_select_step(*x, KIND_TIMER)  # noqa: E731
    turns = [cold_ms(f, q_sets) for f in (former, new, new, former)]
    plain_ms = cold_ms(lambda x: sel.select_queue_events_plain(*x, KIND_TIMER), q_sets,
                       calls=PLAIN_CALLS)
    hot_ms = cold_ms(new, q_sets[:1])
    ms = float(np.mean(turns[1:3]))
    nbytes = b * cm + 3 * b * cm * 4 + 2 * b * n * 4 + 2 * b * 4
    bound_ms, bound_by = bound(nbytes, 4 * b * (cm + n))
    print(f"   select_queue_events B={b} cm={cm} n={n} in place, cold inputs back to back: "
          f"kernel {ms:.5f} ms ({bound_ms / ms:.1%} of its bound), plain {plain_ms:.5f} ms; "
          f"inputs in L2: kernel {hot_ms:.5f} ms; bytes bound {bound_ms:.5f} ms ({nbytes} B)")
    print(f"   select step, cold inputs back to back, in turns (former, new, new, former): "
          f"{turns[0]:.5f}, {turns[1]:.5f}, {turns[2]:.5f}, {turns[3]:.5f} ms "
          f"(former = where + 3 cat + select_events; its timer-kind fill is a cached constant)")
    rows["select_queue_events"] = dict(max_abs_err=err, ms=q_ms, plain_ms=q_plain_ms,
                                       cold_ms=ms, plain_cold_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by)
    del q_sets
    # select_queue_events as the lane engine calls it: [B*A, IC] inbox rows,
    # one timer column (P.earliest), against the lane engine's plain _earliest.
    lane_rows = []
    for name, (pl, bl) in lane_cfgs.items():
        rows_, ic = bl * P.lanes_of(pl), P.inbox_cap(pl)
        l_ins = lane_inputs(rows_, ic, 31 + rows_, dev)
        label = f"select_queue_events {name} lanes: [{rows_}, {ic}] + 1 timer column"
        got = P.earliest(*l_ins)
        err = max(err, check_equal(got, P._earliest(*l_ins), label))
        q = [*l_ins[:4], l_ins[4].unsqueeze(1), torch.zeros((rows_, 1), dtype=torch.int32,
                                                            device=dev)]
        check_equal(sel.select_queue_events(*q, KIND_TIMER),
                    sel.select_queue_events_plain(*q, KIND_TIMER), label + " vs plain")
        l_ms = device_ms(lambda: sel.select_queue_events(*q, KIND_TIMER), 25, flush)
        l_plain = device_ms(lambda: P._earliest(*l_ins), 25, flush)
        nbytes = rows_ * ic + 3 * rows_ * ic * 4 + 2 * rows_ * 4 + 2 * rows_ * 4
        l_bound, l_by = bound(nbytes, 4 * rows_ * (ic + 1))
        print(f"   {label}: equal (ties, empty rows, NEVER timers); single call after a "
              f"dirty L2 flush: kernel {l_ms:.4f} ms ({l_bound / l_ms:.1%} of its bound), "
              f"plain _earliest {l_plain:.4f} ms; bytes bound {l_bound:.5f} ms ({nbytes} B)")
        lane_rows.append(dict(shape=f"{name}: [{rows_}, {ic}] + 1 timer", ms=l_ms,
                              plain_ms=l_plain, bound_ms=l_bound, bound_by=l_by))
        del l_ins, q
    rows["select_queue_events"]["max_abs_err"] = err
    rows["select_queue_events"]["lane_shapes"] = lane_rows
    print("   library call: none for either entry (no single PyTorch op computes "
          "this lexicographic argmin)")
    done("kernel vs plain", t)
    by_path = {}

    t = phase("4. main path, serial (config #2)")
    seeds = np.arange(b, dtype=np.uint32)
    if args.max_clock != FULL_CLOCK:
        print(f"   cut: max_clock {FULL_CLOCK} -> {args.max_clock}")
    torch.cuda.reset_peak_memory_stats()
    st, wall, launches = counted_run(sel, lambda: S.run_to_completion(
        p, S.init_batch(p, seeds, device="cuda"), batched=True))
    steps = S.run_to_completion.last_steps
    print(f"   config #2: n=4 uniform queue_cap={p.queue_cap} B={b} max_clock={p.max_clock}")
    fleet_line(st, wall, steps, "batch step")
    print(f"   launches {launches} (batch steps {steps})")
    if (not bool(st.halted.all()) or steps <= 0 or launches["select_events"]
            or launches["select_queue_events"] != steps):
        raise AssertionError(f"config #2: launches={launches} steps={steps}")
    if not float(st.ctx.commit_count.float().mean()) > 0:
        raise AssertionError("config #2: the fleet committed nothing")
    by_path["config #2 serial"] = launches["select_queue_events"]
    done("main path, serial (config #2)", t)

    t = phase("5. card vs CPU (config #2)")
    rng = np.random.default_rng(0)
    picks = sorted({0, b - 1, *rng.choice(np.arange(1, b - 1), 2, replace=False).tolist()})
    gpu = to_reference(S.select_instances(st, picks))
    cpu_st = S.run_to_completion(p, S.init_batch(p, seeds[picks], device="cpu"))
    leaves_equal(to_reference(cpu_st), gpu, "card vs CPU")
    print(f"   instances {picks}: every leaf equal ({len(gpu)} leaves)")
    del st, gpu, cpu_st
    done("card vs CPU (config #2)", t)

    t = phase("6. where the time goes (config #2)")
    dt, du = S.tables(p, "cuda")
    profile_device(lambda x: S.step(p, dt, du, x, False, False),
                   S.init_batch(p, seeds, device="cuda"), 8, "batch step")
    done("where the time goes (config #2)", t)

    t = phase("7. config #4: Byzantine f-sweep")
    by_path["config #4 f-sweep"] = fsweep_phase(args, sel, b)
    done("config #4: Byzantine f-sweep", t)

    for num, (name, (pl, bl)) in zip((8, 9), lane_cfgs.items()):
        t = phase(f"{num}. {name} on the lane engine")
        by_path[f"{name} lanes"] = lane_phase(name, pl, bl, sel, P, to_reference,
                                              profile=name == "config #3")
        done(f"{name} on the lane engine", t)

    kernels = []
    for name in ("select_queue_events", "select_events"):
        counts = by_path if name == "select_queue_events" else {}
        kernels.append(dict(name=name, route="cuda", source=KERNEL_SRC, replaces=KERNEL_TPU,
                            launches=sum(counts.values()), launches_by_path=counts,
                            library_ms=None, **rows[name]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def fsweep_phase(args, sel, b):
    """Config #4 through byzantine.f_sweep; returns the select launches."""
    from types import SimpleNamespace

    from librabft_simulator_tpu_torch.analysis.sweeps import baseline_configs
    from librabft_simulator_tpu_torch.sim import byzantine as B
    from librabft_simulator_tpu_torch.sim import simulator as S

    p4, n4, mode = baseline_configs()["4_byzantine_sweep_10k"]
    assert mode == "sweep" and n4 == b
    p4 = dataclasses.replace(p4, max_clock=args.byz_clock)
    print(f"   cut: max_clock {FULL_CLOCK} -> {p4.max_clock}; n={p4.n_nodes} "
          f"{p4.delay_kind} queue_cap={p4.queue_cap} B={n4}, f in (0, 1), equivocate")
    finals = []
    run = S.run_to_completion

    def recording(*a, **kw):  # keep each f's final state for the checks below
        st = run(*a, **kw)
        finals.append((st, S.run_to_completion.last_steps))
        return st

    S.run_to_completion = recording
    try:
        res, wall, launches = counted_run(sel, lambda: B.f_sweep(p4, n4, f_values=[0, 1]))
    finally:
        S.run_to_completion = run
    steps = sum(s for _, s in finals)
    for r in res:
        print(f"   f={r.f}: safe_fraction {r.safe_fraction}, live_fraction "
              f"{r.live_fraction}, mean honest commits {r.mean_commits:.3f}")
    print(f"   wall {wall:.3f} s for both f, batch steps {steps}, launches {launches}")
    if launches["select_queue_events"] != steps or launches["select_events"]:
        raise AssertionError(f"config #4: launches {launches} != batch steps {steps}")
    if any(r.safe_fraction != 1.0 or not r.live_fraction > 0 for r in res):
        raise AssertionError(f"config #4: {res}")
    st1 = finals[1][0]
    honest = np.arange(p4.n_nodes) >= 1
    dev_safe = B.check_safety(st1, honest)
    ref_safe = B.check_safety_reference(st1, honest)
    if not np.array_equal(dev_safe, ref_safe):
        raise AssertionError("config #4: device safety check != reference")
    print(f"   device check_safety == check_safety_reference on all {len(dev_safe)} "
          f"instances of the f=1 run")
    # Plant one conflict: honest node c's newest entry takes node a's newest
    # depth with another tag.
    ctx = st1.ctx
    cc = ctx.commit_count.cpu().numpy()
    h = ctx.log_depth.shape[2]
    i = int(np.flatnonzero((cc[:, 1] > 0) & (cc[:, 2] > 0))[0])
    pa, pc = (int(cc[i, 1]) - 1) % h, (int(cc[i, 2]) - 1) % h
    depth, tag = ctx.log_depth.clone(), ctx.log_tag.clone()
    depth[i, 2, pc] = depth[i, 1, pa]
    tag[i, 2, pc] = tag[i, 1, pa] ^ 1
    planted = SimpleNamespace(ctx=SimpleNamespace(
        log_depth=depth, log_tag=tag, commit_count=ctx.commit_count))
    safe = B.check_safety(planted, honest)
    if safe[i] or not safe[np.arange(len(safe)) != i].all():
        raise AssertionError("config #4: the planted conflict was not caught")
    print(f"   planted conflict in instance {i} (nodes 1 and 2): caught on the card")
    return launches["select_queue_events"]


def lane_phase(name, p, b, sel, P, to_reference, profile):
    """One lane config at full width: run, check launches, compare a few
    instances with the CPU, optionally profile; returns the select launches."""
    from librabft_simulator_tpu_torch.sim import simulator as S

    print(f"   {name}: n={p.n_nodes} {p.delay_kind} drop={p.drop_prob} "
          f"commit_chain={p.commit_chain} inbox={P.inbox_cap(p)} lanes={P.lanes_of(p)} "
          f"drain={P.drain_of(p)} B={b}; cut: max_clock {FULL_CLOCK} -> {p.max_clock}")
    seeds = np.arange(b, dtype=np.uint32)
    torch.cuda.reset_peak_memory_stats()
    st, wall, launches = counted_run(sel, lambda: P.run_to_completion(
        p, P.init_batch(p, seeds, device="cuda"), batched=True))
    windows = P.run_to_completion.last_steps
    fleet_line(st, wall, windows, "window")
    k = P.drain_of(p)
    print(f"   launches {launches} (windows {windows} x drain {k} = {windows * k})")
    if (not bool(st.halted.all()) or launches["select_events"]
            or launches["select_queue_events"] != k * windows):
        raise AssertionError(f"{name}: launches {launches}, windows {windows}")
    if not int(st.n_events.sum()) > 0:
        raise AssertionError(f"{name}: no events")

    t = time.perf_counter()
    rng = np.random.default_rng(1)
    picks = sorted({0, b - 1, *rng.choice(np.arange(1, b - 1), LANE_PICKS - 2,
                                          replace=False).tolist()})
    gpu = to_reference(S.select_instances(st, picks))
    del st
    cpu = to_reference(P.run_to_completion(p, P.init_batch(p, seeds[picks], device="cpu")))
    leaves_equal(cpu, gpu, f"{name} card vs CPU")
    print(f"   card vs CPU: instances {picks} equal in every leaf ({len(gpu)} leaves), "
          f"{time.perf_counter() - t:.3f} s")
    if profile:
        dt, du = S.tables(p, "cuda")
        profile_device(lambda x: P.step(p, dt, du, P.d_min_of(p), x, False, False),
                       P.init_batch(p, seeds, device="cuda"), 2, "window")
    return launches["select_queue_events"]


if __name__ == "__main__":
    sys.exit(main())
