"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--max_clock 250] [--byz_clock 100] [--c3_clock 30] [--c5_clock 65]
                          [--sc_clock 60 100] [--sc5_clock 60 70] [--sc5_clock3 85 95]
                          [--ring5_clock 40] [--serve_clock 40 80] [--serve_clock3 80 100]

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
     consecutive seeds; a halt read every 64 steps, where the fleet halts);
     select_queue_events' launch count must equal the batch steps run;
  5. card vs CPU: four of those instances re-run on the CPU with the plain
     select, every leaf compared bit for bit with the card's final rows;
  6. where the time goes (serial): 4 batch steps of a fresh fleet under
     torch.profiler (device busy share, kernels per step, top kernels);
  7. config #4: byzantine.f_sweep for f in {0, 1} (4 nodes, the sweep's
     SimParams, 10,000 instances, a halt read every 32 steps); safe
     fraction 1, live fraction > 0, the
     device safety check equal to the Python reference on every instance of
     the f=1 run, and one planted conflict caught on the card;
  8. config #3 on the lane engine at full width (64 nodes, Pareto delay, 5%
     drop, 1,000 instances, 256-slot inboxes, 16 lanes, drain 8):
     select_queue_events launches = drain x windows; windows, ms per
     window, events/s, rounds/s, drops, inbox-full, peak memory; fails
     unless some instance formed a round past the first; then 3
     instances re-run on the CPU, every leaf equal; then one window of a
     fresh fleet, after one, under torch.profiler;
  9. config #5 on the lane engine at full width (16 nodes, 2-chain, uniform
     delay, 256-slot inboxes, 10,000 instances), as phase 8 without the
     profile;
 10. config #2 with the telemetry plane and the consensus watchdog on
     (default flight_cap and stall threshold), through
     run_to_completion(stream=TimelineRecorder), in 64-step chunks, with the
     CPU workers stopped: ms per batch step beside phase 4's, launches per
     step under torch.profiler, the final digest and
     the merged telemetry block, and ms per step with the planes off and on
     in turns on one run; on every instance the plane's event counts
     sum to n_events and its drops and overflow equal the state's; the
     card's final digest equals compute_digest of the state's CPU copy; one
     instance carries a planted conflicting commit (tests/test_stream.py's
     doctor_ctx) that must trip safety_conflict and round_regress, and the
     picked instances (it among them) equal a CPU run in every leaf;
 11. config #5 on the lane engine with both planes and the stream: ms per
     window beside phase 9's (the same fleet, planes off); peak memory, the
     inbox overflow, high-water mark and saturation counts, the counter
     invariants, three instances equal a CPU run in every leaf.  Phases 9
     and 11 fail unless the fleet commits and its inboxes overflow, and
     phase 11 unless the watchdog's stall and queue-saturation detectors
     trip: a horizon too short for these paths fails, it does not pass
     quietly;
 12. a checkpoint round trip on the card: phase 10's fleet, saved
     (sim/checkpoint.py) after its fifth chunk (step 320), loaded on the
     card and on the CPU, equals the card's state it was saved from in every
     leaf; phase 15 resumes it and holds the result to phase 10's run, which
     went on in memory;
 13. the scenario and adversary planes on the serial engine at config #2's
     width (n=4, queue_cap 64, B=10,000, adv_windows 4): a fleet built by
     serve/scenario.init_specs from 10,000 ScenarioSpecs that cycle the
     delay family (uniform / lognormal / pareto), the 2- and 3-chain rule
     and a 0 or 5% drop rate, each with a per-slot max_clock (--sc_clock,
     the cut) and an attack from dsl.sample_program (f_max 1); the static
     Byzantine schedules go only on slots whose program has no Byzantine
     target.  Checks: launches = batch steps; both chains commit; picked
     slots (each family, both chains, a partition, a link matrix, an epoch
     and an events window, the slot with the most events, one at the top
     of --sc_clock, and a 3-chain and a 2-chain slot that committed) equal
     a CPU run of the same fleet in every leaf and their dedicated static
     runs on the CPU in every leaf but sc_*; the adv_* leaves are
     unchanged by the run; the device safety check with per-slot honest
     masks equals its reference on every slot.  Prints the safe fraction
     per commit chain, ms per batch step beside phase 4's, and kernels per
     step under torch.profiler (4 steps) of a copy of the unrun fleet with
     the run's Byzantine flags, then with the flags off, beside phase 6's;
 14. the same kind of fleet on the lane engine at config #5's shapes (n=16,
     inbox 256, 8 lanes, drain 4, B=10,000; families, so d_min differs by
     slot; chains 2 and 3; sample_program at n=16 with f_max 5, link
     matrices and partitions; per-slot max_clock from --sc5_clock on the
     2-chain slots and --sc5_clock3 on the 3-chain ones, where config #5
     makes its first commits on each rule), with the telemetry plane on
     for its counter invariants: launches = drain x windows, the
     invariants on every instance, the adv_* leaves unchanged,
     both chains commit, the device safety check equals its reference on
     every slot, and a committed 3-chain slot, a committed 2-chain slot and
     the slot with the most events equal a CPU run in every leaf; ms per
     window beside phase 9's, windows and peak memory; kernels per window
     under torch.profiler (1 window after 2) of a fresh fleet (config #5
     with the planes off is not profiled);
 15. the sharded runtime (parallel/sharded.py) and the runtime ledger
     (telemetry/ledger.py), with the CPU workers stopped during both runs.
     Serial: phase 12's checkpoint (phase 10's fleet at step 320) loaded by
     checkpoint.load_sharded onto a 3-shard mesh on the one card (10,000
     instances padded to 10,002 with pre-halted ones), run by run_sharded
     with wrap="device", ring_k 4, macro_k 4 and chunks of 4 macro-steps (16
     events, so one outer call retires up to one of phase 10's 64-step
     chunks) and a TimelineRecorder: the 10,000 real instances must equal
     phase 10's final state in every leaf (the resume of phase 12's
     checkpoint), every fourth ring row and the last equal phase 10's
     stream row at the same event count folded with the two padding
     instances' digests, select launches = event steps x shards, and from
     the ledger's ring_stats fewer ring fetches, and fewer waits on the
     device (ring fetches and halt reads that waited), than retired chunks;
     prints the halt reads and the seconds of each kind of poll span, and
     the ledger's compile entry of the kernel build.  Lanes: config #5's
     shapes (B=10,000, one shard, so the card holds the state once) through
     run_sharded with the device wrap, horizon --ring5_clock (cut):
     launches = drain x windows, three instances equal a CPU run, the last
     ring row equals compute_digest of the final state, peak memory at most
     phase 9's + 1 GB, the same ring_stats checks.  Prints ms per event step
     and per window beside phases 10 and 9 and the ledger's pipeline stats.
 16. the resident fleet service (serve/service.py, serve/api.py) at config
     #2's width: FleetService on one shard of 10,000 slots (n=4, uniform,
     queue_cap 64, the scenario and adversary planes, adv_windows 4, the
     watchdog; telemetry off), 32-event chunks.  12,500 requests from phase
     13's generator (per-request max_clock from --serve_clock on the 2-chain
     requests and --serve_clock3 on the 3-chain ones, where that rule first
     commits) are written as NDJSON and read by FleetService.submit_file;
     the double-buffered digest pump serves until an admission wave has
     landed in slots that egress freed and every admitted request has run a
     polled chunk, the service is preempted to a checkpoint, resumed under
     the device-wrap ring (ring_k 4) and drained.  Checks: every id
     egressed once; each result's events, clock, commits, committed round,
     messages sent and dropped, safety and watchdog trips equal its row of
     one static fleet run of all 12,500 specs on the card (init_specs +
     run_to_completion); picked requests (a committed request of each
     chain, an attacked one, one of the second wave, one active at the
     preemption) equal a CPU run; both chains commit; the stream holds
     submitted, admitted, first_chunk and egressed for every id; the host
     wrap reads one digest per polled chunk and the halted plane only at
     egress boundaries, the ring waits less than once per retired chunk;
     select launches on the serve path = event steps x shards.  Prints ms
     per event step beside phase 13's, seconds per admission wave and per
     egress, requests per second, ttfc p50/p99 and peak memory; the CPU
     workers are stopped while the service runs.

The card-vs-CPU re-runs of phases 5-16 go to two worker processes
(``CpuChecks``) while the card runs the later phases; their comparisons are
printed, and fail the script, after phase 16.  The workers are stopped
(SIGSTOP) during the timed runs of phases 9, 10, 15 and 16, whose figures are
set side by side; every other timed run prints how many reference runs were
pending at its start and end, the load it shared the host with.  Only the
horizon (max_clock) of a main path is cut, to fit the time limit; each cut
is printed.  Profiles are summed from the profiler's raw device events
(``kernel_rows``), not torch's post-processing.  Every path is driven with
the launch counts set to 0 just before it and read just after.  Prints the
kernel table as one JSON line, the card's name and power limit, and last
the result line.  Any mismatch or exception exits non-zero; with no GPU it
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
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
# Profiled calls: the profiler's post-processing takes ~0.35 ms per kernel on
# the card's host, so the depth is cut to 4 batch steps (8 before PR 6) and 1
# window after 2 warm ones (2 after 4 before PR 6) to keep the script short.
PROFILE_STEPS = 4
PROFILE_WINDOWS = 1
FULL_CLOCK = 1000              # the BASELINE configs' horizon
LANE_PICKS = 3                 # lane instances re-run on the CPU
DOCTOR_I = 3                   # phase 10's instance with a planted conflicting commit
FAMILIES = ("uniform", "lognormal", "pareto")
SERIAL_CHUNK = 64              # config #2's halt reads (phases 4, 10): at max_clock 250 its
                               # busiest instance runs 375 events (a CPU run of the fleet)
CKPT_CHUNKS = 5                # phase 10 saves its fleet after this many chunks (step 320)
SWEEP_CHUNK = 32               # config #4's halt reads (phase 7)
SHARDS = 3                     # phase 15's serial mesh: 10,000 pads to 10,002
RING_K = 4                     # phase 15's ring depth, both engines
MACRO_K = 4                    # phase 15's serial macro-step width
RING_CHUNK = SERIAL_CHUNK // (RING_K * MACRO_K)  # its chunk in macro-steps: a ring call
                                                 # retires one of phase 10's chunks
SERVE_SLOTS = 10000            # phase 16's resident fleet: config #2's width
SERVE_REQUESTS = 12500         # 1.25 x the slots: 2,500 go into slots that egress freed
SERVE_CHUNK = 32               # phase 16's chunk (event steps)
SERVE_RING_K = 4               # the ring depth of its resumed leg
SERVE_MAX_CHUNKS = 64          # the chunks its first leg may take to land an admission wave
CPU_WORKERS = 2                # processes that run the CPU reference runs meanwhile
CPU_THREADS = 1                # torch threads in each (the card's host is shared)
CHECKS = None                  # the CpuChecks of this run (main)


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


def kernel_rows(prof):
    """[(device us, launches, name)] per kernel name of a finished
    torch.profiler run, summed from the profiler's raw device events: its
    own post-processing (key_averages) takes ~0.35 ms per kernel on the
    card's host, a minute for one config #3 window.  A torch without these
    events fails here."""
    agg = {}
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        row = agg.setdefault(e.name(), [0.0, 0])
        row[0] += e.duration_ns() / 1e3
        row[1] += 1
    return [(us, n, name) for name, (us, n) in agg.items() if us > 0]


def profile_device(step, st, steps, unit, warm=4):
    """``steps`` calls of ``step`` (one batch step or one window) after
    ``warm`` more, under torch.profiler: wall and device time per call, the
    device's busy share, launches per call and the kernels that take the
    most device time.  Returns the state after the last call."""
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
    rows = kernel_rows(prof)
    print(f"   {steps} {unit}s after {warm} (cut; see PROFILE_STEPS): wall "
          f"{wall / steps * 1e3:.3f} ms/{unit}")
    if not rows:
        print("   device time: not measured (the profiler saw no device kernels)")
        return st
    dev = sum(r[0] for r in rows) / 1e3 / steps
    launches = sum(r[1] for r in rows) / steps
    print(f"   device kernel time {dev:.3f} ms/{unit}, busy share "
          f"{dev / (wall / steps * 1e3):.4f}, kernels launched {launches:.1f}/{unit}")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"   {dev_us / 1e3 / steps:9.4f} ms/{unit} {count / steps:8.1f}/{unit}  {key[:90]}")
    return st


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


def counted_run(sel, run, pause=False):
    """``run()`` with both entries' launch counts set to 0 just before it;
    returns its result, its wall seconds and the counts just after.  With
    ``pause`` the CPU workers are stopped while it runs; else the reference
    runs still pending at its start and end are printed, the load it shared
    the host with."""
    sel.select_events.launches = 0
    sel.select_queue_events.launches = 0
    torch.cuda.synchronize()
    pending = CHECKS.pending() if CHECKS else 0
    with CHECKS.paused() if pause and CHECKS else contextlib.nullcontext():
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print("   CPU workers: " + ("stopped during this run" if pause and CHECKS else
                                f"{pending} reference runs pending at this run's start, "
                                f"{CHECKS.pending() if CHECKS else 0} at its end"))
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


def cpu_fleet(engine, p, seeds, doctor_row=None):
    """A CPU reference run (in the worker): init_batch of ``seeds`` on the
    serial or the lane engine (with ``doctor_row``, phase 10's doctored
    fleet), run to completion, as to_reference leaves."""
    from librabft_simulator_tpu_torch.convert import to_reference
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S

    eng = P if engine == "lanes" else S
    st = (doctored_fleet(S, p, seeds, "cpu", doctor_row) if doctor_row is not None
          else eng.init_batch(p, seeds, device="cpu"))
    return to_reference(eng.run_to_completion(p, st))


def cpu_specs(engine, p, specs, chunk):
    """A CPU reference run (in the worker) of a scenario fleet built from
    ``specs``."""
    from librabft_simulator_tpu_torch.convert import to_reference
    from librabft_simulator_tpu_torch.serve import scenario as sc
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S

    eng = P if engine == "lanes" else S
    st = sc.init_specs(p, specs, engine=eng, device="cpu")
    return to_reference(eng.run_to_completion(p, st, **({"chunk": chunk} if chunk else {})))


def cpu_dedicated(p, spec):
    """A scenario slot's dedicated static run on the CPU (in the worker): its
    params (``to_params``), its static masks and its attack program
    installed; every leaf but sc_*."""
    from librabft_simulator_tpu_torch.convert import to_reference
    from librabft_simulator_tpu_torch.sim import simulator as S

    pi = spec.to_params(p)
    eq, silent, forge = spec.byz_masks(p)
    ded = S.init_batch(pi, [spec.seed], byz_equivocate=eq, byz_silent=silent,
                       byz_forge_qc=forge, device="cpu")
    ded = to_reference(S.run_to_completion(pi, spec.attack_program().install(pi, ded), chunk=32))
    return {k: v for k, v in ded.items() if not k.startswith("sc_")}


def _worker_init():
    torch.set_num_threads(CPU_THREADS)


class CpuChecks:
    """The card-vs-CPU comparisons.  Each phase hands its card rows and the
    CPU reference run they must equal to a pool of worker processes and
    goes on; the card runs the later phases while the workers run the
    references, and :meth:`finish` compares every pair in every leaf (any
    mismatch or worker error fails the script)."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing

        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init)
        self.jobs = []

    def submit(self, label, want, what, fn, *args):
        """Compare ``want`` (to_reference leaves of the card's rows) with
        ``fn(*args)`` run on a worker."""
        self.jobs.append((label, want, what, self.pool.submit(fn, *args)))

    def pending(self) -> int:
        """Reference runs not yet finished."""
        return sum(not fut.done() for *_, fut in self.jobs)

    @contextlib.contextmanager
    def paused(self):
        """The worker processes stopped (SIGSTOP) for a timed run, so that it
        has the host to itself, and resumed after it."""
        pids = [proc.pid for proc in self.pool._processes.values()]
        for pid in pids:
            os.kill(pid, signal.SIGSTOP)
        try:
            yield
        finally:
            for pid in pids:
                os.kill(pid, signal.SIGCONT)

    def finish(self):
        for label, want, what, fut in self.jobs:
            leaves_equal(fut.result(), want, label)
            print(f"   {label}: {what} equal in every leaf ({len(want)} leaves)")
        self.jobs = []

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


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
    ap.add_argument("--max_clock", type=int, default=250,
                    help="horizon of config #2 (the BASELINE 1000, cut to fit the time limit)")
    ap.add_argument("--byz_clock", type=int, default=100, help="horizon of config #4")
    ap.add_argument("--c3_clock", type=int, default=30,
                    help="horizon of config #3 (at 28 or less no instance of a CPU sample "
                    "formed a round)")
    ap.add_argument("--c5_clock", type=int, default=65,
                    help="horizon of config #5 (phases 9 and 11 fail below its first "
                         "commits and overflow)")
    ap.add_argument("--sc_clock", type=int, nargs=2, default=(60, 100),
                    help="range of the per-slot horizons of phase 13's fleet")
    ap.add_argument("--sc5_clock", type=int, nargs=2, default=(60, 70),
                    help="range of the per-slot horizons of phase 14's 2-chain slots")
    ap.add_argument("--sc5_clock3", type=int, nargs=2, default=(85, 95),
                    help="range of the per-slot horizons of phase 14's 3-chain slots "
                         "(the 3-chain rule commits a round later)")
    ap.add_argument("--ring5_clock", type=int, default=40,
                    help="horizon of phase 15's config #5 fleet under the device wrap")
    ap.add_argument("--serve_clock", type=int, nargs=2, default=(40, 80),
                    help="range of the per-request horizons of phase 16's 2-chain requests")
    ap.add_argument("--serve_clock3", type=int, nargs=2, default=(80, 100),
                    help="range of the per-request horizons of phase 16's 3-chain requests "
                         "(the 3-chain rule commits later)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    global CHECKS
    checks = CHECKS = CpuChecks()
    try:
        return run_phases(args, checks)
    finally:
        checks.close()


def run_phases(args, checks):
    """Phases 1-16 (the module docstring), then the card-vs-CPU
    comparisons that ``checks`` ran meanwhile, the kernel line, the card and
    the result line."""
    from librabft_simulator_tpu_torch.convert import to_reference
    from librabft_simulator_tpu_torch.core.types import KIND_TIMER, SimParams
    from librabft_simulator_tpu_torch.ops import select_events as sel
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S

    dev = torch.device("cuda")
    t_start = t = phase("1. card")
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
        p, S.init_batch(p, seeds, device="cuda"), chunk=SERIAL_CHUNK, batched=True))
    steps = S.run_to_completion.last_steps
    print(f"   config #2: n=4 uniform queue_cap={p.queue_cap} B={b} max_clock={p.max_clock}, "
          f"a halt read every {SERIAL_CHUNK} steps")
    fleet_line(st, wall, steps, "batch step")
    print(f"   launches {launches} (batch steps {steps})")
    if (not bool(st.halted.all()) or steps <= 0 or launches["select_events"]
            or launches["select_queue_events"] != steps):
        raise AssertionError(f"config #2: launches={launches} steps={steps}")
    if not float(st.ctx.commit_count.float().mean()) > 0:
        raise AssertionError("config #2: the fleet committed nothing")
    by_path["config #2 serial"] = launches["select_queue_events"]
    serial_ms = wall / steps * 1e3
    done("main path, serial (config #2)", t)

    t = phase("5. card vs CPU (config #2)")
    rng = np.random.default_rng(0)
    picks = sorted({0, b - 1, *rng.choice(np.arange(1, b - 1), 2, replace=False).tolist()})
    checks.submit("card vs CPU (config #2)", to_reference(S.select_instances(st, picks)),
                  f"instances {picks}", cpu_fleet, "serial", p, seeds[picks])
    del st
    done("card vs CPU (config #2)", t)

    t = phase("6. where the time goes (config #2)")
    dt, du = S.tables(p, "cuda")
    profile_device(lambda x: S.step(p, dt, du, x, False, False),
                   S.init_batch(p, seeds, device="cuda"), PROFILE_STEPS, "batch step")
    done("where the time goes (config #2)", t)

    t = phase("7. config #4: Byzantine f-sweep")
    by_path["config #4 f-sweep"] = fsweep_phase(args, sel, b)
    done("config #4: Byzantine f-sweep", t)

    window_ms = {}
    for num, (name, (pl, bl)) in zip((8, 9), lane_cfgs.items()):
        t = phase(f"{num}. {name} on the lane engine")
        by_path[f"{name} lanes"], window_ms[name] = lane_phase(
            name, pl, bl, sel, P, to_reference, profile=name == "config #3", checks=checks,
            pause=name == "config #5")
        done(f"{name} on the lane engine", t)
    peak9 = torch.cuda.max_memory_allocated()  # phase 9's run (its CPU check uses no card)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        pt = dataclasses.replace(p, telemetry=True, watchdog=True)
        t = phase("10. telemetry and watchdog, serial (config #2)")
        (by_path["config #2 serial, planes on"], final, mid, mid_steps, path, rows10,
         planes_ms) = serial_planes_phase(pt, b, sel, to_reference, serial_ms, tmp, checks)
        done("telemetry and watchdog, serial (config #2)", t)

        t = phase("11. config #5 on the lane engine, planes and stream on")
        p5t = dataclasses.replace(p5, telemetry=True, watchdog=True)
        from librabft_simulator_tpu_torch.telemetry.stream import TimelineRecorder
        with TimelineRecorder(p5t, total_instances=10000,
                              out=os.path.join(tmp, "config5.ndjson")) as rec:
            by_path["config #5 lanes, planes on"], ms = lane_phase(
                "config #5", p5t, 10000, sel, P, to_reference, profile=False, checks=checks,
                stream=rec)
        print(f"   ms per window: planes on {ms:.3f}, off {window_ms['config #5']:.3f} "
              f"(phase 9, the same fleet with the planes off); stream: {len(rec.rows)} "
              f"chunks, final digest {json.dumps(rec.summary()['final'])}")
        done("config #5 on the lane engine, planes and stream on", t)

        t = phase("12. checkpoint round trip on the card (config #2, planes on)")
        checkpoint_phase(pt, to_reference, mid, path)
        done("checkpoint round trip on the card (config #2, planes on)", t)
        del mid

        t = phase("13. scenario and adversary planes, serial (config #2's width)")
        p13 = dataclasses.replace(p, scenario=True, adversary=True, adv_windows=4)
        by_path["config #2 serial, scenario and adversary"], ms13 = serial_scenario_phase(
            p13, b, {3: args.sc_clock, 2: args.sc_clock}, sel, to_reference, serial_ms, checks)
        done("scenario and adversary planes, serial (config #2's width)", t)

        t = phase("14. scenario and adversary planes, lanes (config #5's shapes)")
        p14 = dataclasses.replace(p5, scenario=True, adversary=True, adv_windows=4,
                                  telemetry=True)
        by_path["config #5 lanes, scenario and adversary"] = lane_scenario_phase(
            p14, 10000, {2: args.sc5_clock, 3: args.sc5_clock3}, sel, to_reference,
            window_ms["config #5"], checks)
        done("scenario and adversary planes, lanes (config #5's shapes)", t)

        t = phase("15. sharded runtime and runtime ledger (configs #2 and #5)")
        by_path.update(sharded_phase(args, pt, p5, b, sel, to_reference, final, rows10, path,
                                     mid_steps, planes_ms, window_ms["config #5"], peak9, tmp,
                                     checks))
        done("sharded runtime and runtime ledger (configs #2 and #5)", t)

        t = phase("16. resident fleet service (config #2's width)")
        p16 = dataclasses.replace(p, scenario=True, adversary=True, adv_windows=4,
                                  watchdog=True)
        by_path.update(serve_phase(args, p16, sel, serial_ms, ms13, checks, tmp))
        done("resident fleet service (config #2's width)", t)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t = phase("card vs CPU: the reference runs of phases 5-16 on the CPU worker")
    checks.finish()
    done("card vs CPU", t)

    kernels = []
    for name in ("select_queue_events", "select_events"):
        counts = by_path if name == "select_queue_events" else {}
        kernels.append(dict(name=name, route="cuda", source=KERNEL_SRC, replaces=KERNEL_TPU,
                            launches=sum(counts.values()), launches_by_path=counts,
                            library_ms=None, **rows[name]))
    print(json.dumps({"kernels": kernels}))
    print(f"   total: {time.perf_counter() - t_start:.3f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def fleet_specs(p, b, clocks, f_max, statics):
    """``b`` ScenarioSpecs for the scenario phases: slot i cycles the delay
    family, then the commit chain, then the drop rate; its horizon lies in
    ``clocks[chain]``, a (lo, hi) range per commit chain; its attack is
    ``sample_program(p, Random(i), horizon, f_max)``.  With ``statics``,
    slots whose program has no Byzantine target cycle the static schedules
    (one author), so no slot has more than one Byzantine author when f_max
    is 1."""
    import random

    from librabft_simulator_tpu_torch.adversary import dsl
    from librabft_simulator_tpu_torch.serve import scenario as sc
    from librabft_simulator_tpu_torch.sim.byzantine import SCHEDULES

    specs = []
    for i in range(b):
        chain = (3, 2)[(i // 3) % 2]
        lo, hi = clocks[chain]
        mc = lo + (i * 7919) % (hi - lo + 1)
        prog = dsl.sample_program(p, random.Random(i), horizon=mc, f_max=f_max)
        kind = "honest"
        if statics and not dsl.byz_targets(prog):
            kind = SCHEDULES[(i // 12) % len(SCHEDULES)]
        specs.append(sc.ScenarioSpec(
            delay_kind=FAMILIES[i % 3], commit_chain=chain,
            drop_prob=(0.0, 0.05)[(i // 6) % 2], max_clock=mc, byz_kind=kind,
            byz_f=0 if kind == "honest" else 1, seed=i, attack=prog.to_dict()))
    return specs


def clock_ranges(clocks):
    return ", ".join(f"[{lo}, {hi}] ({c}-chain)" for c, (lo, hi) in sorted(clocks.items()))


def coverage_picks(specs, events, commits):
    """The slots the card-vs-CPU checks compare: for each feature the slot
    of the least horizon that has it (each delay family, both chains, a
    partition, a link matrix, an epoch window, an events window, a static
    schedule, a drop rate), then the deep ones: the slot with the most
    ``events``, the busiest slot at the top horizon, and the 3-chain and
    2-chain slots with the most ``commits``.  Returns (slots, feature
    names)."""
    feats = {f"family {f}": (lambda s, f=f: s.delay_kind == f) for f in FAMILIES}
    feats.update({
        "2-chain": lambda s: s.commit_chain == 2,
        "3-chain": lambda s: s.commit_chain == 3,
        "partition": lambda s: "partition" in s.attack,
        "link matrix": lambda s: "link_delay" in s.attack,
        "epoch window": lambda s: any(w["mode"] == "epoch" for w in s.attack["windows"]),
        "events window": lambda s: any(w["mode"] == "events" for w in s.attack["windows"]),
        "static schedule": lambda s: s.byz_kind != "honest",
        "drop": lambda s: s.drop_prob > 0,
    })
    order = sorted(range(len(specs)), key=lambda i: (specs[i].max_clock, i))
    picks = []
    for pred in feats.values():
        if not any(pred(specs[i]) for i in picks):
            picks.append(next(i for i in order if pred(specs[i])))
    top = max(s.max_clock for s in specs)
    chains = np.asarray([s.commit_chain for s in specs])
    deep = {"most events": int(np.argmax(events)),
            f"top horizon {top}": max((i for i, s in enumerate(specs) if s.max_clock == top),
                                      key=lambda i: events[i])}
    for c in (3, 2):
        deep[f"committed {c}-chain"] = int(np.argmax(np.where(chains == c, commits, -1)))
    picks += deep.values()
    return sorted(set(picks)), list(feats) + list(deep)


def adv_leaves(st):
    return {k: getattr(st, k).clone() for k in ("adv_sched", "adv_link", "adv_group", "adv_heal")}


def check_adv_unchanged(before, st, label):
    for k, v in before.items():
        if not torch.equal(v, getattr(st, k)):
            raise AssertionError(f"{label}: the run wrote {k}")
    print(f"   {label}: the adv_* leaves are unchanged by the run "
          f"({', '.join(f'{k} {list(v.shape)}' for k, v in before.items())})")


def safety_lines(label, specs, safe, cc):
    """Per commit chain: the slots, their safe fraction and commits; fails
    unless each chain committed somewhere (else its rule went untested)."""
    chains = np.asarray([s.commit_chain for s in specs])
    parts = []
    for c in (3, 2):
        on = chains == c
        if not (cc[on] > 0).any():
            raise AssertionError(f"{label}: no {c}-chain slot committed")
        parts.append(f"{c}-chain {safe[on].mean():.4f} ({int(on.sum())} slots, "
                     f"{int((cc[on] > 0).any(axis=1).sum())} committed, mean commits/node "
                     f"{cc[on].mean():.3f})")
    print(f"   device check_safety == check_safety_reference on all {len(specs)} slots "
          f"(per-slot honest masks); safe fraction: {', '.join(parts)}")


def serial_scenario_phase(p, b, clocks, sel, to_reference, serial_ms, checks):
    """Phase 13 (see the module docstring); returns the select launches and
    the ms per batch step."""
    from librabft_simulator_tpu_torch.parallel import mesh as M
    from librabft_simulator_tpu_torch.serve import scenario as sc
    from librabft_simulator_tpu_torch.sim import byzantine as B
    from librabft_simulator_tpu_torch.sim import simulator as S

    t0 = time.perf_counter()
    specs = fleet_specs(p, b, clocks, f_max=1, statics=True)
    honest = sc.honest_masks(p, specs)
    st0 = sc.init_specs(p, specs, device="cuda")
    torch.cuda.synchronize()
    print(f"   fleet: n={p.n_nodes} queue_cap={p.queue_cap} B={b} adv_windows={p.adv_windows}; "
          f"cut: per-slot max_clock in {clock_ranges(clocks)} (BASELINE 1000); "
          f"{sum(bool(s.attack['windows']) for s in specs)} slots with windows, "
          f"{sum('partition' in s.attack for s in specs)} partitions, "
          f"{sum('link_delay' in s.attack for s in specs)} link matrices, "
          f"{sum(s.byz_kind != 'honest' for s in specs)} static schedules, "
          f"{int((~honest).any(axis=1).sum())} slots with a Byzantine author; specs, rows "
          f"and init_specs on the card {time.perf_counter() - t0:.3f} s")
    before = adv_leaves(st0)
    flags = S.byz_flags(p, st0)
    prof0 = M.rows_of(st0, 0, b, "cuda")  # the profiles' fleet: a copy of the unrun one
    torch.cuda.reset_peak_memory_stats()
    # A halt read every 64 steps: the fleet runs as long as its busiest slot.
    st, wall, launches = counted_run(sel, lambda: S.run_to_completion(
        p, st0, chunk=64, max_chunks=1600, batched=True))
    steps = S.run_to_completion.last_steps
    fleet_line(st, wall, steps, "batch step")
    ev = st.n_events.cpu().numpy()
    print(f"   ms per batch step: planes on {wall / steps * 1e3:.3f}, config #2 planes off "
          f"{serial_ms:.3f} (phase 4); launches {launches} (batch steps {steps}); "
          f"byz_flags {flags}; events per slot: median {int(np.median(ev))}, max "
          f"{int(ev.max())} (slot {int(ev.argmax())}: {specs[int(ev.argmax())]})")
    if (not bool(st.halted.all()) or launches["select_events"]
            or launches["select_queue_events"] != steps):
        raise AssertionError(f"phase 13: launches={launches} steps={steps}")
    check_adv_unchanged(before, st, "phase 13")
    del st0
    safe = B.check_safety(st, honest)
    if not np.array_equal(safe, B.check_safety_reference(st, honest)):
        raise AssertionError("phase 13: device safety check != reference")
    cc = st.ctx.commit_count.cpu().numpy()
    safety_lines("phase 13", specs, safe, cc)

    t = time.perf_counter()
    picks, feats = coverage_picks(specs, ev, cc.sum(axis=1))
    if len(picks) < 6:
        raise AssertionError(f"phase 13: {len(picks)} picked slots, want at least 6")
    gpu = to_reference(S.select_instances(st, picks))
    del st
    checks.submit("phase 13 card vs CPU", gpu,
                  f"slots {picks} (horizons {[specs[i].max_clock for i in picks]}, events "
                  f"{ev[picks].tolist()}, commits {cc[picks].sum(axis=1).tolist()}; covering "
                  f"{', '.join(feats)})", cpu_specs, "serial", p, [specs[i] for i in picks], 32)
    for j, i in enumerate(picks):
        checks.submit(f"phase 13 slot {i} vs its dedicated static run (to_params + install), "
                      "every leaf but sc_*",
                      {k: v[j:j + 1] for k, v in gpu.items() if not k.startswith("sc_")},
                      f"slot {i}", cpu_dedicated, p, specs[i])
    print(f"   card vs CPU and dedicated static runs of slots {picks}: on the CPU worker "
          f"({time.perf_counter() - t:.3f} s)")
    dt, du = S.tables(p, "cuda")
    print(f"   profile, byz_flags {flags} (beside phase 6's, planes off):")
    st = profile_device(lambda x: S.step(p, dt, du, x, *flags), prof0, PROFILE_STEPS,
                        "batch step")
    print("   profile, the same fleet going on, byz_flags (False, False):")
    profile_device(lambda x: S.step(p, dt, du, x, False, False), st, PROFILE_STEPS,
                   "batch step", warm=1)
    return launches["select_queue_events"], wall / steps * 1e3


def lane_scenario_phase(p, b, clocks, sel, to_reference, window_ms, checks):
    """Phase 14 (see the module docstring); returns the select launches."""
    from librabft_simulator_tpu_torch.serve import scenario as sc
    from librabft_simulator_tpu_torch.sim import byzantine as B
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S

    t0 = time.perf_counter()
    specs = fleet_specs(p, b, clocks, f_max=5, statics=False)
    honest = sc.honest_masks(p, specs)
    st0 = sc.init_specs(p, specs, engine=P, device="cuda")
    d_min = st0.sc_delay.amin(dim=1).clamp(min=1)
    print(f"   fleet: n={p.n_nodes} inbox={P.inbox_cap(p)} lanes={P.lanes_of(p)} "
          f"drain={P.drain_of(p)} B={b} telemetry={p.telemetry}; cut: per-slot max_clock in "
          f"{clock_ranges(clocks)} (BASELINE 1000); per-slot d_min in "
          f"{sorted(set(d_min.tolist()))}; {sum('partition' in s.attack for s in specs)} "
          f"partitions, {sum('link_delay' in s.attack for s in specs)} link matrices, "
          f"{int((~honest).any(axis=1).sum())} slots with Byzantine windows (at most "
          f"{int((~honest).sum(axis=1).max())} authors); init {time.perf_counter() - t0:.3f} s")
    before = adv_leaves(st0)
    flags = S.byz_flags(p, st0)
    torch.cuda.reset_peak_memory_stats()
    st, wall, launches = counted_run(sel, lambda: P.run_to_completion(p, st0, batched=True))
    windows = P.run_to_completion.last_steps
    fleet_line(st, wall, windows, "window")
    k = P.drain_of(p)
    print(f"   ms per window: planes on {wall / windows * 1e3:.3f}, config #5 planes off "
          f"{window_ms:.3f} (phase 9); launches {launches} (windows {windows} x drain {k} = "
          f"{windows * k})")
    if (not bool(st.halted.all()) or launches["select_events"]
            or launches["select_queue_events"] != k * windows):
        raise AssertionError(f"phase 14: launches {launches}, windows {windows}")
    del st0
    plane_checks(p, st, "phase 14")
    check_adv_unchanged(before, st, "phase 14")
    safe = B.check_safety(st, honest)
    if not np.array_equal(safe, B.check_safety_reference(st, honest)):
        raise AssertionError("phase 14: device safety check != reference")
    cc = st.ctx.commit_count.cpu().numpy()
    safety_lines("phase 14", specs, safe, cc)
    ev = st.n_events.cpu().numpy()
    chains = np.asarray([s.commit_chain for s in specs])
    # The slots with the most commits on each chain, and the busiest slot.
    picks = [int(np.argmax(np.where(chains == c, cc.sum(axis=1), -1))) for c in (3, 2)]
    picks = sorted({*picks, int(ev.argmax())} | ({b - 1} if int(ev.argmax()) in picks else set()))
    checks.submit("phase 14 card vs CPU", to_reference(S.select_instances(st, picks)),
                  f"slots {picks} (chains {chains[picks].tolist()}, events "
                  f"{ev[picks].tolist()}, commits {cc[picks].sum(axis=1).tolist()})",
                  cpu_specs, "lanes", p, [specs[i] for i in picks], None)
    del st
    dt, du = S.tables(p, "cuda")
    # A fresh fleet, not a copy kept through the run: its payload inboxes
    # alone take ~35 GB.
    print(f"   profile, this fleet, byz_flags {flags}:")
    profile_device(lambda x: P.step(p, dt, du, P.d_min_of(p), x, *flags),
                   sc.init_specs(p, specs, engine=P, device="cuda"), PROFILE_WINDOWS,
                   "window", warm=2)
    return launches["select_queue_events"]


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
          f"{p4.delay_kind} queue_cap={p4.queue_cap} B={n4}, f in (0, 1), equivocate, a halt "
          f"read every {SWEEP_CHUNK} steps")
    finals = []
    run = S.run_to_completion

    def recording(*a, **kw):  # keep each f's final state for the checks below
        st = run(*a, **kw)
        finals.append((st, S.run_to_completion.last_steps))
        return st

    S.run_to_completion = recording
    try:
        res, wall, launches = counted_run(sel, lambda: B.f_sweep(p4, n4, f_values=[0, 1],
                                                                 chunk=SWEEP_CHUNK))
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


def lane_phase(name, p, b, sel, P, to_reference, profile, checks, stream=None, pause=False):
    """One lane config at full width: run (through ``stream`` if given; with
    the CPU workers stopped if ``pause``), check launches (and, with the
    planes on, their invariants), compare a few instances with the CPU,
    optionally profile; returns the select launches and the ms per
    window."""
    from librabft_simulator_tpu_torch.sim import simulator as S

    print(f"   {name}: n={p.n_nodes} {p.delay_kind} drop={p.drop_prob} "
          f"commit_chain={p.commit_chain} inbox={P.inbox_cap(p)} lanes={P.lanes_of(p)} "
          f"drain={P.drain_of(p)} B={b} telemetry={p.telemetry} watchdog={p.watchdog}; "
          f"cut: max_clock {FULL_CLOCK} -> {p.max_clock}")
    seeds = np.arange(b, dtype=np.uint32)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    st, wall, launches = counted_run(sel, lambda: P.run_to_completion(
        p, P.init_batch(p, seeds, device="cuda"), batched=True, stream=stream), pause=pause)
    windows = P.run_to_completion.last_steps
    fleet_line(st, wall, windows, "window")
    print(f"   allocated before the run: {base / 1e9:.3f} GB")
    k = P.drain_of(p)
    print(f"   launches {launches} (windows {windows} x drain {k} = {windows * k})")
    if (not bool(st.halted.all()) or launches["select_events"]
            or launches["select_queue_events"] != k * windows):
        raise AssertionError(f"{name}: launches {launches}, windows {windows}")
    if not int(st.n_events.sum()) > 0:
        raise AssertionError(f"{name}: no events")
    if p.telemetry:
        plane_checks(p, st, name)
    if name in ("config #3", "config #5"):
        require_paths(p, st, name)

    rng = np.random.default_rng(1)
    picks = sorted({0, b - 1, *rng.choice(np.arange(1, b - 1), LANE_PICKS - 2,
                                          replace=False).tolist()})
    checks.submit(f"{name} card vs CPU" + (", planes on" if p.telemetry else ""),
                  to_reference(S.select_instances(st, picks)), f"instances {picks}",
                  cpu_fleet, "lanes", p, seeds[picks])
    del st
    if profile:
        dt, du = S.tables(p, "cuda")
        profile_device(lambda x: P.step(p, dt, du, P.d_min_of(p), x, False, False),
                       P.init_batch(p, seeds, device="cuda"), PROFILE_WINDOWS, "window",
                       warm=1)
    return launches["select_queue_events"], wall / windows * 1e3


def require_paths(p, st, label):
    """Config #3 forms rounds past the first at n=64 (a vote quorum);
    config #5 drives the lane engine's 2-chain commit rule and its inbox
    overflow, and with the watchdog on its stall and queue-saturation
    detectors: fail if the run left any of them at 0 (a horizon too short
    for them)."""
    if label == "config #3":
        got = {"rounds": int((st.store.current_round.max(dim=1).values - 1).sum())}
    else:
        got = {"commits": int(st.ctx.commit_count.sum()),
               "inbox-full": int(st.n_inbox_full.sum())}
    if p.watchdog:
        from librabft_simulator_tpu_torch.telemetry import stream
        tot = dict(zip(stream.WD_SLOTS, st.wd.sum(dim=0).tolist()))
        got.update({"watchdog stall": tot["stall"], "watchdog queue_sat": tot["queue_sat"]})
    zero = [k for k, v in got.items() if v <= 0]
    if zero:
        raise AssertionError(f"{label}: {', '.join(zero)} at 0 by max_clock {p.max_clock}: "
                             f"the run did not drive these paths ({got})")
    print(f"   {label}: paths driven: {json.dumps(got)}")


def planes_turns(step, p, st, warm, seg, unit):
    """ms per call with both planes off and on, in turns (off, on, on, off)
    over consecutive segments of ``seg`` calls of one run, after ``warm``
    calls: a comparison that the host's drift over the script does not
    bias.  ``step(params, st)`` makes one call; the planes' leaves ride
    along untouched while they are off.  Returns the state."""
    p_off = dataclasses.replace(p, telemetry=False, watchdog=False)
    with torch.no_grad():
        for _ in range(warm):
            st = step(p_off, st)
        times = {"off": [], "on": []}
        for which in ("off", "on", "on", "off"):
            pw = p_off if which == "off" else p
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(seg):
                st = step(pw, st)
            torch.cuda.synchronize()
            times[which].append((time.perf_counter() - t0) / seg * 1e3)
    off, on = np.mean(times["off"]), np.mean(times["on"])
    print(f"   in turns (off, on, on, off), {seg} {unit}s each after {warm}: off "
          f"{times['off'][0]:.3f}, on {times['on'][0]:.3f}, on {times['on'][1]:.3f}, off "
          f"{times['off'][1]:.3f} ms/{unit}; mean on/off {on / off:.4f}")
    return st


def plane_checks(p, st, label):
    """The metrics plane's counter invariants on every instance: its event
    counts (and flight count) sum to n_events, its drops and overflow equal
    the state's.  Prints the merged telemetry block and the watchdog's
    trip totals."""
    from librabft_simulator_tpu_torch.telemetry import plane, report, stream

    def col(name):
        return st.metrics[:, plane.slot(p, name)[0]]

    full = st.n_queue_full if hasattr(st, "n_queue_full") else st.n_inbox_full
    ev = col("ev_notify") + col("ev_request") + col("ev_response") + col("ev_timer")
    for got, want, what in ((ev, st.n_events, "event counts"),
                            (col("fr_count"), st.n_events, "fr_count"),
                            (col("drops"), st.n_msgs_dropped, "drops"),
                            (col("overflow"), full, "overflow")):
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{label}: plane {what} != state on {bad} instances")
    print(f"   {label}: on all {st.clock.shape[0]} instances the plane's event counts "
          f"and fr_count sum to n_events, its drops and overflow equal the state's")
    print(f"   telemetry block: {json.dumps(report.telemetry_block(p, st))}")
    if p.watchdog:
        tot = st.wd.sum(dim=0).tolist()
        print(f"   watchdog totals: {dict(zip(stream.WD_SLOTS[1:], tot[1:]))}")


def doctored_fleet(S, p, seeds, device, row):
    """init_batch with a conflicting committed entry planted on instance
    ``row``'s node 1, as tests/test_stream.py's doctor_ctx plants it (depth
    1, a tag no honest chain produces, round 999): that node's next commit
    trips round_regress and the other nodes' first commit safety_conflict."""
    st = S.init_batch(p, seeds, device=device)
    cx = st.ctx

    def planted(x, idx, v):
        x = x.clone()
        x[idx] = v
        return x

    return st.replace(ctx=cx.replace(
        commit_count=planted(cx.commit_count, (row, 1), 1),
        log_depth=planted(cx.log_depth, (row, 1, 0), 1),
        log_tag=planted(cx.log_tag, (row, 1, 0), int(np.uint32(0xDEADBEEF).view(np.int32))),
        log_round=planted(cx.log_round, (row, 1, 0), 999)))


def serial_planes_phase(p, b, sel, to_reference, serial_ms, tmp, checks):
    """Config #2 with both planes on through run_to_completion(stream=):
    checks and prints as the module docstring says (phase 10); returns the
    select launches and the final state's leaves."""
    from librabft_simulator_tpu_torch.core.types import tree_map
    from librabft_simulator_tpu_torch.sim import simulator as S
    from librabft_simulator_tpu_torch.telemetry import stream

    print(f"   config #2 as phase 4, telemetry=True flight_cap={p.flight_cap}, watchdog=True "
          f"watchdog_stall_events={p.watchdog_stall_events}; cut: max_clock {FULL_CLOCK} "
          f"-> {p.max_clock}; instance {DOCTOR_I} carries a planted conflicting commit")
    from librabft_simulator_tpu_torch.sim import checkpoint as ckpt

    seeds = np.arange(b, dtype=np.uint32)
    path = os.path.join(tmp, "config2.npz")
    # Two calls with one recorder: the first CKPT_CHUNKS chunks, then the
    # rest.  Between them the state is saved for phases 12 and 15 (outside
    # the timed calls); the second call continues the same state in memory.
    # The CPU workers are stopped during both.
    with stream.TimelineRecorder(p, total_instances=b,
                                 out=os.path.join(tmp, "config2.ndjson")) as rec:
        mid, wall1, launches1 = counted_run(sel, lambda: S.run_to_completion(
            p, doctored_fleet(S, p, seeds, "cuda", DOCTOR_I), chunk=SERIAL_CHUNK,
            batched=True, stream=rec, max_chunks=CKPT_CHUNKS), pause=True)
        steps1 = S.run_to_completion.last_steps
        t0 = time.perf_counter()
        ckpt.save(path, mid)
        save_s = time.perf_counter() - t0
        mid_ref = to_reference(mid)
        st, wall2, launches2 = counted_run(sel, lambda: S.run_to_completion(
            p, mid, chunk=SERIAL_CHUNK, batched=True, stream=rec), pause=True)
    del mid
    steps, wall = steps1 + S.run_to_completion.last_steps, wall1 + wall2
    launches = {k: launches1[k] + launches2[k] for k in launches1}
    fleet_line(st, wall, steps, "batch step")
    print(f"   ms per batch step: planes on {wall / steps * 1e3:.3f}, off {serial_ms:.3f} "
          f"(phase 4); launches {launches} (batch steps {steps}); stream: "
          f"{len(rec.rows)} chunks of {SERIAL_CHUNK} steps, one [13] digest fetch each; "
          f"saved after step {steps1} for phases 12 and 15 in {save_s:.3f} s "
          f"({os.path.getsize(path) / 1e6:.1f} MB .npz)")
    if (not bool(st.halted.all()) or launches["select_events"]
            or launches["select_queue_events"] != steps):
        raise AssertionError(f"config #2 planes on: launches={launches} steps={steps}")
    plane_checks(p, st, "config #2")
    final = stream.decode_digest(stream.compute_digest(p, tree_map(lambda x: x.cpu(), st)))
    last = {k: rec.rows[-1][k] for k in final}
    print(f"   final digest (card, last stream row): {json.dumps(last)}")
    if last != final:
        raise AssertionError(f"card digest {last} != compute_digest of the CPU copy {final}")
    print("   the card's final digest equals compute_digest of the state's CPU copy")
    wd = st.wd.cpu().numpy()
    for slot in (stream.WD_SAFETY_CONFLICT, stream.WD_ROUND_REGRESS):
        tripped = np.flatnonzero(wd[:, slot]).tolist()
        if tripped != [DOCTOR_I]:
            raise AssertionError(f"{stream.WD_SLOTS[slot]} tripped on {tripped[:8]}, "
                                 f"want [{DOCTOR_I}]")
    print(f"   planted conflict on instance {DOCTOR_I}: safety_conflict "
          f"{int(wd[DOCTOR_I, stream.WD_SAFETY_CONFLICT])}, round_regress "
          f"{int(wd[DOCTOR_I, stream.WD_ROUND_REGRESS])}, on no other instance")
    final_ref = to_reference(st)

    rng = np.random.default_rng(2)
    picks = sorted({0, DOCTOR_I, b - 1, int(rng.integers(4, b - 1))})
    checks.submit("config #2 planes on, card vs CPU", to_reference(S.select_instances(st, picks)),
                  f"instances {picks} (the planes included)", cpu_fleet, "serial", p,
                  seeds[picks], picks.index(DOCTOR_I))
    del st
    dt, du = S.tables(p, "cuda")
    profile_device(lambda x: S.step(p, dt, du, x, False, False),
                   S.init_batch(p, seeds, device="cuda"), PROFILE_STEPS, "batch step")
    planes_turns(lambda pw, x: S.step(pw, dt, du, x, False, False), p,
                 S.init_batch(p, seeds, device="cuda"), 8, 4, "batch step")
    return (launches["select_queue_events"], final_ref, mid_ref, steps1, path, rec.rows,
            wall / steps * 1e3)


def checkpoint_phase(p, to_reference, mid_ref, path):
    """Phase 12: phase 10's checkpoint (its fleet after CKPT_CHUNKS chunks),
    loaded on the card and on the CPU, must equal the state it was saved
    from in every leaf.  Phase 15 resumes it (through load_sharded) and holds
    the result to phase 10's uninterrupted run."""
    from librabft_simulator_tpu_torch.sim import checkpoint as ckpt

    t0 = time.perf_counter()
    back = ckpt.load(path, p, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    leaves_equal(mid_ref, to_reference(back), "card checkpoint loaded on the card")
    print(f"   load on the card {load_s:.3f} s ({os.path.getsize(path) / 1e6:.1f} MB .npz): "
          f"equals the state it was saved from in every leaf ({len(mid_ref)}); phase 15 "
          "resumes it")
    del back
    leaves_equal(mid_ref, to_reference(ckpt.load(path, p, device="cpu")),
                 "card checkpoint loaded on the CPU")
    print("   the card's checkpoint loaded on the CPU equals the state it was saved from")


def ring_checks(ring, lg, label):
    """The device wrap's host reads from the ledger: fewer ring fetches than
    retired chunks, and fewer waits on the device (ring fetches and halt
    reads whose copy had not landed) than retired chunks; prints them, the
    halt reads (one per chunk after an outer call's first) and the seconds
    of each kind of poll span."""
    print(f"   ledger ring_stats: {json.dumps(ring)}")
    for kind in ("poll", "halt_poll"):
        durs = [sp.dur_s for sp in lg.spans
                if sp.kind == kind and ring and sp.attrs.get("run") == ring["run"]]
        print(f"   {kind} spans of this run: {len(durs)}, {sum(durs):.6f} s in all")
    if (ring is None or not ring["polls_per_retired_chunk"] < 1
            or not ring["waits_per_retired_chunk"] < 1):
        raise AssertionError(f"{label}: ring_stats {ring}")


def sharded_phase(args, p10, p5, b, sel, to_reference, final_ref, rows10, path, mid_steps,
                  planes_ms, window_ms, peak9, tmp, checks):
    """Phase 15 (see the module docstring); returns the select launches of
    both paths."""
    from librabft_simulator_tpu_torch.parallel import mesh as M
    from librabft_simulator_tpu_torch.parallel import sharded as SH
    from librabft_simulator_tpu_torch.sim import checkpoint as ckpt
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S
    from librabft_simulator_tpu_torch.telemetry import ledger, stream

    lg = ledger.get()
    card = torch.device("cuda", 0)
    out = {}

    # Serial: phase 12's checkpoint on a 3-shard mesh, device wrap, macro-steps.
    ps = dataclasses.replace(p10, wrap="device", ring_k=RING_K, macro_k=MACRO_K)
    chunk = RING_CHUNK
    mesh = M.make_mesh(SHARDS, 1, devices=[card] * SHARDS)
    t0 = time.perf_counter()
    st0, n_valid = ckpt.load_sharded(path, ps, mesh)
    torch.cuda.synchronize()
    total = SH.batch_size(st0)
    print(f"   serial: config #2 with both planes (phase 10) from its step {mid_steps}, "
          f"wrap=device ring_k={RING_K} macro_k={MACRO_K} chunk={chunk} macro-steps "
          f"({chunk * MACRO_K} events); load_sharded onto {SHARDS} shards of one card: "
          f"{n_valid} instances padded to {total}, {time.perf_counter() - t0:.3f} s")
    if n_valid != b or total % SHARDS or total - b >= SHARDS:
        raise AssertionError(f"phase 15: load_sharded gave {total} rows, {n_valid} valid")
    rec = stream.TimelineRecorder(ps, out=os.path.join(tmp, "sharded.ndjson"))
    with rec:
        st, wall, launches = counted_run(sel, lambda: SH.run_sharded(
            ps, mesh, st0, num_steps=chunk * S.RUN_MAX_CHUNKS, chunk=chunk, stream=rec),
            pause=True)
    del st0
    ring = lg.ring_stats()
    pipe = lg.pipeline_stats()
    ev_steps = SH.run_sharded.last_steps
    print(f"   {SH.run_sharded.last_chunks} chunks, {ev_steps} event steps per shard, wall "
          f"{wall:.3f} s: {wall / ev_steps * 1e3:.3f} ms per event step of the fleet "
          f"({wall / ev_steps / SHARDS * 1e3:.3f} per shard), phase 10's one-shard step "
          f"{planes_ms:.3f}; launches {launches} (event steps {ev_steps} x {SHARDS} shards)")
    print(f"   ledger pipeline_stats: {json.dumps({k: v for k, v in pipe.items() if k != 'rows'})}")
    if (launches["select_events"] or launches["select_queue_events"] != ev_steps * SHARDS):
        raise AssertionError(f"phase 15 serial: launches {launches}, event steps {ev_steps}")
    ring_checks(ring, lg, "phase 15 serial")
    host = SH.unpad(st, n_valid)
    del st
    leaves_equal(final_ref, to_reference(host), "phase 15 serial vs phase 10")
    print(f"   the {n_valid} real instances equal phase 10's final state in every leaf "
          f"({len(final_ref)} leaves)")
    del host
    # Ring row r ends event step mid_steps + 16 (r + 1): every fourth one
    # ends one of phase 10's 64-step chunks, its row (mid_steps + 16 (r + 1))
    # / 64 - 1.
    names = [name for name, _ in stream.DIGEST_SLOTS] + ["watchdog_flags"]
    pads = [stream.pad_digest()] * (total - n_valid)
    per = SERIAL_CHUNK // (chunk * MACRO_K)
    pairs = [(r, (mid_steps + (r + 1) * chunk * MACRO_K) // SERIAL_CHUNK - 1)
             for r in range(per - 1, len(rec.rows), per)]
    pairs.append((len(rec.rows) - 1, len(rows10) - 1))
    for r, j in pairs:
        want = stream.fold_digests([rows10[j]] + pads)
        got = {k: rec.rows[r][k] for k in names}
        if got != {k: want[k] for k in names}:
            raise AssertionError(f"phase 15 ring row {r} != phase 10 row {j} with padding: "
                                 f"{got} vs {want}")
    print(f"   ring rows {[r for r, _ in pairs]} equal phase 10's stream rows "
          f"{[j for _, j in pairs]} folded with {len(pads)} padding digests; last: "
          f"{json.dumps({k: rec.rows[-1][k] for k in names})}")
    print(f"   ledger compile entries: {json.dumps(lg.compiles)}")
    out[f"config #2 sharded, {SHARDS} shards, device wrap"] = launches["select_queue_events"]

    # Lanes: config #5's shapes on one shard (the card holds the state once).
    p15 = dataclasses.replace(p5, max_clock=args.ring5_clock, wrap="device", ring_k=RING_K)
    mesh1 = M.make_mesh(1, 1, devices=[card])
    seeds = np.arange(10000, dtype=np.uint32)
    print(f"   lanes: config #5 (n=16, inbox 256, 8 lanes, drain 4, B=10000), wrap=device "
          f"ring_k={RING_K} chunk={P.RUN_CHUNK} windows; cut: max_clock {FULL_CLOCK} -> "
          f"{p15.max_clock}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rec5 = stream.TimelineRecorder(p15)
    st, wall, launches = counted_run(sel, lambda: SH.run_sharded(
        p15, mesh1, P.init_batch(p15, seeds, device="cuda"),
        num_steps=P.RUN_CHUNK * P.RUN_MAX_CHUNKS, chunk=P.RUN_CHUNK, engine=P, stream=rec5),
        pause=True)
    peak = torch.cuda.max_memory_allocated()
    fleet = st.shards[0]
    windows = SH.run_sharded.last_steps
    k = P.drain_of(p15)
    ring = lg.ring_stats()
    fleet_line(fleet, wall, windows, "window")
    print(f"   ms per window {wall / windows * 1e3:.3f}, phase 9's {window_ms:.3f}; launches "
          f"{launches} (windows {windows} x drain {k} = {windows * k}); peak {peak / 1e9:.3f} GB "
          f"({base / 1e9:.3f} GB allocated before the run), phase 9's {peak9 / 1e9:.3f} GB")
    if (not bool(fleet.halted.all()) or launches["select_events"]
            or launches["select_queue_events"] != k * windows):
        raise AssertionError(f"phase 15 lanes: launches {launches}, windows {windows}")
    ring_checks(ring, lg, "phase 15 lanes")
    if peak > peak9 + 1e9:
        raise AssertionError(f"phase 15 lanes: peak {peak} B > phase 9's {peak9} B + 1 GB")
    last = {k_: rec5.rows[-1][k_] for k_ in names}
    want = stream.decode_digest(stream.compute_digest(p15, fleet).cpu().numpy())
    if last != want:
        raise AssertionError(f"phase 15 lanes: last ring row {last} != digest {want}")
    print("   the last ring row equals compute_digest of the final state")
    rng = np.random.default_rng(3)
    picks = sorted({0, 9999, int(rng.integers(1, 9999))})
    checks.submit("phase 15 lanes card vs CPU", to_reference(S.select_instances(fleet, picks)),
                  f"instances {picks}", cpu_fleet, "lanes", p15, seeds[picks])
    del st, fleet
    out["config #5 lanes sharded, device wrap"] = launches["select_queue_events"]
    return out



def serve_fields(p, st, honest):
    """The result fields phase 16 compares, per instance of a fleet state:
    events, clock, commits, the committed round, messages sent and dropped,
    safety under each instance's honest mask (the device check, held to its
    reference) and the watchdog trips."""
    from librabft_simulator_tpu_torch.sim import byzantine as B
    from librabft_simulator_tpu_torch.telemetry import stream

    safe = B.check_safety(st, honest)
    if not np.array_equal(safe, B.check_safety_reference(st, honest)):
        raise AssertionError("device safety check != reference")
    wd = st.wd.cpu().numpy().astype(np.int64)
    b = st.clock.shape[0]
    return {"events": st.n_events.cpu().numpy().astype(np.int64),
            "clock": st.clock.cpu().numpy().astype(np.int64),
            "commits": st.ctx.commit_count.cpu().numpy().astype(np.int64),
            "committed_round_max": st.store.hcr.reshape(b, -1).amax(dim=1).cpu().numpy()
            .astype(np.int64),
            "msgs_sent": st.n_msgs_sent.cpu().numpy().astype(np.int64),
            "msgs_dropped": st.n_msgs_dropped.cpu().numpy().astype(np.int64),
            "safe": safe.astype(bool),
            "watchdog": wd[:, [stream.WD_SLOTS.index(n) for n in stream.WD_DETECTORS]]}


def result_fields(results, ids):
    """The same fields from the service's result dicts, in ``ids`` order."""
    from librabft_simulator_tpu_torch.telemetry import stream

    rs = [results[i] for i in ids]
    out = {k: np.asarray([r[k] for r in rs], np.int64)
           for k in ("events", "clock", "commits", "committed_round_max", "msgs_sent",
                     "msgs_dropped")}
    out["safe"] = np.asarray([r["safe"] for r in rs], bool)
    out["watchdog"] = np.asarray([[r["watchdog"][n] for n in stream.WD_DETECTORS]
                                  for r in rs], np.int64)
    return out


def cpu_serve_fields(p, specs):
    """A CPU reference run (in the worker) of phase 16's picked requests, as
    one static fleet: their result fields."""
    from librabft_simulator_tpu_torch.serve import scenario as sc
    from librabft_simulator_tpu_torch.sim import simulator as S

    st = S.run_to_completion(p, sc.init_specs(p, specs, device="cpu"), chunk=32)
    return serve_fields(p, st, sc.honest_masks(p, specs))


def request_rows(paths):
    """The ``kind="request"`` rows of the service's stream files."""
    from librabft_simulator_tpu_torch.telemetry import stream

    return [r for path in paths for r in stream.read_ndjson(path) if r.get("kind") == "request"]


def span_line(lg, runs, kind):
    durs = [sp.dur_s for sp in lg.spans if sp.kind == kind and sp.attrs.get("run") in runs]
    mean = sum(durs) / len(durs) if durs else 0.0
    return durs, f"{len(durs)} {kind} spans, {sum(durs):.3f} s in all, {mean:.4f} s each"


def serve_phase(args, p, sel, serial_ms, ms13, checks, tmp):
    """Phase 16 (see the module docstring); returns the select launches of
    the serve path and of its static reference run."""
    from librabft_simulator_tpu_torch.serve import FleetService, service
    from librabft_simulator_tpu_torch.serve import scenario as sc
    from librabft_simulator_tpu_torch.sim import simulator as S
    from librabft_simulator_tpu_torch.telemetry import ledger

    lg = ledger.get()
    clocks = {2: tuple(args.serve_clock), 3: tuple(args.serve_clock3)}
    t0 = time.perf_counter()
    specs = fleet_specs(p, SERVE_REQUESTS, clocks, f_max=1, statics=True)
    path = os.path.join(tmp, "requests.ndjson")
    with open(path, "w") as f:
        for i, spec in enumerate(specs):
            f.write(json.dumps(dict(spec.to_dict(), id=f"q{i}")) + "\n")
            f.flush()
    print(f"   {SERVE_REQUESTS} requests from phase 13's generator for {SERVE_SLOTS} slots "
          f"(n={p.n_nodes} queue_cap={p.queue_cap} adv_windows={p.adv_windows} "
          f"watchdog={p.watchdog} telemetry={p.telemetry}), chunk {SERVE_CHUNK}; cut: "
          f"per-request max_clock in {clock_ranges(clocks)} (BASELINE 1000); specs and "
          f"NDJSON ({os.path.getsize(path) / 1e6:.1f} MB) {time.perf_counter() - t0:.3f} s")
    streams = [os.path.join(tmp, f"serve{i}.ndjson") for i in (1, 2)]
    ckpt = os.path.join(tmp, "serve.npz")
    reads = {}
    real_read = service._host_read

    def counted(kind, fn, *a):
        reads[kind] = reads.get(kind, 0) + 1
        return real_read(kind, fn, *a)

    legs = {}

    def run():
        t = time.perf_counter()
        svc = FleetService(p, slots=SERVE_SLOTS, chunk=SERVE_CHUNK, device="cuda",
                           out=streams[0])
        ids = svc.submit_file(path)
        legs["submit_s"] = time.perf_counter() - t
        fleet = svc.fleet
        t = time.perf_counter()
        # Until a wave has landed in freed slots, and every admitted request
        # has run a polled chunk (its first_chunk row precedes the preemption).
        svc.serve(max_chunks=3)
        while (len(span_line(lg, [fleet._rid], ledger.ADMIT)[0]) < 2 or fleet.pending_count
               or any(r.first_chunk_t is None for r in fleet._active.values())):
            if fleet.chunks_polled >= SERVE_MAX_CHUNKS:
                raise AssertionError(f"phase 16: no admission wave in {SERVE_MAX_CHUNKS} chunks")
            svc.serve(max_chunks=1)
        torch.cuda.synchronize()
        legs["serve1_s"] = time.perf_counter() - t
        legs["active"] = sorted(int(r.request_id[1:]) for r in fleet._active.values())
        t = time.perf_counter()
        svc.preempt(ckpt)
        svc.close()
        legs["preempt_s"] = time.perf_counter() - t
        legs["reads1"] = dict(reads)   # the preemption's read of the fleet included
        t = time.perf_counter()
        ring_p = dataclasses.replace(p, wrap="device", ring_k=SERVE_RING_K)
        svc2 = FleetService.resume(ckpt, ring_p, device="cuda", out=streams[1])
        legs["resume_s"] = time.perf_counter() - t
        t = time.perf_counter()
        results = svc2.drain()
        torch.cuda.synchronize()
        legs["drain_s"] = time.perf_counter() - t
        svc2.close()
        legs.update(fleets=(fleet, svc2.fleet), ids=ids)
        return results

    torch.cuda.reset_peak_memory_stats()
    service._host_read = counted
    try:
        results, wall, launches = counted_run(sel, run, pause=True)
    finally:
        service._host_read = real_read
    peak = torch.cuda.max_memory_allocated()
    f1, f2 = legs["fleets"]
    ids = legs["ids"]
    steps = f1.steps_dispatched + f2.steps_dispatched
    serve_s = legs["serve1_s"] + legs["drain_s"]
    chunks1, chunks2 = f1.chunks_polled, f2.chunks_polled - f1.chunks_polled
    waves, wave_line = span_line(lg, [f1._rid, f2._rid], ledger.ADMIT)
    egress, egress_line = span_line(lg, [f1._rid, f2._rid], ledger.EGRESS)
    rows = request_rows(streams)
    ttfc = np.asarray([r["ttfc_s"] for r in rows if r["event"] == "first_chunk"])
    print(f"   pumps: host wrap {chunks1} chunks ({legs['serve1_s']:.3f} s), preempted with "
          f"{len(legs['active'])} active and {len(f1.results)} egressed, checkpoint "
          f"{legs['preempt_s']:.3f} s ({os.path.getsize(ckpt) / 1e6:.1f} MB), resumed in "
          f"{legs['resume_s']:.3f} s, ring (ring_k {SERVE_RING_K}) {chunks2} chunks "
          f"({legs['drain_s']:.3f} s); submit_file {legs['submit_s']:.3f} s")
    print(f"   {steps} event steps on 1 shard in {serve_s:.3f} s of pumping: "
          f"{serve_s / steps * 1e3:.3f} ms per event step, phase 13's {ms13:.3f}, phase 4's "
          f"{serial_ms:.3f}; launches {launches} (event steps {steps} x 1 shard)")
    print(f"   admission: {wave_line} (requests per wave "
          f"{[sp.attrs['requests'] for sp in lg.spans if sp.kind == ledger.ADMIT and sp.attrs.get('run') in (f1._rid, f2._rid)]}); "
          f"egress: {egress_line}")
    print(f"   {SERVE_REQUESTS} requests in {wall:.3f} s (submit to drained, the preemption "
          f"included): {SERVE_REQUESTS / wall:.1f} requests/s; ttfc p50 "
          f"{np.percentile(ttfc, 50):.6f} s, p99 {np.percentile(ttfc, 99):.6f} s over "
          f"{len(ttfc)} first chunks; peak memory {peak / 1e9:.3f} GB")
    if launches["select_events"] or launches["select_queue_events"] != steps:
        raise AssertionError(f"phase 16: launches {launches}, event steps {steps} x 1 shard")
    # Every id egressed once, with its whole lifecycle on the stream.
    if sorted(results) != sorted(ids) or len(ids) != SERVE_REQUESTS:
        raise AssertionError(f"phase 16: {len(results)} results for {len(ids)} requests")
    seen = {}
    for r in rows:
        seen.setdefault(r["id"], []).append(r["event"])
    want_events = ["submitted", "admitted", "first_chunk", "egressed"]
    bad = [i for i in ids if sorted(seen.get(i, []), key=want_events.index) != want_events]
    if bad:
        raise AssertionError(f"phase 16: {len(bad)} ids lack a lifecycle row, first "
                             f"{bad[:3]}: {[seen.get(i) for i in bad[:3]]}")
    print(f"   every id egressed once; the streams hold {len(rows)} request rows: "
          f"{', '.join(want_events)} for each of the {len(ids)} ids")
    # The host's reads of device data, through the service's one seam.
    r1 = legs["reads1"]
    r2 = {k: v - r1.get(k, 0) for k, v in reads.items()}
    egress1 = len(span_line(lg, [f1._rid], ledger.EGRESS)[0])
    print(f"   host reads, host wrap and preemption: {json.dumps(r1)} over {chunks1} polled "
          f"chunks and {egress1} egress boundaries; ring: {json.dumps(r2)} over {chunks2} "
          "retired chunks")
    if (r1.get("digest") != chunks1 or r1.get("ring") or r1.get("halted", 0) > egress1
            or r1.get("rows") != r1.get("halted") or r1.get("state") != 1):
        raise AssertionError(f"phase 16 host wrap: reads {r1}, chunks {chunks1}, "
                             f"egress boundaries {egress1}")
    ring = lg.ring_stats(run=f2._rid)
    if r2.get("digest") or r2.get("state") or not ring or r2.get("ring") != ring["dispatches"]:
        raise AssertionError(f"phase 16 ring: reads {r2}, ring_stats {ring}")
    ring_checks(ring, lg, "phase 16 ring leg")

    # One static fleet run of every spec, the reference of every result.
    honest = sc.honest_masks(p, specs)
    st, wall_s, launches_s = counted_run(sel, lambda: S.run_to_completion(
        p, sc.init_specs(p, specs, device="cuda"), chunk=64, max_chunks=1600, batched=True))
    steps_s = S.run_to_completion.last_steps
    print(f"   static reference: init_specs + run_to_completion of all {SERVE_REQUESTS} specs, "
          f"{steps_s} batch steps in {wall_s:.3f} s ({wall_s / steps_s * 1e3:.3f} ms per "
          f"step), launches {launches_s}")
    if (not bool(st.halted.all()) or launches_s["select_events"]
            or launches_s["select_queue_events"] != steps_s):
        raise AssertionError(f"phase 16 static run: launches {launches_s}, steps {steps_s}")
    want = serve_fields(p, st, honest)
    del st
    got = result_fields(results, ids)
    for k in want:
        if not np.array_equal(got[k], want[k]):
            bad = np.flatnonzero((got[k] != want[k]).reshape(len(ids), -1).any(axis=1))
            raise AssertionError(f"phase 16: {k} of {len(bad)} results != the static run, "
                                 f"first {bad[:5].tolist()}")
    print(f"   all {len(ids)} results equal their rows of the static run: "
          f"{', '.join(want)}")
    safety_lines("phase 16", specs, want["safe"], want["commits"])
    # Picked requests against a CPU run.
    chains = np.asarray([s.commit_chain for s in specs])
    total = want["commits"].sum(axis=1)
    ev = want["events"]
    attacked = [i for i, s in enumerate(specs) if s.attack["windows"]]
    picks = {f"committed {c}-chain": int(np.argmax(np.where(chains == c, total, -1)))
             for c in (3, 2)}
    picks["attacked"] = max(attacked, key=lambda i: ev[i])
    picks["second wave"] = SERVE_SLOTS + int(np.argmax(ev[SERVE_SLOTS:]))
    picks["active at the preemption"] = max(legs["active"], key=lambda i: ev[i])
    order = sorted(set(picks.values()))
    checks.submit("phase 16 served results vs CPU", result_fields(results, [ids[i] for i in order]),
                  f"requests {order} ({', '.join(f'{k} {v}' for k, v in picks.items())}), "
                  f"events {ev[order].tolist()}", cpu_serve_fields, p, [specs[i] for i in order])
    return {"serve": launches["select_queue_events"],
            "serve's static reference": launches_s["select_queue_events"]}

if __name__ == "__main__":
    sys.exit(main())
