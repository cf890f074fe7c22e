"""Batched event selection: the hand-written CUDA kernel that replaces the
Pallas TPU kernel ``librabft_simulator_tpu/ops/pallas_queue.py::select_events``
(body ``_select_kernel``), and its plain PyTorch versions.

Per row it returns the winning column and the row's minimum time: the
lexicographic argmin over (time ascending, kind descending, stamp ascending,
column ascending).  Two entries share one kernel (``csrc/select_events.cu``):

- ``select_events(times, kinds, stamps)``: int32 ``[B, M]``, the TPU
  kernel's contract (invalid slots carry ``time == NEVER``).
- ``select_queue_events(valid, time, kind, stamp, timer_time, timer_stamp,
  kind_timer)``: the engine's queue (bool ``valid`` and int32 ``time``,
  ``kind``, ``stamp``, all ``[B, cm]``) and timers (int32 ``[B, n]``) read in
  place.  It equals ``select_events`` on the ``[B, cm + n]`` concatenation
  (messages with ``time = NEVER`` where not valid, then the timers with kind
  ``kind_timer``), which it never builds.

Layout: every operand has unit column stride and a row stride of at least
its width; rows need not be contiguous.  The engine's queue leaves are
``[B, cm]`` views of ``[B, cm + 1]`` buffers (``utils/xops.py::scatter_set``),
and the kernel reads them as they are: nothing here calls ``.contiguous()``.
The kernel copies tiles of rows with 16-byte bulk copies, so every operand's
first element must lie on a 16-byte boundary.  The checks are the same on
every device and raise on what the kernel does not take.

For CPU tensors each entry runs its plain version.  For CUDA tensors it
launches the kernel or raises; there is no fallback.  ``select_events.launches``
and ``select_queue_events.launches`` count kernel launches.

The kernel library is built at first use with ``nvcc`` into
``build/kernels/`` (listed in ``.gitignore``) from the sources in this
package, as a shared library with plain C entry points loaded through
``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

import torch

from ..telemetry import ledger as tledger
from ..utils.xops import const

NEVER = 2**31 - 1
I32 = torch.int32
ALIGN = 16  # bytes: bulk copies need 16-byte aligned sources

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "select_events.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libselect_events.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lib = None
_lock = threading.Lock()


def select_events_plain(times, kinds, stamps):
    """The three masked reductions of ``select_events_reference``."""
    t_min = times.min(dim=1).values
    c1 = times == t_min.unsqueeze(1)
    k_best = torch.where(c1, kinds, -1).max(dim=1).values
    c2 = c1 & (kinds == k_best.unsqueeze(1))
    s_best = torch.where(c2, stamps, NEVER).min(dim=1).values
    c3 = c2 & (stamps == s_best.unsqueeze(1))
    idx = c3.to(torch.int32).argmax(dim=1).to(torch.int32)
    return idx, t_min


def select_queue_events_plain(valid, time, kind, stamp, timer_time, timer_stamp,
                              kind_timer):
    """The engine's select step as the JAX package builds it: the
    ``[B, cm + n]`` rows (messages, then timers), then ``select_events_plain``."""
    b, n = timer_time.shape
    dev = timer_time.device
    msg_time = torch.where(valid, time, NEVER)
    all_time = torch.cat([msg_time, timer_time], dim=1)
    all_kind = torch.cat([kind, const((b, n), kind_timer, I32, dev)], dim=1)
    all_stamp = torch.cat([stamp, timer_stamp], dim=1)
    return select_events_plain(all_time, all_kind, all_stamp)


#: Where the CUDA toolkit installs nvcc; otherwise nvcc is looked up on PATH.
NVCC = "/usr/local/cuda/bin/nvcc"


def nvcc_path() -> str:
    return NVCC if os.path.exists(NVCC) else "nvcc"


def build(verbose: bool = False) -> str:
    """Compile the kernel library (if the build is older than the source)
    and return its path.  The runtime ledger (telemetry/ledger.py) gets one
    compile entry: the nvcc seconds, and whether a current library was
    found (``persistent-hit``) or built (``persistent-miss``)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    key = tledger.params_key((os.path.basename(SOURCE), NVCC_FLAGS))
    with tledger.get().compile_attribution(key, engine="select_events",
                                           source=os.path.basename(SOURCE)) as entry:
        if (os.path.exists(LIB_PATH)
                and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)):
            entry["cache_hits"] = 1
            return LIB_PATH
        entry["cache_misses"] = 1
        tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        entry["compile_s"] = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        if verbose:
            print(res.stderr.strip())
        os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load():
    """Build (at first use) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, stride, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            fn = lib.select_events_launch
            fn.argtypes = [ptr, stride, stride] * 3 + [ptr, ptr, i32, i32, ptr]
            fn.restype = i32
            fn = lib.select_queue_events_launch
            fn.argtypes = [ptr, stride, stride] * 6 + [ptr, ptr, i32, i32, i32, i32, ptr]
            fn.restype = i32
            _lib = lib
    return _lib


def _check(fn: str, operands, batch, device):
    """Raise unless every ``(name, tensor, dtype, width)`` is a 2-D tensor of
    that dtype and shape ``[batch, width]`` on ``device``, with unit column
    stride, a row stride of at least its width, and a 16-byte aligned first
    element."""
    for name, x, dtype, width in operands:
        if x.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"{fn}: {name} must be 2-D, got {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{fn}: operands lie on different devices")
        if tuple(x.shape) != (batch, width):
            raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, expected "
                             f"({batch}, {width})")
        if width > 1 and x.stride(1) != 1:
            raise ValueError(f"{fn}: {name} must have unit column stride, got "
                             f"strides {x.stride()}")
        if batch > 1 and x.stride(0) < width:
            raise ValueError(f"{fn}: {name} rows overlap (strides {x.stride()})")
        if x.data_ptr() % ALIGN:
            raise ValueError(f"{fn}: {name} must start on a {ALIGN}-byte "
                             f"boundary (bulk copies), got address {x.data_ptr():#x}")


def _operand(x):
    """The kernel's view of one operand: its first element's address, its
    row stride in elements, and the bytes from its first element to the end
    of its storage (how far a bulk copy may round up)."""
    stride = x.stride(0) if x.shape[0] > 1 else x.shape[1]
    avail = x.untyped_storage().nbytes() - x.storage_offset() * x.element_size()
    return x.data_ptr(), stride, avail


def _run(entry, plain, operands, sizes, extra=()):
    """Run ``plain`` on CPU tensors; on CUDA tensors launch the kernel entry
    named after ``entry`` on the current stream and count the launch."""
    dev = operands[0].device
    if dev.type == "cpu":
        return plain(*operands, *extra)
    name = entry.__name__
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    launch = getattr(load(), f"{name}_launch")
    b = operands[0].shape[0]
    idx = torch.empty(b, dtype=I32, device=dev)
    t_min = torch.empty(b, dtype=I32, device=dev)
    if b == 0:
        return idx, t_min
    err = launch(*(v for x in operands for v in _operand(x)), idx.data_ptr(),
                 t_min.data_ptr(), b, *sizes, *extra,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    entry.launches += 1
    return idx, t_min


def select_events(times, kinds, stamps):
    """Batched lexicographic argmin over int32 ``[B, M]`` rows:
    ``(idx [B], t_min [B])`` int32."""
    if times.dim() != 2:
        raise ValueError(f"select_events: times must be 2-D, got {tuple(times.shape)}")
    b, m = times.shape
    _check("select_events", [("times", times, I32, m), ("kinds", kinds, I32, m),
                             ("stamps", stamps, I32, m)], b, times.device)
    if m < 1:
        raise ValueError("select_events: rows must have at least one column")
    return _run(select_events, select_events_plain, (times, kinds, stamps), (m,))


select_events.launches = 0


def select_queue_events(valid, time, kind, stamp, timer_time, timer_stamp,
                        kind_timer: int):
    """The engine's event select over its queue and timers, read in place:
    ``(idx [B], t_min [B])`` int32, with columns ``0..cm-1`` for messages and
    ``cm..cm+n-1`` for timers."""
    if valid.dim() != 2 or timer_time.dim() != 2:
        raise ValueError("select_queue_events: valid and timer_time must be 2-D")
    b, cm = valid.shape
    n = timer_time.shape[1]
    _check("select_queue_events",
           [("valid", valid, torch.bool, cm), ("time", time, I32, cm),
            ("kind", kind, I32, cm), ("stamp", stamp, I32, cm),
            ("timer_time", timer_time, I32, n), ("timer_stamp", timer_stamp, I32, n)],
           b, valid.device)
    if cm < 1:
        raise ValueError("select_queue_events: the queue must have at least one slot")
    kind_timer = int(kind_timer)
    if not -2**31 <= kind_timer < 2**31:
        raise ValueError(f"select_queue_events: kind_timer {kind_timer} is not int32")
    return _run(select_queue_events, select_queue_events_plain,
                (valid, time, kind, stamp, timer_time, timer_stamp), (cm, n), (kind_timer,))


select_queue_events.launches = 0
