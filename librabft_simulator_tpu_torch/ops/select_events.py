"""Batched event selection: the hand-written CUDA kernel that replaces the
Pallas TPU kernel ``librabft_simulator_tpu/ops/pallas_queue.py::select_events``
(body ``_select_kernel``), and its plain PyTorch version.

Per row of int32 ``[B, M]`` (times, kinds, stamps) it returns the winning
column and the row's minimum time: the lexicographic argmin over (time
ascending, kind descending, stamp ascending, column ascending).  Invalid
slots carry ``time == NEVER``.  In the engine ``M = queue_cap + n_nodes``
(messages, then one timer per node).

``select_events`` runs the plain version only for CPU tensors.  For CUDA
tensors it launches the kernel (``csrc/select_events.cu``) or raises; there
is no fallback.  ``select_events.launches`` counts kernel launches.

The kernel library is built at first use with ``nvcc`` into
``build/kernels/`` (listed in ``.gitignore``) from the sources in this
package, as a shared library with a plain C entry point loaded through
``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import torch

NEVER = 2**31 - 1

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


#: Where the CUDA toolkit installs nvcc; otherwise nvcc is looked up on PATH.
NVCC = "/usr/local/cuda/bin/nvcc"


def nvcc_path() -> str:
    return NVCC if os.path.exists(NVCC) else "nvcc"


def build(verbose: bool = False) -> str:
    """Compile the kernel library (if the build is older than the source)
    and return its path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    if (not os.path.exists(LIB_PATH)
            or os.path.getmtime(LIB_PATH) < os.path.getmtime(SOURCE)):
        tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE]
        res = subprocess.run(cmd, capture_output=True, text=True)
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
            fn = lib.select_events_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(times, kinds, stamps):
    for name, x in (("times", times), ("kinds", kinds), ("stamps", stamps)):
        if x.dtype != torch.int32:
            raise TypeError(f"select_events: {name} must be int32, got {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"select_events: {name} must be 2-D, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"select_events: {name} must be contiguous")
        if x.shape != times.shape:
            raise ValueError("select_events: operands differ in shape")
        if x.device != times.device:
            raise ValueError("select_events: operands lie on different devices")


def select_events(times, kinds, stamps):
    """Batched lexicographic argmin: ``(idx [B], t_min [B])`` int32."""
    _check(times, kinds, stamps)
    if times.device.type == "cpu":
        return select_events_plain(times, kinds, stamps)
    if times.device.type != "cuda":
        raise ValueError(f"select_events: unsupported device {times.device}")
    lib = load()
    b, m = times.shape
    idx = torch.empty(b, dtype=torch.int32, device=times.device)
    t_min = torch.empty(b, dtype=torch.int32, device=times.device)
    if b == 0:
        return idx, t_min
    stream = torch.cuda.current_stream(times.device).cuda_stream
    err = lib.select_events_launch(
        times.data_ptr(), kinds.data_ptr(), stamps.data_ptr(),
        idx.data_ptr(), t_min.data_ptr(), b, m, stream)
    if err != 0:
        raise RuntimeError(f"select_events kernel launch failed: CUDA error {err}")
    select_events.launches += 1
    return idx, t_min


select_events.launches = 0
