"""Set-up shared by the port's tests (tests/test_torch_*.py)."""

import ctypes
import gc

import jax
import pytest

_released_once = False


def release_jax_memory():
    """Drop every executable this process has built and hand the freed heap
    back to the system.

    A pytest worker keeps each executable it builds until it exits, and the
    whole suite holds tens of GB by its last files; later calls rebuild from
    the persistent compile cache.  glibc keeps freed heap unless trimmed."""
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL(None).malloc_trim(0)
    except AttributeError:  # not glibc
        pass


def import_torch():
    """Import torch for one test file, single-threaded.  Called when a test of
    the file first runs, not when the file is collected: every xdist worker
    collects every file, and torch costs each of them about 170 MB.

    The first call in a process first releases what the worker built for
    earlier files, so that torch and the port's referees are loaded into
    that room rather than on top of it.  Later calls leave the JAX caches
    alone: the eager referees of the other port files reuse them."""
    global _released_once
    if not _released_once:
        release_jax_memory()
        _released_once = True
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    return torch
