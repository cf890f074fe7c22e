"""Set-up shared by the port's tests (tests/test_torch_*.py)."""

import ctypes
import gc

import jax
import numpy as np
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


def port_byz_fleet(engine, p, seeds, silent_i, silent_nodes, doctor_i):
    """tests/test_stream.py's ``byz_fleet_state`` on the port (CPU): the
    nodes ``silent_nodes`` of instance ``silent_i`` are silent, and
    instance ``doctor_i``'s node 1 holds a planted committed entry (depth 1,
    a foreign tag, round 999) as ``doctor_ctx`` plants it."""
    silent = np.zeros((len(seeds), p.n_nodes), bool)
    silent[silent_i, list(silent_nodes)] = True
    st = engine.init_batch(p, seeds, byz_silent=silent, device="cpu")
    cx = st.ctx

    def planted(x, idx, v):
        x = x.clone()
        x[idx] = v
        return x

    i = doctor_i
    return st.replace(ctx=cx.replace(
        commit_count=planted(cx.commit_count, (i, 1), 1),
        log_depth=planted(cx.log_depth, (i, 1, 0), 1),
        log_tag=planted(cx.log_tag, (i, 1, 0), int(np.uint32(0xDEADBEEF).view(np.int32))),
        log_round=planted(cx.log_round, (i, 1, 0), 999)))


def install_each(p, st, programs):
    """Row b of a port state takes ``programs[b]``'s attack rows (a port
    ``AttackProgram``; None: the inert rows)."""
    import torch
    from librabft_simulator_tpu_torch.adversary import plane

    rows = [pr.lower(p) if pr is not None else plane.default_rows(p) for pr in programs]
    return st.replace(**{k: torch.stack([torch.as_tensor(r[k]) for r in rows])
                         for k in rows[0]})
