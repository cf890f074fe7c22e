"""The hand-written CUDA select kernel (librabft_simulator_tpu_torch/csrc/
select_events.cu) equals its plain PyTorch version bit for bit at the main
path's shapes, tie and all-NEVER rows included.  Needs a card: the tests
carry the ``cuda`` marker and skip elsewhere.  This file imports neither
jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import glob
import shutil

import numpy as np
import pytest

NEVER = 2**31 - 1


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs (not
    when it is collected: every xdist worker collects every file).  A machine
    with neither an NVIDIA device node nor ``nvidia-smi`` has no card, and
    the tests skip there before torch is loaded into the worker."""
    global torch, sel
    if not glob.glob("/dev/nvidia*") and shutil.which("nvidia-smi") is None:
        pytest.skip("needs a CUDA device (no NVIDIA driver on this machine)")
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    from librabft_simulator_tpu_torch.ops import select_events as sel
    assert sel.NEVER == NEVER


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


def _rows(rng, b, m):
    """Random rows (~30% NEVER, unique stamps), then 8 rows tied on time
    and kind with repeated stamps, then 8 all-NEVER rows."""
    times = rng.integers(0, 100, (b, m)).astype(np.int32)
    times[rng.random((b, m)) < 0.3] = NEVER
    kinds = rng.integers(-1, 4, (b, m)).astype(np.int32)
    stamps = np.argsort(rng.random((b, m)), axis=1).astype(np.int32)
    times[:8], kinds[:8] = 3, 2
    stamps[:16] = rng.integers(0, 5, (16, m))
    times[8:16] = NEVER
    return times, kinds, stamps


@pytest.mark.cuda
@pytest.mark.parametrize("m", [68, 36])
def test_cuda_kernel_matches_plain(cuda_device, m):
    args = [torch.as_tensor(x, device=cuda_device)
            for x in _rows(np.random.default_rng(m), 10000, m)]
    before = sel.select_events.launches
    idx_k, tmin_k = sel.select_events(*args)
    assert sel.select_events.launches == before + 1
    idx_p, tmin_p = sel.select_events_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(idx_k, idx_p) and torch.equal(tmin_k, tmin_p)
