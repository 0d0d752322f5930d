"""K2's wrapper on its own (torch only, no JAX, so the file also runs on
the GPU machine): input checks, the pass plan, and — on a card — the CUDA
kernel against its plain version.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_wrapper.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import event_topk  # noqa: E402


def _times(n, pending_frac, seed):
    rng = np.random.default_rng(seed)
    t = (rng.random(n) * 100).astype(np.float32)
    pending = rng.random(n) < pending_frac
    return np.where(pending, t, np.inf).astype(np.float32)


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        event_topk.event_topk(torch.zeros(8, dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        event_topk.event_topk(torch.zeros(8), 9)
    with pytest.raises(ValueError):
        event_topk.event_topk(torch.zeros((2, 4)), 2)


@pytest.mark.parametrize("n,k,passes", [
    (48, 8, 1), (2048, 256, 1), (16384, 256, 2), (65536, 256, 3),
    (1_000_003, 256, 4), (2**20, 1024, 10),
])
def test_pass_plan(n, k, passes):
    """Each pass keeps k of every TILE keys until one tile is left; the
    plan must terminate for every k <= MAX_K."""
    assert event_topk.num_passes(n, k) == passes


def test_cpu_tensor_takes_the_plain_version():
    times = torch.from_numpy(_times(300, 0.4, seed=1))
    before = event_topk.launches
    v, i = event_topk.event_topk(times, 16)
    pv, pi = event_topk.next_k_plain(times, 16)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert event_topk.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,frac", [
    (48, 8, 0.5), (16384, 256, 0.3), (65536, 8, 0.01), (1_000_003, 256, 0.5),
    (2**20, 1024, 0.3),
])
def test_kernel_matches_plain_on_gpu(n, k, frac):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    times = torch.from_numpy(_times(n, frac, seed=n)).cuda()
    before = event_topk.launches
    v, i = event_topk.event_topk(times, k)
    pv, pi = event_topk.next_k_plain(times, k)
    torch.cuda.synchronize()
    fin = torch.isfinite(pv)
    assert torch.equal(v, pv) and torch.equal(i[fin], pi[fin])
    assert event_topk.launches == before + 1


@pytest.mark.cuda
def test_kernel_rejects_k_above_max_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    with pytest.raises(ValueError, match="k <="):
        event_topk.event_topk(torch.zeros(4096, device="cuda"), event_topk.MAX_K + 1)
