"""K2's wrapper on its own (torch only, no JAX, so the file also runs on
the GPU machine): input checks, the launch plan, and — on a card — the CUDA
kernel against its plain version, bit for bit (indices of idle slots too).

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_wrapper.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import event_topk, radix_topk  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401


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


@pytest.mark.parametrize("n,k,sorted_,route,ctas,sort_ctas,barriers", [
    (48, 8, True, "one_cta", 1, 1, 0),
    (16384, 256, True, "one_cta", 1, 1, 0),  # the main path's pop
    (16384, 2458, False, "one_cta", 1, 1, 0),  # the paper's 15% cohort
    (32768, 32768, True, "one_cta", 1, 1, 0),  # ONE_CTA_N, k = n
    (32769, 100, True, "grid", 5, 1, 6),
    (65536, 2048, True, "grid", 8, 1, 6),
    (1_000_000, 256, False, "grid", 123, 1, 5),
    (1_000_000, 150_000, True, "grid", 123, 123, 13),
    (2**31 - 1, 10, True, "grid", 132, 1, 6),  # windows reloaded every pass
])
def test_pass_plan(n, k, sorted_, route, ctas, sort_ctas, barriers):
    """One launch at any (n, k); one CTA up to ONE_CTA_N; the grid, its
    barriers and shared memory from (n, k, sorted) and the SM count alone."""
    p = event_topk.plan(n, k, sorted_)
    assert (p.route, p.ctas, p.sort_ctas, p.barriers, p.launches) == (
        route, ctas, sort_ctas, barriers, 1)
    assert p.ctas <= radix_topk.SMS and p.chunk * p.ctas >= n
    assert p.window <= radix_topk.WINDOW and p.windows == -(-p.chunk // radix_topk.WINDOW)
    assert p.smem_bytes + 2048 <= 232_448  # dynamic + static, the H100's per-block limit
    assert p.scratch_words >= (4 * k if sorted_ and (ctas > 1 or k > 1024) else 0)


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
    (2**20, 1024, 0.3), (65536, 2048, 0.02), (2**20, 16384, 0.3), (32768, 32768, 0.5),
])
def test_kernel_matches_plain_on_gpu(n, k, frac):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    times = torch.from_numpy(_times(n, frac, seed=n)).cuda()
    before = event_topk.launches
    v, i = event_topk.event_topk(times, k)
    pv, pi = event_topk.next_k_plain(times, k)
    torch.cuda.synchronize()
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
    assert event_topk.launches == before + 1


@pytest.mark.cuda
def test_kernel_takes_k_above_1024_on_gpu():
    """The pop of ``fl_async --clients 65536 --k 2048``, and k = n."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    for n, k in ((65536, 2048), (4096, 4096)):
        times = torch.from_numpy(_times(n, 0.03, seed=k)).cuda()
        v, i = event_topk.event_topk(times, k)
        pv, pi = event_topk.next_k_plain(times, k)
        torch.cuda.synchronize()
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
