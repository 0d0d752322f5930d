"""K2 (event_topk) in the port against the reference's next-k extraction:
``lax.top_k`` (``sim/events.py::next_k_events``) and the Pallas kernel in
interpret mode (``kernels/ops.py::event_next_k``), on the same inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.sim import events as ref_events  # noqa: E402
from repro_torch.kernels import event_topk, ref  # noqa: E402
from repro_torch.sim import events as pt_events  # noqa: E402


def _times(n, pending_frac, seed):
    rng = np.random.default_rng(seed)
    t = (rng.random(n) * 100).astype(np.float32)
    pending = rng.random(n) < pending_frac
    return np.where(pending, t, np.inf).astype(np.float32)


def _assert_same(pt, ref_vt):
    """Values equal; indices equal wherever the time is finite."""
    (pv, pi), (rv, ri) = pt, ref_vt
    pv, pi = pv.numpy(), pi.numpy()
    rv, ri = np.asarray(rv), np.asarray(ri)
    np.testing.assert_array_equal(pv, rv)
    fin = np.isfinite(rv)
    np.testing.assert_array_equal(pi[fin], ri[fin])


CASES = [
    (64, 4, 16, 1.0),
    (1000, 16, 128, 0.3),
    (1000, 16, 256, 0.01),  # fewer pending events than k in most tiles
    (513, 8, 128, 0.5),  # ragged final tile
]


@pytest.mark.parametrize("n,k,block_n,pending_frac", CASES)
def test_plain_matches_reference_topk_and_pallas(n, k, block_n, pending_frac):
    times = _times(n, pending_frac, seed=n * k)
    pt = event_topk.event_topk(torch.from_numpy(times), k)  # CPU -> plain
    _assert_same(pt, ref_events.next_k_events(jnp.asarray(times), k,
                                              use_kernel=False))
    _assert_same(pt, ref_ops.event_next_k(jnp.asarray(times), k,
                                          block_n=block_n))


@pytest.mark.parametrize("name,times,k", [
    ("all_ties", np.full((100,), 5.0, np.float32), 7),
    ("all_idle", np.full((64,), np.inf, np.float32), 4),
    ("fewer_than_k", np.where(np.arange(40) % 13 == 0, 3.0, np.inf)
     .astype(np.float32), 8),
])
def test_plain_edge_cases(name, times, k):
    pt = event_topk.event_topk(torch.from_numpy(times), k)
    _assert_same(pt, ref_events.next_k_events(jnp.asarray(times), k,
                                              use_kernel=False))
    _assert_same(pt, ref_ops.event_next_k(jnp.asarray(times), k, block_n=16))
    if name == "all_ties":
        np.testing.assert_array_equal(pt[1].numpy(), np.arange(k))


def test_next_k_events_routes_by_threshold_and_device():
    """Below the threshold, or on the CPU, the port takes the plain version
    and never counts a kernel launch; ``use_kernel=True`` on a CPU tensor
    reaches the wrapper, which takes the plain version too."""
    before = event_topk.launches
    for n, use_kernel in ((100, None), (pt_events.KERNEL_THRESHOLD, None),
                          (100, True), (100, False)):
        times = torch.from_numpy(_times(n, 0.5, seed=n))
        v, i = pt_events.next_k_events(times, 8, use_kernel=use_kernel)
        rv, ri = ref.event_next_k_ref(times, 8)
        assert torch.equal(v, rv) and torch.equal(i, ri)
    assert event_topk.launches == before
