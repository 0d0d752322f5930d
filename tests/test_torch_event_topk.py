"""K2 (event_topk) in the port against the reference's next-k extraction:
``lax.top_k`` (``sim/events.py::next_k_events``) and the Pallas kernel in
interpret mode (``kernels/ops.py::event_next_k``), on the same inputs. The
CUDA kernel's schedule (``kernels/radix_topk.py::emulate``: digit passes,
CTA partition, CTA-order prefix, gather, sort) is held bitwise to the plain
version and to the Pallas kernel."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.sim import events as ref_events  # noqa: E402
from repro_torch.kernels import event_topk, radix_topk, ref  # noqa: E402
from repro_torch.sim import events as pt_events  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401


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
    reaches the wrapper, which takes the plain version too. Any k is taken,
    a buffer above 1024 included (the kernel's route on the card)."""
    before = event_topk.launches
    for n, k, use_kernel in ((100, 8, None), (pt_events.KERNEL_THRESHOLD, 8, None),
                             (100, 8, True), (100, 8, False),
                             (pt_events.KERNEL_THRESHOLD, 2048, None),
                             (pt_events.KERNEL_THRESHOLD, 2048, True)):
        times = torch.from_numpy(_times(n, 0.5, seed=n))
        v, i = pt_events.next_k_events(times, k, use_kernel=use_kernel)
        rv, ri = ref.event_next_k_ref(times, k)
        assert torch.equal(v, rv) and torch.equal(i, ri)
    assert event_topk.launches == before


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_plain_holds_signed_zeros_as_the_pallas_kernel():
    """-0.0 and +0.0 tie and go by index, as the reference's Pallas K2
    (``max``/``argmax``) orders them; the values come back as given."""
    for times in (np.array([0.0, -0.0, 1.0, -0.0, 0.0], np.float32),
                  np.where(np.random.default_rng(3).random(300) < 0.5, 0.0, -0.0)
                  .astype(np.float32)):
        k = min(len(times), 40)
        v, i = event_topk.event_topk(torch.from_numpy(times), k)
        rv, ri = ref_ops.event_next_k(jnp.asarray(times), k, block_n=64)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        assert torch.equal(_bits(v), _bits(torch.from_numpy(times)[i]))
    assert event_topk.next_k_plain(torch.tensor([0.0, -0.0, 1.0, -0.0, 0.0]), 5)[1].tolist() \
        == [0, 1, 3, 4, 2]


def _schedule_case(name):
    """(times, k) of a schedule case: n <= 10 000 and k <= 300, but
    ONE_CTA_N + 1."""
    rng = np.random.default_rng(len(name))
    if name == "shared_top3_digits":  # images differ in the last 8 bits only
        bits = (0x3F800000 + rng.integers(0, 256, 5000)).astype(np.uint32)
        return bits.view(np.float32), 300
    if name == "ties_across_cta_edge":  # 60 of 200 ties at 5.0, around 1000
        t = (10 + rng.random(7000) * 10).astype(np.float32)
        t[950:1050] = t[1950:2050] = 5.0
        t[rng.choice(np.arange(3000, 7000), 100, replace=False)] = 1.0
        return t, 160
    if name == "k1":
        return (rng.random(3000) * 100).astype(np.float32), 1
    if name == "k_equals_n":
        return np.where(rng.random(257) < 0.5, rng.integers(0, 4, 257), np.inf).astype(
            np.float32), 257
    if name == "idle_fewer_than_k_pending":
        t = np.full(4000, np.inf, np.float32)
        t[rng.choice(4000, 100, replace=False)] = rng.random(100) * 50
        return t, 300
    if name == "negative":
        return rng.standard_normal(3000).astype(np.float32), 300
    if name == "signed_zeros":
        t = np.where(rng.random(2000) < 0.5, 0.0, -0.0).astype(np.float32)
        t[rng.choice(2000, 20, replace=False)] = -1.0
        return t, 300
    assert name == "one_cta_n_plus_1"
    return _times(radix_topk.ONE_CTA_N + 1, 0.02, seed=7), 200


SCHEDULE_CASES = ["shared_top3_digits", "ties_across_cta_edge", "k1", "k_equals_n",
                  "idle_fewer_than_k_pending", "negative", "signed_zeros",
                  "one_cta_n_plus_1"]


@pytest.mark.parametrize("name", SCHEDULE_CASES)
def test_schedule_equals_plain_and_pallas(name):
    """The kernel's schedule on its own plan and on a 7-CTA grid (CTA edges
    every n/7): bitwise the plain version; the Pallas kernel's values, and
    its indices wherever the time is finite."""
    times, k = _schedule_case(name)
    t = torch.from_numpy(times)
    pv, pi = event_topk.next_k_plain(t, k)
    for p in (None, radix_topk.plan(len(times), k, True, ctas=7)):
        v, i = radix_topk.emulate(t, k, sorted=True, desc=False, p=p)
        assert torch.equal(i, pi) and torch.equal(_bits(v), _bits(pv))
    _assert_same((v, i), ref_ops.event_next_k(jnp.asarray(times), k, block_n=2048))


@pytest.mark.parametrize("n,k,ctas", [(10_000, 2000, 1), (10_000, 5000, 7), (3000, 3000, 3)])
def test_schedule_lsd_sort_equals_plain(n, k, ctas):
    """k above 1024: the four LSD passes, on one CTA and (k > 4096) on every
    CTA with rows merged in CTA order."""
    t = torch.from_numpy(np.round(_times(n, 0.6, seed=k), 1))
    p = radix_topk.plan(n, k, True, ctas=ctas)
    assert p.sort_ctas == (ctas if k > radix_topk.SORT_ONE_CTA_K else 1)
    v, i = radix_topk.emulate(t, k, sorted=True, desc=False, p=p)
    pv, pi = event_topk.next_k_plain(t, k)
    assert torch.equal(i, pi) and torch.equal(_bits(v), _bits(pv))
