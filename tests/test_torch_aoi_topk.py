"""K3 (``aoi_topk``) of the port against the reference.

On the CPU the port's ``ops.oldest_age_topk`` takes its plain version (a
stable descending sort); the reference runs its Pallas kernel in interpret
mode through ``repro.kernels.ops``. Values and indices must be equal,
ties and signed zeros included, and so must the CUDA kernel's schedule
(``kernels/radix_topk.py::emulate``), sorted and unsorted. The fleet-scale
oldest-age and gumbel-age policies (n = 16384, k = 256, where the port's
``_topk_idx`` takes the kernel on the GPU) must give the reference's
selection masks under replayed draws.
Tests marked ``cuda`` hold the CUDA kernel to its plain version on the
card and skip here; they need no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_aoi_topk.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import selection as pt_sel  # noqa: E402
from repro_torch.core.draws import ReplayDraws  # noqa: E402
from repro_torch.kernels import aoi_topk, ops, radix_topk, ref  # noqa: E402
from repro_torch.sim.events import KERNEL_THRESHOLD  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401


def _reference():
    jax = pytest.importorskip("jax")
    from repro.core import selection as ref_sel
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as ref_ref

    return jax, ref_sel, ref_ops, ref_ref


def _ages(n, high, seed):
    return np.random.default_rng(seed).integers(0, high, n).astype(np.float32)


@pytest.mark.parametrize("n,k,block", [(10_000, 16, 1024), (1000, 7, 128),
                                       (65_536, 64, 8192)])
def test_plain_equals_reference_kernel(n, k, block):
    """``test_aoi_topk_matches_ref``'s cases: values and indices equal."""
    jax, _, ref_ops, _ = _reference()
    jnp = jax.numpy
    ages = _ages(n, 10_000, seed=n)
    rv, ri = ref_ops.oldest_age_topk(jnp.asarray(ages), k, block_n=block)
    v, i = ops.oldest_age_topk(torch.from_numpy(ages), k)
    assert v.dtype == torch.float32 and i.dtype == torch.int64
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


@pytest.mark.parametrize("n,k,block", [(10_000, 16, 1024), (10_000, 300, 65_536)])
def test_ties_go_to_the_lower_index_as_in_the_reference(n, k, block):
    """Integer ages in 0..9: most of the top k are ties."""
    jax, _, ref_ops, ref_ref = _reference()
    jnp = jax.numpy
    ages = _ages(n, 10, seed=1).astype(np.int32)
    rv, ri = ref_ops.oldest_age_topk(jnp.asarray(ages), k, block_n=block)
    v, i = ops.oldest_age_topk(torch.from_numpy(ages), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    rv2, ri2 = ref_ref.topk_ref(jnp.asarray(ages), k)
    v2, i2 = ref.topk_ref(torch.from_numpy(ages), k)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(rv2))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ri2))


def test_wrapper_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="1-D float32"):
        aoi_topk.aoi_topk(torch.zeros(10, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="k <= n"):
        aoi_topk.aoi_topk(torch.zeros(10), 11)
    with pytest.raises(ValueError, match="cpu or cuda"):
        aoi_topk.aoi_topk(torch.zeros(10, device="meta"), 3)


def test_policy_route_rule():
    """``_topk_idx`` on the CPU always sorts: no launch; the stable sort's
    indices, in index order (``sorted=False``), for any k."""
    score = torch.from_numpy(_ages(KERNEL_THRESHOLD, 50, seed=2))
    before = aoi_topk.launches
    for k in (256, 2458):
        idx = pt_sel._topk_idx(score, k)
        expect = torch.sort(aoi_topk.topk_plain(score, k)[1]).values
        np.testing.assert_array_equal(idx.numpy(), expect.numpy())
    assert aoi_topk.launches == before


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_unsorted_plain_is_the_sorted_set_in_index_order():
    values = torch.from_numpy(_ages(5000, 20, seed=4))
    sv, si = aoi_topk.topk_plain(values, 300)
    uv, ui = aoi_topk.topk_plain(values, 300, sorted=False)
    order = torch.argsort(si)
    assert torch.equal(ui, si[order]) and torch.equal(uv, sv[order])
    assert bool((ui[1:] > ui[:-1]).all())


def test_plain_holds_signed_zeros_as_the_pallas_kernel():
    """-0.0 and +0.0 tie and go by index, as the reference's Pallas K3
    (``max``/``argmax``) orders them within a tile; the values come back as
    given. One Pallas tile: across tiles the reference's phase 2
    (``lax.top_k``) ranks +0.0 above -0.0 (ROADMAP queue 3)."""
    jax, _, ref_ops, _ = _reference()
    jnp = jax.numpy
    for ages in (np.array([0.0, -0.0, 1.0, -0.0, 0.0], np.float32),
                 np.where(np.random.default_rng(3).random(300) < 0.5, 0.0, -0.0)
                 .astype(np.float32)):
        k = min(len(ages), 40)
        v, i = ops.oldest_age_topk(torch.from_numpy(ages), k)
        rv, ri = ref_ops.oldest_age_topk(jnp.asarray(ages), k, block_n=512)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        assert torch.equal(_bits(v), _bits(torch.from_numpy(ages)[i]))
    assert aoi_topk.topk_plain(torch.tensor([0.0, -0.0, 1.0, -0.0, 0.0]), 5)[1].tolist() \
        == [2, 0, 1, 3, 4]


def _schedule_case(name):
    """(values, k) of a schedule case: n <= 10 000 and k <= 300, but
    ONE_CTA_N + 1."""
    rng = np.random.default_rng(len(name) + 100)
    if name == "shared_top3_digits":  # images differ in the last 8 bits only
        bits = (0x42800000 + rng.integers(0, 256, 5000)).astype(np.uint32)
        return bits.view(np.float32), 300
    if name == "ties_across_cta_edge":  # 60 of 200 ties at 50, around 1000
        a = (rng.random(7000) * 10).astype(np.float32)
        a[950:1050] = a[1950:2050] = 50.0
        a[rng.choice(np.arange(3000, 7000), 100, replace=False)] = 90.0
        return a, 160
    if name == "k1":
        return _ages(3000, 1000, seed=5), 1
    if name == "k_equals_n":
        return _ages(257, 4, seed=6), 257
    if name == "negative":
        return rng.standard_normal(3000).astype(np.float32), 300
    if name == "signed_zeros":
        a = np.where(rng.random(2000) < 0.5, 0.0, -0.0).astype(np.float32)
        a[rng.choice(2000, 20, replace=False)] = 1.0
        return a, 300
    assert name == "one_cta_n_plus_1"
    return _ages(radix_topk.ONE_CTA_N + 1, 64, seed=7) + np.float32(0.25), 200


SCHEDULE_CASES = ["shared_top3_digits", "ties_across_cta_edge", "k1", "k_equals_n",
                  "negative", "signed_zeros", "one_cta_n_plus_1"]


@pytest.mark.parametrize("name", SCHEDULE_CASES)
def test_schedule_equals_plain_and_pallas(name):
    """The kernel's schedule on its own plan and on a 7-CTA grid (CTA edges
    every n/7), sorted and unsorted: bitwise the plain version; sorted, the
    Pallas kernel's values and indices (one Pallas tile, so no -1 padding)."""
    jax, _, ref_ops, _ = _reference()
    values, k = _schedule_case(name)
    t = torch.from_numpy(values)
    for sorted_ in (True, False):
        pv, pi = aoi_topk.topk_plain(t, k, sorted_)
        for p in (None, radix_topk.plan(len(values), k, sorted_, ctas=7)):
            v, i = radix_topk.emulate(t, k, sorted=sorted_, desc=True, p=p)
            assert torch.equal(i, pi) and torch.equal(_bits(v), _bits(pv))
    rv, ri = ref_ops.oldest_age_topk(jax.numpy.asarray(values), k, block_n=65_536)
    v, i = radix_topk.emulate(t, k, sorted=True, desc=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


@pytest.mark.parametrize("n,k,ctas", [(10_000, 2000, 1), (10_000, 5000, 7)])
def test_schedule_lsd_sort_equals_plain(n, k, ctas):
    """k above 1024, sorted: the four LSD passes, on one CTA and (k > 4096)
    on every CTA with rows merged in CTA order."""
    t = torch.from_numpy(_ages(n, 300, seed=k))
    v, i = radix_topk.emulate(t, k, sorted=True, desc=True,
                              p=radix_topk.plan(n, k, True, ctas=ctas))
    pv, pi = aoi_topk.topk_plain(t, k)
    assert torch.equal(i, pi) and torch.equal(_bits(v), _bits(pv))


N, K, STEPS = KERNEL_THRESHOLD, 256, 4


def _replay(jax, name, key):
    """The draws ``selection.simulate`` makes under its key schedule: init
    from ``key``, step r from ``split(fold_in(key, 1), rounds)[r]``."""
    init = {}
    if name == "oldest_age":
        init["policy_init"] = np.asarray(jax.random.permutation(key, N))
    steps = []
    for kr in jax.random.split(jax.random.fold_in(key, 1), STEPS):
        if name == "oldest_age":
            steps.append({"select": np.asarray(
                jax.random.uniform(kr, (N,), minval=0.0, maxval=0.5))})
        else:
            steps.append({"select": np.asarray(jax.random.gumbel(kr, (N,)))})
    return ReplayDraws(init, steps, "cpu")


@pytest.mark.parametrize("name", ["oldest_age", "gumbel_age"])
def test_fleet_scale_policy_masks_equal_the_reference(name):
    jax, ref_sel, _, _ = _reference()
    key = jax.random.PRNGKey(5)
    ref_hist = ref_sel.simulate(ref_sel.make_policy(name, N, K), key, N, STEPS)
    hist = pt_sel.simulate(pt_sel.make_policy(name, N, K), _replay(jax, name, key), N,
                           STEPS)
    np.testing.assert_array_equal(hist, ref_hist)
    assert (hist.sum(axis=1) == K).all()


# --- the CUDA kernel against its plain version (skip without a GPU) ------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_kernel(values, k):
    for sorted_ in (True, False):
        v, i = aoi_topk.aoi_topk(values, k, sorted_)
        pv, pi = aoi_topk.topk_plain(values, k, sorted_)
        torch.cuda.synchronize()
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(16_384, 256), (10_000, 16), (5000, 1),
                                 (20_000, 1024), (1_000_000, 128), (2047, 7),
                                 (16_384, 2458), (32_769, 32_769), (1_000_000, 150_000)],
                         ids=lambda v: str(v))
def test_kernel_equals_plain(cuda, n, k):
    """k = 1, 1024, the paper's 15% cohort, k = n above ONE_CTA_N, 1M
    clients; sorted and unsorted."""
    g = torch.Generator(device=cuda).manual_seed(n)
    ages = torch.randint(0, 50, (n,), generator=g, device=cuda).float()
    _check_kernel(ages + torch.rand(n, generator=g, device=cuda) * 0.5, k)
    _check_kernel(ages, k)  # integer ages: ties


@pytest.mark.cuda
def test_kernel_all_equal_ages_give_the_lowest_indices(cuda):
    ages = torch.full((70_000,), 3.0, device=cuda)
    v, i = aoi_topk.aoi_topk(ages, 512)
    assert torch.equal(i.cpu(), torch.arange(512)) and bool((v == 3.0).all())


@pytest.mark.cuda
def test_kernel_takes_k_above_1024(cuda):
    """All equal: every element ties at the threshold, across CTAs."""
    _check_kernel(torch.full((50_000,), 2.0, device=cuda), 1025)
    _check_kernel(torch.zeros(50_000, device=cuda), 50_000)


@pytest.mark.cuda
def test_policy_takes_the_kernel_at_fleet_scale(cuda):
    score = torch.rand(KERNEL_THRESHOLD, device=cuda)
    for k in (256, 2458):  # any k, the paper's 15% cohort included
        before = aoi_topk.launches
        idx = pt_sel._topk_idx(score, k)
        assert aoi_topk.launches == before + 1
        assert torch.equal(idx, aoi_topk.topk_plain(score, k, sorted=False)[1])
    before = aoi_topk.launches
    pt_sel._topk_idx(score[:1000], 8)  # below the fleet-scale threshold
    assert aoi_topk.launches == before
