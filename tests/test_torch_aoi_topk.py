"""K3 (``aoi_topk``) of the port against the reference.

On the CPU the port's ``ops.oldest_age_topk`` takes its plain version (a
stable descending sort); the reference runs its Pallas kernel in interpret
mode through ``repro.kernels.ops``. Values and indices must be equal,
ties included. The fleet-scale oldest-age and gumbel-age policies
(n = 16384, k = 256, where the port's ``_topk_idx`` takes the kernel on the
GPU) must give the reference's selection masks under replayed draws.
Tests marked ``cuda`` hold the CUDA kernel to its plain version on the
card and skip here; they need no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_aoi_topk.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import selection as pt_sel  # noqa: E402
from repro_torch.core.draws import ReplayDraws  # noqa: E402
from repro_torch.kernels import aoi_topk, ops, ref  # noqa: E402
from repro_torch.sim.events import KERNEL_THRESHOLD  # noqa: E402


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
    """``_topk_idx`` on the CPU always sorts: no launch, same indices."""
    score = torch.from_numpy(_ages(KERNEL_THRESHOLD, 50, seed=2))
    before = aoi_topk.launches
    idx = pt_sel._topk_idx(score, 256)
    assert aoi_topk.launches == before
    np.testing.assert_array_equal(idx.numpy(), aoi_topk.topk_plain(score, 256)[1].numpy())


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
    v, i = aoi_topk.aoi_topk(values, k)
    pv, pi = aoi_topk.topk_plain(values, k)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(16_384, 256), (10_000, 16), (5000, 1),
                                 (20_000, 1024), (1_000_000, 128), (2047, 7)],
                         ids=lambda v: str(v))
def test_kernel_equals_plain(cuda, n, k):
    """n not a multiple of the tile, k = 1 and k = 1024, 1M clients."""
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
def test_kernel_rejects_k_above_its_tile(cuda):
    with pytest.raises(ValueError, match="k <="):
        aoi_topk.aoi_topk(torch.zeros(50_000, device=cuda), aoi_topk.MAX_K + 1)


@pytest.mark.cuda
def test_policy_takes_the_kernel_at_fleet_scale(cuda):
    score = torch.rand(KERNEL_THRESHOLD, device=cuda)
    before = aoi_topk.launches
    idx = pt_sel._topk_idx(score, 256)
    assert aoi_topk.launches == before + 1
    assert torch.equal(idx, aoi_topk.topk_plain(score, 256)[1])
    before = aoi_topk.launches
    pt_sel._topk_idx(score, 2000)  # k above the tile: the stable sort
    pt_sel._topk_idx(score[:1000], 8)  # below the fleet-scale threshold
    assert aoi_topk.launches == before
