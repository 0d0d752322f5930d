"""K1 (``fedavg_reduce``): the port's wrapper and plain version against the
reference's Pallas kernel (interpret mode on the CPU, as
``tests/test_kernels.py`` runs it) and its oracle ``fedavg_reduce_ref``.

The sums run in another order than the reference's (a torch reduction
against a Pallas dot or an einsum), so values agree within rtol 1e-5 /
atol 1e-6, not bitwise. On a card, the CUDA kernel is held against the
plain version at the same tolerance (the reference is imported inside the
tests that use it, so the file also runs where JAX is absent):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fedavg_reduce.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fedavg_reduce as k1  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _reference():
    """(jax.numpy, repro.kernels.ops, repro.kernels.ref)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as ref_ref

    return jnp, ref_ops, ref_ref


def _inputs(C, N, seed, zero_slots=0):
    rng = np.random.default_rng(seed)
    params = rng.standard_normal((C, N)).astype(np.float32)
    logits = rng.standard_normal(C)
    w = np.exp(logits) / np.exp(logits).sum()
    if zero_slots:
        w[C - zero_slots:] = 0.0  # cohort padding
        w /= w.sum()
    return params, w.astype(np.float32)


@pytest.mark.parametrize("C,N,block,zero_slots", [
    (4, 1000, 256, 0), (4, 1000, 256, 1), (33, 4096, 4096, 0), (33, 4096, 4096, 7),
    (1, 17, 8, 0),
])
def test_plain_k1_matches_pallas_and_oracle(C, N, block, zero_slots):
    jnp, ref_ops, ref_ref = _reference()
    params, w = _inputs(C, N, seed=C * N, zero_slots=zero_slots)
    got = ops.fedavg_reduce(torch.from_numpy(params), torch.from_numpy(w)).numpy()
    pallas = np.asarray(ref_ops.fedavg_reduce(jnp.asarray(params), jnp.asarray(w),
                                              block_n=block))
    oracle = np.asarray(ref_ref.fedavg_reduce_ref(jnp.asarray(params), jnp.asarray(w)))
    assert got.shape == (N,) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ref.fedavg_reduce_ref(torch.from_numpy(params), torch.from_numpy(w)).numpy(),
        oracle, rtol=RTOL, atol=ATOL)


def test_masked_weights_contribute_nothing():
    """Zero weights (cohort padding) add exactly 0, as in the reference's
    ``test_fedavg_reduce_masked_weights``."""
    jnp, ref_ops, _ = _reference()
    params = np.stack([np.ones(100), 5 * np.ones(100), 9 * np.ones(100)]).astype(np.float32)
    w = np.array([0.5, 0.5, 0.0], np.float32)
    got = ops.fedavg_reduce(torch.from_numpy(params), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, 3.0 * np.ones(100, np.float32))
    pallas = np.asarray(ref_ops.fedavg_reduce(jnp.asarray(params), jnp.asarray(w),
                                              block_n=64))
    np.testing.assert_allclose(got, pallas, atol=ATOL)


def test_nan_in_a_zero_weight_slot_propagates_as_in_the_reference():
    """Every slot counts, as in the Pallas dot: 0 * NaN is NaN."""
    jnp, ref_ops, _ = _reference()
    params = np.ones((3, 8), np.float32)
    params[2, 5] = np.nan
    w = np.array([0.5, 0.5, 0.0], np.float32)
    got = ops.fedavg_reduce(torch.from_numpy(params), torch.from_numpy(w)).numpy()
    pallas = np.asarray(ref_ops.fedavg_reduce(jnp.asarray(params), jnp.asarray(w),
                                              block_n=8))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(pallas))
    assert np.isnan(got[5]) and not np.isnan(np.delete(got, 5)).any()


@pytest.mark.parametrize("params,weights,match", [
    (torch.zeros((3, 4), dtype=torch.float64), torch.zeros(3), "2-D float32"),
    (torch.zeros((3, 4, 2)), torch.zeros(3), "2-D float32"),
    (torch.zeros((3, 4)), torch.zeros(3, dtype=torch.float16), "1-D float32"),
    (torch.zeros((3, 4)), torch.zeros((3, 1)), "1-D float32"),
    (torch.zeros((3, 4)), torch.zeros(4), "length"),
    (torch.zeros((3, 4)), torch.zeros(3, device="meta"), "on cpu"),
    (torch.zeros((4, 3)).t(), torch.zeros(3), "contiguous"),
    (torch.zeros((3, 4), device="meta"), torch.zeros(3, device="meta"), "cpu or cuda"),
], ids=["dtype", "rank", "w_dtype", "w_rank", "length", "device", "strided", "meta"])
def test_wrapper_rejects_bad_input(params, weights, match):
    before = k1.launches
    with pytest.raises(ValueError, match=match):
        k1.fedavg_reduce(params, weights)
    assert k1.launches == before


def test_cpu_tensor_takes_the_plain_version_without_counting():
    params, w = _inputs(5, 300, seed=3)
    P, W = torch.from_numpy(params), torch.from_numpy(w)
    before = k1.launches
    out = k1.fedavg_reduce(P, W)
    assert torch.equal(out, k1.fedavg_reduce_plain(P, W))
    assert k1.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("C,N", [
    (30, 800), (30, 32), (30, 1_605_632), (30, 10), (1, 17), (7, 1001),
    (320, 1_605_632), (2050, 4096),
])
def test_kernel_matches_plain_on_gpu(C, N):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    params, w = _inputs(C, N, seed=N, zero_slots=C // 3)
    P, W = torch.from_numpy(params).cuda(), torch.from_numpy(w).cuda()
    before = k1.launches
    out = k1.fedavg_reduce(P, W)
    again = k1.fedavg_reduce(P, W)
    plain = k1.fedavg_reduce_plain(P, W)
    torch.cuda.synchronize()
    assert k1.launches == before + 2
    assert torch.equal(out, again)  # a fixed-order sum: launches repeat bitwise
    torch.testing.assert_close(out, plain, rtol=RTOL, atol=ATOL)
