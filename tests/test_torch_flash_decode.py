"""K5 (``flash_decode``): the port's wrapper and plain version against the
reference's oracle ``flash_decode_ref`` for every case of
``tests/test_kernels.py::test_flash_decode_allclose`` and
``test_flash_decode_per_batch_valid_len``, and against the Pallas kernel in
interpret mode for one f32 and one bf16 case.

Tolerances are the reference's own: 2e-5 in f32, 2e-2 in bf16. On a card,
the CUDA kernel is held against the plain version at the same tolerances,
with the cache in the model's (B, L, Hk, D) layout read through strides:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_decode.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_decode as k5  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

CASES = [
    (2, 2, 4, 512, 64, 512, 128),
    (1, 4, 1, 1024, 128, 700, 256),  # partial cache (masked tail)
    (1, 1, 8, 384, 64, 384, 256),  # L not a multiple of block (padding)
]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as ref_ref

    return jnp, ref_ops, ref_ref


def _qkv(B, Hk, G, L, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hk, G, D)).astype(np.float32),
            rng.standard_normal((B, Hk, L, D)).astype(np.float32),
            rng.standard_normal((B, Hk, L, D)).astype(np.float32))


def _torch(arrs, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in arrs]


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hk,G,L,D,vlen,block", CASES)
def test_plain_k5_matches_oracle(B, Hk, G, L, D, vlen, block, dtype):
    jnp, _, ref_ref = _reference()
    arrs = _qkv(B, Hk, G, L, D)
    got = ops.flash_decode(*_torch(arrs, dtype), vlen, scale=D**-0.5, block_l=block)
    exp = ref_ref.flash_decode_ref(*(jnp.asarray(a, dtype) for a in arrs), vlen,
                                   scale=D**-0.5)
    assert got.shape == (B, Hk, G, D) and got.dtype == getattr(torch, dtype)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(got), np.asarray(exp, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(ref.flash_decode_ref(*_torch(arrs, dtype), torch.tensor(vlen),
                                 scale=D**-0.5)),
        np.asarray(exp, np.float32), atol=tol, rtol=tol)


def test_plain_k5_per_batch_valid_len():
    jnp, ref_ops, ref_ref = _reference()
    arrs = _qkv(3, 2, 2, 256, 64, seed=1)
    vlen = np.array([64, 128, 256], np.int32)
    got = ops.flash_decode(*_torch(arrs, "float32"), torch.from_numpy(vlen),
                           scale=0.125, block_l=64)
    exp = ref_ref.flash_decode_ref(*map(jnp.asarray, arrs), jnp.asarray(vlen),
                                   scale=0.125)
    np.testing.assert_allclose(_np(got), np.asarray(exp), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_k5_matches_pallas_interpret(dtype):
    jnp, ref_ops, _ = _reference()
    B, Hk, G, L, D, vlen, block = CASES[1]
    arrs = _qkv(B, Hk, G, L, D, seed=2)
    got = ops.flash_decode(*_torch(arrs, dtype), vlen, scale=D**-0.5, block_l=block)
    exp = ref_ops.flash_decode(*(jnp.asarray(a, dtype) for a in arrs), vlen,
                               scale=D**-0.5, block_l=block)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(got), np.asarray(exp, np.float32), atol=tol, rtol=tol)


def test_strided_cache_view_equals_contiguous():
    """The model passes its (B, L, Hk, D) ring cache as a transposed view."""
    q, k, v = _torch(_qkv(2, 3, 2, 40, 32, seed=3), "float32")
    k_ring, v_ring = k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous()
    vl = torch.tensor([7, 40], dtype=torch.int32)
    got = k5.flash_decode(q, k_ring.permute(0, 2, 1, 3), v_ring.permute(0, 2, 1, 3),
                          vl, scale=0.3)
    assert torch.equal(got, k5.flash_decode_plain(q, k, v, vl, scale=0.3))


def test_no_valid_slot_is_uniform_as_the_oracle():
    """valid_len 0 masks every slot: the softmax is uniform over all L."""
    q, k, v = _torch(_qkv(1, 1, 2, 16, 32, seed=4), "float32")
    got = k5.flash_decode(q, k, v, 0, scale=0.2)
    torch.testing.assert_close(got, v.mean(2, keepdim=True).expand_as(got),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("args,match", [
    (((1, 2, 4, 64), (1, 2, 16, 64), (1, 2, 8, 64)), "k/v must be"),
    (((1, 2, 64), (1, 2, 16, 64), (1, 2, 16, 64)), "expected q"),
], ids=["kv_len", "q_rank"])
def test_wrapper_rejects_bad_input(args, match):
    before = k5.launches
    with pytest.raises(ValueError, match=match):
        k5.flash_decode(*(torch.zeros(s) for s in args), 4, scale=1.0)
    with pytest.raises(ValueError, match="valid_len"):
        k5.flash_decode(torch.zeros(2, 1, 1, 8), torch.zeros(2, 1, 4, 8),
                        torch.zeros(2, 1, 4, 8), torch.tensor([1, 2, 3]), scale=1.0)
    assert k5.launches == before


def test_cpu_tensor_takes_the_plain_version_without_counting():
    q, k, v = _torch(_qkv(2, 2, 4, 100, 64, seed=5), "float32")
    before = k5.launches
    out = k5.flash_decode(q, k, v, torch.tensor([3, 100]), scale=0.125)
    assert torch.equal(out, k5.flash_decode_plain(q, k, v, torch.tensor([3, 100]),
                                                  scale=0.125))
    assert k5.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hk,G,L,D,vlen", [c[:6] for c in CASES] + [
    (3, 2, 2, 256, 64, (64, 128, 256)),  # per-batch valid_len
    (8, 4, 8, 640, 64, 640),  # tinyllama-1.1b's serving decode, cache full
    (8, 4, 8, 640, 64, 513),  # ... and part-way
    (2, 2, 3, 100, 32, 0),  # no valid slot; G not a power of two
])
def test_kernel_matches_plain_on_gpu(B, Hk, G, L, D, vlen, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    q, k, v = _torch(_qkv(B, Hk, G, L, D), dtype, "cuda")
    # the cache in the model's (B, L, Hk, D) layout, read through strides
    k = k.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    v = v.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    vl = torch.tensor(vlen, dtype=torch.int32, device="cuda")
    before = k5.launches
    out = k5.flash_decode(q, k, v, vl, scale=D**-0.5)
    again = k5.flash_decode(q, k, v, vl, scale=D**-0.5)
    plain = k5.flash_decode_plain(q, k, v, vl, scale=D**-0.5)
    torch.cuda.synchronize()
    assert k5.launches == before + 2
    assert torch.equal(out, again)
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)
