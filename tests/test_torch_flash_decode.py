"""K5 (``flash_decode``): the port's wrapper and plain version against the
reference's oracle ``flash_decode_ref`` for every case of
``tests/test_kernels.py::test_flash_decode_allclose`` and
``test_flash_decode_per_batch_valid_len``, and against the Pallas kernel in
interpret mode for one f32 and one bf16 case.

``plan_splits`` is the CUDA kernel's split of the cache over a cluster of
up to 8 CTAs, from L alone; ``_split_merge`` runs that schedule (each
split's softmax by block, the partials merged in rank order) in plain
torch and equals the plain version within 1e-6 in f32.

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
from _torch_threads import _worker_threads  # noqa: E402,F401

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


SPLIT_LS = [1, 15, 16, 17, 100, 128, 129, 640, 643, 1024, 4096, 100_003]


@pytest.mark.parametrize("L", SPLIT_LS)
def test_plan_splits_cover_the_cache_once(L):
    nsplit, split = k5.plan_splits(L)
    assert 1 <= nsplit <= k5.MAX_SPLITS and split >= 1
    bounds = [(r * split, min((r + 1) * split, L)) for r in range(nsplit)]
    assert all(lo < hi for lo, hi in bounds)  # no split is empty
    covered = [s for lo, hi in bounds for s in range(lo, hi)]
    assert covered == list(range(L))  # [0, L) once, in rank order


def test_plan_splits_depend_on_L_alone():
    """The same plan for every L in 1 .. 3000 however often it is asked;
    the serving shape's cache of 640 slots in 8 splits of 80."""
    for L in range(1, 3001):
        nsplit, split = k5.plan_splits(L)
        assert (nsplit, split) == k5.plan_splits.__wrapped__(L)
        assert (nsplit - 1) * split < L <= nsplit * split
    assert k5.plan_splits(640) == (8, 80)
    with pytest.raises(ValueError):
        k5.plan_splits(0)


def _split_merge(q, k, v, valid_len, *, scale):
    """The CUDA kernel's schedule in plain torch: the cache in
    ``plan_splits(L)``'s splits, each split's softmax by block (its max,
    p = exp(s - max) rounded to v's dtype for P.V), and the partials
    (m, l, acc) merged in rank order; a split at or past ``valid_len``
    leaves the sentinel; ``valid_len`` <= 0 is uniform over all L."""
    B, Hk, G, D = q.shape
    L = k.shape[2]
    nsplit, split = k5.plan_splits(L)
    vl = torch.as_tensor(valid_len, dtype=torch.int32).broadcast_to((B,))
    out = torch.empty((B, Hk, G, D), dtype=q.dtype)
    for b in range(B):
        n = int(vl[b])
        none_valid, n = n <= 0, (L if n <= 0 else min(n, L))
        parts = []
        for r in range(nsplit):
            lo, hi = r * split, min((r + 1) * split, n)
            if hi <= lo:
                parts.append((torch.full((Hk, G), k5.NEG_INF), torch.zeros((Hk, G)),
                              torch.zeros((Hk, G, D))))
                continue
            s = torch.einsum("hgd,hld->hgl", q[b].float(), k[b, :, lo:hi].float()) * scale
            if none_valid:
                s = torch.zeros_like(s)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            acc = torch.einsum("hgl,hld->hgd", p.to(v.dtype).float(), v[b, :, lo:hi].float())
            parts.append((m, p.sum(-1), acc))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum, acc = torch.zeros((Hk, G)), torch.zeros((Hk, G, D))
        for m, l, a in parts:  # rank order
            c = torch.exp(m - mx)
            lsum, acc = lsum + l * c, acc + a * c[..., None]
        out[b] = (acc / torch.clamp(lsum, min=1e-30)[..., None]).to(q.dtype)
    return out


VLENS_640 = [640, 0, 1, 40, 80, 81, 513, (1, 80, 81, 160, 639, 640, 0, 333)]


@pytest.mark.parametrize("vlen", VLENS_640, ids=lambda v: f"v{v}")
def test_split_merge_equals_plain(vlen):
    """At the serving shape (8, 4, 8, 640, 64), splits of 80: valid_len of
    all, none, 1, inside the first split, at a split edge and one past it,
    and per row ending in different splits."""
    q, k, v = _torch(_qkv(8, 4, 8, 640, 64, seed=6), "float32")
    vl = torch.tensor(vlen, dtype=torch.int32)
    torch.testing.assert_close(_split_merge(q, k, v, vl, scale=0.125),
                               k5.flash_decode_plain(q, k, v, vl, scale=0.125),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("L,vlen", [(100, 100), (100, 17), (643, 643), (643, 567),
                                    (643, (81, 600))])
def test_split_merge_equals_plain_ragged(L, vlen):
    """L not a multiple of the split (100: seven splits of 16; 643: eight
    of 81), the last split short, valid_len at and inside split edges."""
    q, k, v = _torch(_qkv(2, 2, 4, L, 64, seed=L), "float32")
    vl = torch.tensor(vlen, dtype=torch.int32)
    torch.testing.assert_close(_split_merge(q, k, v, vl, scale=0.125),
                               k5.flash_decode_plain(q, k, v, vl, scale=0.125),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_merge_matches_pallas_interpret(dtype):
    """The split schedule against the reference's Pallas K5 in interpret
    mode, at its tolerance, with the cache cut across splits (L = 1024:
    eight splits of 128; valid_len 700 ends inside the sixth)."""
    jnp, ref_ops, _ = _reference()
    B, Hk, G, L, D, vlen, block = CASES[1]
    arrs = _qkv(B, Hk, G, L, D, seed=7)
    got = _split_merge(*_torch(arrs, dtype), vlen, scale=D**-0.5)
    exp = ref_ops.flash_decode(*(jnp.asarray(a, dtype) for a in arrs), vlen,
                               scale=D**-0.5, block_l=block)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(got), np.asarray(exp, np.float32), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hk,G,L,D,vlen", [c[:6] for c in CASES] + [
    (3, 2, 2, 256, 64, (64, 128, 256)),  # per-batch valid_len
    (8, 4, 8, 640, 64, 640),  # tinyllama-1.1b's serving decode, cache full
    (8, 4, 8, 640, 64, 513),  # ... and part-way
    (2, 2, 3, 100, 32, 0),  # no valid slot; G not a power of two
    (2, 2, 4, 100, 64, 100),  # L not a multiple of 8: seven splits of 16
    (2, 2, 4, 643, 64, 643),  # eight splits of 81, the last one short
    (8, 4, 8, 640, 64, 1),  # one valid slot: seven splits read nothing
    (8, 4, 8, 640, 64, 40),  # inside the first split
    (8, 4, 8, 640, 64, 80),  # exactly at a split edge
    (8, 4, 8, 640, 64, 0),  # no valid slot at the serving shape
    (8, 4, 8, 640, 64, (1, 80, 81, 160, 639, 640, 0, 333)),  # rows end apart
    (1, 2, 16, 4096, 64, 3000),  # splits of 512 in tiles; two head groups
    # gemma3-27b's decode on a window ring of L = W = 1024: sliding rows past
    # the wrap (1024) and not (301), chunked rows at index % W + 1 (905, 1)
    (2, 16, 2, 1024, 128, (1024, 301)),
    (2, 16, 2, 1024, 128, (905, 1)),
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
