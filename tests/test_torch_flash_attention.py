"""K4 (``flash_attention``): the port's wrapper and plain version against the
reference's oracle ``flash_attention_ref`` for every case of
``tests/test_kernels.py::test_flash_attention_allclose`` and
``test_flash_attention_uneven_blocks``, and against the Pallas kernel in
interpret mode for one f32 and one bf16 case.

Tolerances are the reference's own: 2e-5 in f32, 2e-2 in bf16 (bf16
rounds the scores and the output at other places in the two frameworks).
On a card, the CUDA kernel is held against the plain version at the same
tolerances (the reference is imported inside the tests that use it, so the
file also runs where JAX is absent):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_attention.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

CASES = [
    (1, 2, 2, 256, 64, "full", 0),
    (2, 1, 4, 512, 32, "full", 0),
    (1, 2, 1, 512, 128, "sliding", 128),
    (1, 1, 2, 512, 64, "chunked", 128),
    (1, 4, 8, 256, 64, "full", 0),  # llama-like GQA block
]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _reference():
    """(jax.numpy, repro.kernels.ops, repro.kernels.ref)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as ref_ref

    return jnp, ref_ops, ref_ref


def _qkv(B, Hk, G, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hk, G, S, D)).astype(np.float32),
            rng.standard_normal((B, Hk, S, D)).astype(np.float32),
            rng.standard_normal((B, Hk, S, D)).astype(np.float32))


def _torch(arrs, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in arrs]


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hk,G,S,D,kind,window", CASES)
def test_plain_k4_matches_oracle(B, Hk, G, S, D, kind, window, dtype):
    jnp, _, ref_ref = _reference()
    arrs = _qkv(B, Hk, G, S, D)
    scale = D**-0.5
    got = ops.flash_attention(*_torch(arrs, dtype), scale=scale, kind=kind,
                              window=window, block_q=128, block_k=128)
    exp = ref_ref.flash_attention_ref(*(jnp.asarray(a, dtype) for a in arrs),
                                      scale=scale, kind=kind, window=window)
    assert got.shape == (B, Hk, G, S, D) and got.dtype == getattr(torch, dtype)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(got), np.asarray(exp, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(ref.flash_attention_ref(*_torch(arrs, dtype), scale=scale, kind=kind,
                                    window=window)),
        np.asarray(exp, np.float32), atol=tol, rtol=tol)


def test_plain_k4_uneven_blocks():
    jnp, _, ref_ref = _reference()
    arrs = _qkv(1, 2, 2, 384, 64, seed=1)
    got = ops.flash_attention(*_torch(arrs, "float32"), scale=0.125, block_q=128,
                              block_k=384)
    exp = ref_ref.flash_attention_ref(*map(jnp.asarray, arrs), scale=0.125)
    np.testing.assert_allclose(_np(got), np.asarray(exp), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_k4_matches_pallas_interpret(dtype):
    """The Pallas kernel itself, as the reference's tests run it on the CPU."""
    jnp, ref_ops, _ = _reference()
    B, Hk, G, S, D, kind, window = CASES[0]
    arrs = _qkv(B, Hk, G, S, D, seed=2)
    got = ops.flash_attention(*_torch(arrs, dtype), scale=D**-0.5, block_q=128,
                              block_k=128)
    exp = ref_ops.flash_attention(*(jnp.asarray(a, dtype) for a in arrs),
                                  scale=D**-0.5, block_q=128, block_k=128)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(got), np.asarray(exp, np.float32), atol=tol, rtol=tol)


def test_plain_k4_is_differentiable_on_cpu():
    """On the CPU a gradient goes through ``Attention`` and its plain
    versions (on the card, through the forward and backward kernels)."""
    q, k, v = (t.requires_grad_() for t in _torch(_qkv(1, 1, 2, 128, 32), "float32"))
    out = k4.flash_attention(q, k, v, scale=0.2)
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize("shapes,kw,match", [
    (((1, 2, 2, 256, 64), (1, 2, 256, 64), (1, 2, 128, 64)), {}, "k/v must be"),
    (((1, 2, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64)), {}, "expected q"),
    (((1, 1, 1, 384, 32), (1, 1, 384, 32), (1, 1, 384, 32)), {"block_k": 256},
     "divide"),
    (((1, 1, 1, 128, 32), (1, 1, 128, 32), (1, 1, 128, 32)), {"kind": "local"},
     "kind"),
], ids=["kv_len", "q_rank", "blocks", "kind"])
def test_wrapper_rejects_bad_input(shapes, kw, match):
    before = k4.launches
    with pytest.raises(ValueError, match=match):
        k4.flash_attention(*(torch.zeros(s) for s in shapes), scale=1.0, **kw)
    assert k4.launches == before


def test_cpu_tensor_takes_the_plain_version_without_counting():
    q, k, v = _torch(_qkv(1, 2, 4, 128, 64, seed=3), "float32")
    before = k4.launches
    out = k4.flash_attention(q, k, v, scale=0.125, kind="sliding", window=32)
    assert torch.equal(out, k4.flash_attention_plain(q, k, v, scale=0.125,
                                                     kind="sliding", window=32))
    assert k4.launches == before


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hk,G,S,D,kind,window", CASES + [
    (1, 2, 2, 384, 64, "full", 0), (1, 1, 5, 200, 64, "full", 0),
    (4, 4, 8, 2048, 64, "full", 0),  # tinyllama-1.1b's serving prefill
    (2, 16, 2, 2048, 128, "sliding", 1024),  # gemma3-27b's local layers' prefill
])
def test_kernel_matches_plain_on_gpu(B, Hk, G, S, D, kind, window, dtype):
    _gpu()
    q, k, v = _torch(_qkv(B, Hk, G, S, D), dtype, "cuda")
    before = k4.launches
    out = k4.flash_attention(q, k, v, scale=D**-0.5, kind=kind, window=window,
                             block_q=S, block_k=S)
    again = k4.flash_attention(q, k, v, scale=D**-0.5, kind=kind, window=window,
                               block_q=S, block_k=S)
    plain = k4.flash_attention_plain(q, k, v, scale=D**-0.5, kind=kind, window=window)
    torch.cuda.synchronize()
    assert k4.launches == before + 2
    assert torch.equal(out, again)
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_kernel_raises_under_autograd_on_gpu():
    """Under autograd the kernel runs forward (with lse) and backward: one
    counted launch each, no plain version, gradients equal to autograd's
    through the plain route (f32 1e-4, bf16 2e-2, relative to each
    gradient's max). The name is the one the test had when the kernel
    raised there."""
    _gpu()
    for dtype in DTYPES:
        _autograd_matches_plain(dtype)


def _autograd_matches_plain(dtype):
    arrs = _qkv(1, 2, 4, 256, 64)
    q, k, v = (t.requires_grad_() for t in _torch(arrs, dtype, "cuda"))
    dout = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 2, 4, 256, 64)).astype(np.float32)).to("cuda", getattr(torch, dtype))
    before, bwd_before = k4.launches, k4.bwd_launches
    out = k4.flash_attention(q, k, v, scale=0.125, kind="sliding", window=100)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (k4.launches, k4.bwd_launches) == (before + 1, bwd_before + 1)
    qp, kp, vp = (t.detach().requires_grad_() for t in (q, k, v))
    plain = torch.autograd.grad(k4.flash_attention_plain(
        qp, kp, vp, scale=0.125, kind="sliding", window=100), (qp, kp, vp), dout)
    assert (k4.launches, k4.bwd_launches) == (before + 1, bwd_before + 1)
    for name, g, p in zip("qkv", grads, plain):
        assert g.dtype == p.dtype and g.shape == p.shape
        _assert_rel(g, p, _bwd_tol(dtype), f"d{name}")


def _bwd_tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-4


def _assert_rel(got, exp, tol, name):
    """max |got - exp| within ``tol`` of max |exp| (a gradient's scale)."""
    err = float((got.float() - exp.float()).abs().max())
    scale = float(exp.float().abs().max())
    assert err <= tol * scale, f"{name}: max abs err {err} vs max {scale} (tol {tol})"


def _bwd_inputs(B, Hk, G, S, D, dtype, layout, seed):
    dt = getattr(torch, dtype)
    if layout == "model":
        q, k, v = _model_layout(B, Hk, G, S, D, dtype, seed=seed)
    else:
        q, k, v = _torch(_qkv(B, Hk, G, S, D, seed=seed), dtype, "cuda")
    dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (B, S, Hk, G, D)).astype(np.float32)).to("cuda", dt).permute(0, 2, 3, 1, 4)
    return q, k, v, dout


BWD_CASES = [(*c, "float32", "contiguous") for c in CASES] + [
    (1, 2, G, 384, D, "full", 0, "bfloat16", "model")
    for D in (32, 64, 128) for G in (1, 2, 4, 5, 8, 16)
] + [(1, 2, 4, 200, 64, "full", 0, "bfloat16", "model"),
      (4, 4, 8, 2048, 64, "full", 0, "bfloat16", "model"),  # tinyllama's training shape
      (2, 16, 2, 2048, 128, "sliding", 1024, "bfloat16", "model"),  # gemma3's,
      (2, 16, 2, 2048, 128, "sliding", 1024, "float32", "contiguous")] + [  # f32 too
    (1, 2, G, S, D, kind, w, "bfloat16", "model")
    for kind in ("sliding", "chunked") for w in (100, 128)
    for G, S, D in ((4, 384, 64), (5, 200, 32), (8, 2048, 128))
] + [(1, 1, 3, 200, 32, kind, 100, "float32", "contiguous")
     for kind in ("sliding", "chunked")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hk,G,S,D,kind,window,dtype,layout", BWD_CASES)
def test_backward_kernel_matches_plain_on_gpu(B, Hk, G, S, D, kind, window, dtype,
                                              layout):
    """K4's backward kernel (given the kernel forward's ``out`` and ``lse``)
    against ``flash_attention_bwd_plain`` given the same ``out`` and the
    plain log-sum-exp, so a wrong kernel lse shows in the gradients too
    (f32 1e-4, bf16 2e-2, relative to each gradient's max); the kernel's
    lse against the plain one of the inputs in f32 (atol 1e-4, rtol 1e-5);
    two launches bitwise equal; the forward's output bitwise the same with
    and without lse."""
    _gpu()
    q, k, v, dout = _bwd_inputs(B, Hk, G, S, D, dtype, layout, seed=S + G + D)
    kw = dict(scale=D**-0.5, kind=kind, window=window)
    out, lse = k4.flash_attention_with_lse(q, k, v, **kw)
    assert torch.equal(out, k4.flash_attention(q, k, v, **kw, block_q=S, block_k=S))
    # the kernels' scores are f32 sums of exact products; the plain bf16
    # einsum rounds them to bf16, so the lse is held against f32 inputs
    _, lse_plain = k4.flash_attention_plain(q.float(), k.float(), v.float(), **kw,
                                            return_lse=True)
    torch.testing.assert_close(lse, lse_plain, atol=1e-4, rtol=1e-5)
    before = k4.bwd_launches
    grads = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    plain = k4.flash_attention_bwd_plain(q, k, v, out, lse_plain, dout, **kw)
    torch.cuda.synchronize()
    assert k4.bwd_launches == before + 2
    for name, g, a, p in zip("qkv", grads, again, plain):
        assert g.dtype == p.dtype and g.shape == p.shape, name
        assert torch.equal(g, a), f"d{name}: launches differ bitwise"
        _assert_rel(g, p, _bwd_tol(dtype), f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_vmap_grad_through_the_kernels_equals_a_loop_on_gpu(dtype):
    """``torch.func.vmap(grad(...))`` over a cohort of 4, as the FL clients
    train: each Function's vmap rule folds the cohort into B, and the
    gradients equal four single calls bitwise."""
    _gpu()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 1, 2, 4, 256, 64) if i == 0 else
                                                    (4, 1, 2, 256, 64)).astype(np.float32))
               .to("cuda", dt) for i in range(3))

    def loss(q_, k_, v_):
        return k4.flash_attention(q_, k_, v_, scale=0.125).float().square().sum()

    grad = torch.func.grad(loss, argnums=(0, 1, 2))
    before = k4.bwd_launches
    batched = torch.func.vmap(grad)(q, k, v)
    assert k4.bwd_launches == before + 1
    for i in range(4):
        for b, s in zip(batched, grad(q[i], k[i], v[i])):
            assert torch.equal(b[i], s)


# --- the bf16 wgmma kernel: CTA packing and host-side rules -----------------

@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 7, 8, 16, 33, 64, 65, 100, 128])
def test_tile_rows_packs_whole_positions(G):
    """A bf16 CTA holds 128 // G whole positions of all G heads: at most 128
    rows, and more than 64, so each consumer warpgroup has real rows."""
    P, rows = k4.tile_rows(G)
    assert P == 128 // G and rows == P * G
    assert 64 < rows <= 128 and 128 - rows < G


@pytest.mark.parametrize("G", [0, 129])
def test_tile_rows_rejects_g_outside_1_to_128(G):
    with pytest.raises(ValueError, match="1 <= G <= 128"):
        k4.tile_rows(G)


@pytest.mark.parametrize("dtype,G,scale,match", [
    ("bfloat16", 129, 0.125, "1 <= G <= 128"),
    ("bfloat16", 2, 0.0, "positive scale"),
    ("bfloat16", 2, -0.125, "positive scale"),
    ("float32", 129, 0.125, None),  # the FMA route takes any G
    ("float32", 2, -0.125, None),  # ... and any scale
], ids=["bf16_g129", "bf16_zero_scale", "bf16_negative_scale", "f32_g129", "f32_negative"])
def test_kernel_rules_checked_on_the_host(dtype, G, scale, match):
    q, k, v = _torch(_qkv(1, 1, G, 16, 32), dtype)
    if match is None:
        k4._check_kernel(q, k, v, scale)
    else:
        with pytest.raises(ValueError, match=match):
            k4._check_kernel(q, k, v, scale)


def _model_layout(B, Hk, G, S, D, dtype, seed=0):
    """q, k, v on the card as the model hands them over: q a view of
    (B, S, H, D), k and v views of (B, S, Hk, D)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, S, Hk * G, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hk, D)).astype(np.float32))
            for _ in range(2))
    dt = getattr(torch, dtype)
    q = q.to("cuda", dt).view(B, S, Hk, G, D).permute(0, 2, 3, 1, 4)
    return q, *(t.to("cuda", dt).permute(0, 2, 1, 3) for t in (k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hk,G,S,D,kind,window", [
    (1, 2, G, 384, D, "full", 0) for D in (32, 64, 128) for G in (1, 2, 4, 5, 8, 16)
] + [
    (1, 2, 4, S, 64, "full", 0) for S in (200, 2048)
] + [
    (1, 2, G, S, D, kind, w) for kind in ("sliding", "chunked") for w in (100, 128)
    for G, S, D in ((4, 384, 64), (5, 200, 32), (8, 2048, 128))
])
def test_wgmma_kernel_in_the_model_layout_on_gpu(B, Hk, G, S, D, kind, window):
    """The bf16 kernel against its plain version on q, k, v as the model
    passes them (strided views), two launches bitwise equal."""
    _gpu()
    q, k, v = _model_layout(B, Hk, G, S, D, "bfloat16", seed=S + G + D)
    kw = dict(scale=D**-0.5, kind=kind, window=window, block_q=S, block_k=S)
    before = k4.launches
    out = k4.flash_attention(q, k, v, **kw)
    again = k4.flash_attention(q, k, v, **kw)
    plain = k4.flash_attention_plain(q, k, v, scale=D**-0.5, kind=kind, window=window)
    torch.cuda.synchronize()
    assert k4.launches == before + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), plain.float(), atol=2e-2, rtol=2e-2)
