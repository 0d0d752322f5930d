"""K6 (``ssd_scan``) of the port against the reference.

On the CPU the port's wrapper takes its plain version, the port's
``ssd_chunked``; the reference runs its Pallas kernel in interpret mode
through ``repro.kernels.ops``, and its ``models/ssm.py::ssd_chunked`` and
``ssd_reference`` directly. Inputs are made with numpy from a seed and fed
to both. Tolerances are the reference's own: 5e-4 (f32) and 5e-2 (bf16)
for ``test_ssd_scan_allclose``'s cases, 1e-4 against ``ssd_chunked`` (f32
sums in other orders). Tests marked ``cuda`` hold the CUDA kernel to the
plain version on the card and skip here; they need no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_scan.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops, ref, ssd_scan  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

CASES = [(2, 128, 3, 32, 16, 32), (1, 256, 2, 64, 128, 64), (1, 64, 4, 16, 8, 64)]


def _inputs(B, S, nh, hd, ds, seed, h0=False):
    """numpy inputs at the reference test's scales: x, B, C ~ N(0, 0.25),
    dt = softplus(N(0, 1)), A = -exp(0.3 N(0, 1))."""
    rng = np.random.default_rng(seed)
    out = {
        "x": (rng.standard_normal((B, S, nh, hd)) * 0.5).astype(np.float32),
        "dt": np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32),
        "A": (-np.exp(rng.standard_normal(nh) * 0.3)).astype(np.float32),
        "B_": (rng.standard_normal((B, S, ds)) * 0.5).astype(np.float32),
        "C_": (rng.standard_normal((B, S, ds)) * 0.5).astype(np.float32),
    }
    if h0:
        out["h0"] = rng.standard_normal((B, nh, hd, ds)).astype(np.float32)
    return out


def _reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as ref_ops
    from repro.models import ssm as ref_ssm

    return jnp, ref_ops, ref_ssm


def _cast(arrs, dtype):
    """Both packages' tensors; x, B_, C_ in ``dtype`` (a name), dt and A in
    f32. bf16 goes to the port bit for bit through ``convert``."""
    jnp, _, _ = _reference()
    names = ("x", "B_", "C_")
    j = {k: jnp.asarray(v).astype(getattr(jnp, dtype) if k in names else jnp.float32)
         for k, v in arrs.items()}
    t = convert.lm_params_from_jax({k: np.asarray(v) for k, v in j.items()}, "cpu")
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,nh,hd,ds,chunk", CASES)
def test_plain_equals_reference_kernel(B, S, nh, hd, ds, chunk, dtype):
    _, ref_ops, _ = _reference()
    j, t = _cast(_inputs(B, S, nh, hd, ds, seed=S + nh), dtype)
    exp = ref_ops.ssd_scan(j["x"], j["dt"], j["A"], j["B_"], j["C_"], chunk=chunk)
    out = ops.ssd_scan(t["x"], t["dt"], t["A"], t["B_"], t["C_"], chunk=chunk)
    assert out.dtype == t["x"].dtype and out.shape == (B, S, nh, hd)
    tol = 5e-2 if dtype == "bfloat16" else 5e-4
    np.testing.assert_allclose(out.float().numpy(), np.asarray(exp, np.float32),
                               atol=tol, rtol=tol)
    # the oracle too
    oracle = ref.ssd_scan_ref(t["x"], t["dt"], t["A"], t["B_"], t["C_"])
    np.testing.assert_allclose(out.float().numpy(), oracle.float().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("h0", [False, True], ids=["zero_state", "h0_carry"])
@pytest.mark.parametrize("chunk", [32, 128])
def test_plain_equals_reference_ssd_chunked_with_state(chunk, h0):
    """y and ``h_final`` within 1e-4 of the reference's ``ssd_chunked``."""
    _, _, ref_ssm = _reference()
    arrs = _inputs(2, 128, 2, 32, 16, seed=chunk, h0=h0)
    j, t = _cast(arrs, "float32")
    args = ("x", "dt", "A", "B_", "C_")
    y_r, h_r = ref_ssm.ssd_chunked(*(j[k] for k in args), chunk, j.get("h0"))
    y, h = ssd_scan.ssd_scan(*(t[k] for k in args), chunk, t.get("h0"))
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=1e-4, rtol=1e-4)
    y2, h2 = ssm.ssd_reference(*(t[k] for k in args), t.get("h0"))
    y2_r, h2_r = ref_ssm.ssd_reference(*(j[k] for k in args), j.get("h0"))
    np.testing.assert_allclose(y2.numpy(), np.asarray(y2_r), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h2_r), atol=1e-4, rtol=1e-4)


def test_plain_reads_strided_slices():
    """x, B_ and C_ as slices of one conv-output-shaped buffer, as
    ``ssm_fwd`` hands them over: the same result as contiguous copies."""
    rng = np.random.default_rng(3)
    B, S, nh, hd, ds = 2, 64, 2, 32, 16
    buf = torch.from_numpy(rng.standard_normal((B, S, nh * hd + 2 * ds)).astype(np.float32))
    x = buf[..., :nh * hd].reshape(B, S, nh, hd)
    B_, C_ = buf[..., nh * hd:nh * hd + ds], buf[..., nh * hd + ds:]
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32))
    A = -torch.arange(1.0, nh + 1)
    assert not x.is_contiguous() and not B_.is_contiguous()
    y, h = ssd_scan.ssd_scan(x, dt, A, B_, C_, 16)
    y2, h2 = ssd_scan.ssd_scan(x.contiguous(), dt, A, B_.contiguous(), C_.contiguous(), 16)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_wrapper_rejects_what_it_does_not_take():
    t = {k: torch.from_numpy(v) for k, v in _inputs(1, 48, 2, 32, 16, seed=0).items()}
    with pytest.raises(ValueError, match="divide"):
        ssd_scan.ssd_scan(t["x"], t["dt"], t["A"], t["B_"], t["C_"], 32)
    with pytest.raises(ValueError, match="match"):
        ssd_scan.ssd_scan(t["x"], t["dt"][:, :, :1], t["A"], t["B_"], t["C_"], 16)
    with pytest.raises(ValueError, match="h0"):
        ssd_scan.ssd_scan(t["x"], t["dt"], t["A"], t["B_"], t["C_"], 16,
                          torch.zeros(1, 2, 32, 8))


def test_plain_is_differentiable_on_the_cpu():
    t = {k: torch.from_numpy(v) for k, v in _inputs(1, 32, 2, 32, 16, seed=1).items()}
    x = t["x"].requires_grad_()
    y, h = ssd_scan.ssd_scan(x, t["dt"], t["A"], t["B_"], t["C_"], 16)
    (y.sum() + h.sum()).backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


# --- the CUDA kernel against its plain version (skip without a GPU) ------------


def _model_like(B, S, nh, hd, ds, dtype, gen, strided=True):
    """Inputs at the model's scales on the card: x, B_, C_ sliced from one
    conv-output-shaped (B, S, nh*hd + 2 ds) buffer (or contiguous), dt =
    softplus(N(0, 1) + dt_bias), A = -linspace(1, 16)."""
    di = nh * hd
    buf = (torch.randn((B, S, di + 2 * ds), generator=gen, device="cuda") * 0.5).to(dtype)
    x = buf[..., :di].reshape(B, S, nh, hd)
    B_, C_ = buf[..., di:di + ds], buf[..., di + ds:]
    if not strided:
        x, B_, C_ = x.contiguous(), B_.contiguous(), C_.contiguous()
    dt_bias = float(np.log(np.expm1(0.01)))
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, nh), generator=gen, device="cuda") + dt_bias)
    A = -torch.linspace(1.0, 16.0, nh, device="cuda")
    return x, dt, A, B_, C_


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain version's einsums in full f32, as the kernel's FMAs
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,strided", [
    (4, 2048, 32, 64, 128, 256, True),  # mamba2-370m's prefill
    (1, 512, 4, 64, 128, 256, False),
    (2, 128, 3, 32, 16, 32, True),
    (2, 64, 8, 32, 16, 16, True),  # the reduced mamba2
    (1, 200, 2, 64, 64, 100, False),  # L not a multiple of the 64-row block
])
def test_kernel_equals_plain(cuda, B, S, nh, hd, ds, chunk, strided, dtype):
    gen = torch.Generator(device="cuda").manual_seed(S + nh)
    x, dt, A, B_, C_ = _model_like(B, S, nh, hd, ds, getattr(torch, dtype), gen, strided)
    h0 = torch.randn((B, nh, hd, ds), generator=gen, device="cuda")
    for init in (None, h0):
        y, h = ssd_scan.ssd_scan(x, dt, A, B_, C_, chunk, init)
        y_p, h_p = ssd_scan.ssd_chunked_plain(x, dt, A, B_, C_, chunk, init)
        torch.cuda.synchronize()
        assert y.dtype == h.dtype == torch.float32
        torch.testing.assert_close(y, y_p, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(h, h_p, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_raises_under_autograd(cuda):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, dt, A, B_, C_ = _model_like(1, 64, 2, 32, 16, torch.float32, gen)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan.ssd_scan(x.detach().requires_grad_(), dt, A, B_, C_, 16)
