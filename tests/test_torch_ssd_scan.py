"""K6 (``ssd_scan``) of the port against the reference.

On the CPU the port's wrapper takes its plain version, the port's
``ssd_chunked``; the reference runs its Pallas kernel in interpret mode
through ``repro.kernels.ops``, and its ``models/ssm.py::ssd_chunked`` and
``ssd_reference`` directly. Inputs are made with numpy from a seed and fed
to both. Tolerances are the reference's own: 5e-4 (f32) and 5e-2 (bf16)
for ``test_ssd_scan_allclose``'s cases, 1e-4 against ``ssd_chunked`` (f32
sums in other orders). ``ssd_phases_plain`` is the CUDA kernel's bf16
schedule (CB^T per chunk, chunk states, the state pass, chunk outputs) in
plain torch, optionally with its f32 operands split into bf16 terms as the
tensor cores take them: it equals the chunked scan within 1e-5 in f32,
and with two terms stays within the card's K6 tolerance (1e-4) where one
term does not. Tests marked ``cuda`` hold the CUDA kernel to the plain
version on the card and skip here; they need no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_scan.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops, ref, ssd_scan  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

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


def _as_terms(t, terms):
    """t in float64; with ``terms``, as the sum of that many bf16 roundings,
    each of the remainder of the ones before (the split of an f32 operand
    into bf16 tensor-core operands)."""
    if terms is None:
        return t.double()
    out, rest = torch.zeros(t.shape, dtype=torch.float64), t.float()
    for _ in range(terms):
        part = rest.to(torch.bfloat16).float()
        out, rest = out + part.double(), rest - part
    return out


def ssd_phases_plain(x, dt, A, B_, C_, chunk, h0=None, terms=None):
    """The CUDA kernel's four-phase schedule in plain torch: (1) CB^T per
    (batch, chunk), shared by the heads; (2) each chunk's cumsum, total and
    own state sum_j w_j x_j (x) B_j; (3) the state passed over the chunks
    in order, giving the state entering each; (4) each chunk's output from
    its decayed scores and its entering state. Products sum in float64 and
    round to f32; with ``terms``, the f32 operand of each (w x, the decayed
    scores, the entering state) is first split into that many bf16 terms."""
    Bb, S, nh, hd = x.shape
    ds = B_.shape[-1]
    L = min(chunk, S)
    nc = S // L
    xr = x.reshape(Bb, nc, L, nh, hd).float()
    dtr = dt.reshape(Bb, nc, L, nh).float()
    Br = B_.reshape(Bb, nc, L, ds).float()
    Cr = C_.reshape(Bb, nc, L, ds).float()
    cb = torch.einsum("bcin,bcjn->bcij", Cr.double(), Br.double()).float()  # (1)
    cs = torch.cumsum(dtr * A, dim=2)  # (2): (B, nc, L, nh)
    total = cs[:, :, -1]  # (B, nc, nh)
    wx = (torch.exp(total[:, :, None] - cs) * dtr)[..., None] * xr
    states = torch.einsum("bclhp,bcln->bchpn", _as_terms(wx, terms), Br.double()).float()
    h = (torch.zeros((Bb, nh, hd, ds)) if h0 is None else h0.float())  # (3)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(total[:, c])[:, :, None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B, nc, nh, hd, ds)
    decay = torch.exp(cs[:, :, :, None, :] - cs[:, :, None, :, :])  # (4)
    scores = cb[..., None] * decay * dtr[:, :, None, :, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool))[None, None, :, :, None]
    scores = torch.where(mask, scores, 0.0)
    y = torch.einsum("bcijh,bcjhp->bcihp", _as_terms(scores, terms), xr.double())
    y_in = torch.einsum("bcin,bchpn->bcihp", Cr.double(), _as_terms(h_in, terms))
    y = y + torch.exp(cs).double()[..., None] * y_in
    return y.float().reshape(Bb, S, nh, hd), h


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


PHASE_CHUNKS = [(16, 128), (32, 128), (100, 200)]  # (chunk, S)


@pytest.mark.parametrize("h0", [False, True], ids=["zero_state", "h0_carry"])
@pytest.mark.parametrize("chunk,S", PHASE_CHUNKS)
def test_phase_schedule_equals_chunked_plain(chunk, S, h0):
    """The kernel's four phases give the chunked scan's y and final state."""
    t = {k: torch.from_numpy(v) for k, v in
         _inputs(2, S, 3, 32, 16, seed=chunk, h0=h0).items()}
    args = (t["x"], t["dt"], t["A"], t["B_"], t["C_"], chunk, t.get("h0"))
    y, h = ssd_phases_plain(*args)
    y_p, h_p = ssd_scan.ssd_chunked_plain(*args)
    torch.testing.assert_close(y, y_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, h_p, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h0", [False, True], ids=["zero_state", "h0_carry"])
@pytest.mark.parametrize("chunk,S", PHASE_CHUNKS)
def test_phase_schedule_equals_reference(chunk, S, h0):
    """Against the reference's ``ssd_chunked`` (y and state, 1e-4) and, from
    a zero state, its Pallas kernel in interpret mode (5e-4, its own
    tolerance)."""
    _, ref_ops, ref_ssm = _reference()
    j, t = _cast(_inputs(1, S, 2, 32, 16, seed=S + chunk, h0=h0), "float32")
    names = ("x", "dt", "A", "B_", "C_")
    y, h = ssd_phases_plain(*(t[k] for k in names), chunk, t.get("h0"))
    y_r, h_r = ref_ssm.ssd_chunked(*(j[k] for k in names), chunk, j.get("h0"))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=1e-4, rtol=1e-4)
    if not h0:
        y_k = ref_ops.ssd_scan(*(j[k] for k in names), chunk=chunk)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_k), atol=5e-4, rtol=5e-4)


def _kernel_scale_inputs(B, S, nh, hd, ds, seed):
    """numpy inputs at ``chip_smoke.py``'s K6 scales: x, B, C ~ 0.5 N(0, 1)
    in bf16 (a slice of one conv-output buffer), dt = softplus(N(0, 1) +
    dt_bias) with the model's dt_bias for dt = 0.01, A = -linspace(1, 16)."""
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy((rng.standard_normal((B, S, nh * hd + 2 * ds)) * 0.5)
                           .astype(np.float32)).to(torch.bfloat16)
    x = buf[..., :nh * hd].reshape(B, S, nh, hd)
    B_, C_ = buf[..., nh * hd:nh * hd + ds], buf[..., nh * hd + ds:]
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, nh)).astype(np.float32)) + float(np.log(np.expm1(0.01))))
    return x, dt, -torch.linspace(1.0, 16.0, nh), B_, C_


@pytest.mark.parametrize("h0", [False, True], ids=["zero_state", "h0_carry"])
def test_two_bf16_terms_hold_the_card_tolerance(h0):
    """The tensor-core route's precision, emulated: bf16 x, B, C and the f32
    operands as two bf16 terms stay within K6_TOL (1e-4) of the f32 plain
    version at 4 heads of (64, 128), chunk 256; one term does not (its
    error in y is about 9e-3), which is why the kernel takes two."""
    x, dt, A, B_, C_ = _kernel_scale_inputs(1, 512, 4, 64, 128, seed=16)
    init = (torch.from_numpy(np.random.default_rng(17).standard_normal((1, 4, 64, 128))
                             .astype(np.float32)) if h0 else None)
    y_p, h_p = ssd_scan.ssd_chunked_plain(x, dt, A, B_, C_, 256, init)
    y2, h2 = ssd_phases_plain(x, dt, A, B_, C_, 256, init, terms=2)
    torch.testing.assert_close(y2, y_p, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h2, h_p, atol=1e-4, rtol=1e-4)
    y1, _ = ssd_phases_plain(x, dt, A, B_, C_, 256, init, terms=1)
    assert not torch.allclose(y1, y_p, atol=1e-4, rtol=1e-4)
    assert float((y1 - y_p).abs().max()) > 10 * float((y2 - y_p).abs().max())



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
    (2, 1024, 8, 64, 128, 256, True),  # four chunks: the state pass carries h0
    (2, 512, 4, 64, 128, 64, True),  # chunk 64: eight chunks of one 64-row block
    (1, 600, 2, 64, 64, 300, True),  # bf16 chunk above 256: the FMA kernel
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_raises_under_autograd(cuda, dtype):
    """Once K6 had no backward and raised here; now autograd through the
    kernel (one forward with the entering states, one backward launch)
    gives the plain route's gradients: within 1e-4 of each gradient's max
    in f32, and one bf16 rounding for bf16 x, B and C."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, dt, A, B_, C_ = _model_like(2, 128, 4, 32, 16, getattr(torch, dtype), gen)
    dy = torch.randn((2, 128, 4, 32), generator=gen, device="cuda")

    def grads(fn):
        leaves = [t.detach().requires_grad_() for t in (x, dt, A, B_, C_)]
        y, h = fn(*leaves)
        return torch.autograd.grad((y * dy).sum() + h.square().sum(), leaves)

    f0, b0 = ssd_scan.launches, ssd_scan.bwd_launches
    got = grads(lambda *t: ssd_scan.ssd_scan(*t, 32))
    assert (ssd_scan.launches - f0, ssd_scan.bwd_launches - b0) == (1, 1)
    exp = grads(lambda *t: ssd_scan.ssd_chunked_plain(*t, 32))
    tol = 1e-4 if dtype == "float32" else 2.0 ** -8
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype
        assert float((g.float() - e.float()).abs().max() / e.float().abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_launches_repeat_bitwise(cuda, dtype):
    gen = torch.Generator(device="cuda").manual_seed(7)
    x, dt, A, B_, C_ = _model_like(2, 1024, 8, 64, 128, getattr(torch, dtype), gen)
    h0 = torch.randn((2, 8, 64, 128), generator=gen, device="cuda")
    before = ssd_scan.launches
    y, h = ssd_scan.ssd_scan(x, dt, A, B_, C_, 256, h0)
    y2, h2 = ssd_scan.ssd_scan(x, dt, A, B_, C_, 256, h0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
