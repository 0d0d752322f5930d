"""K6's backward (``kernels/ssd_scan.py``): the plain backward
``ssd_chunked_bwd_plain``, the autograd Functions ``SSDScan``/``SSDScanBwd``
and ``emulate_bwd``, the backward kernels' schedule replayed on CPU
tensors.

The plain backward is held to ``torch.autograd`` of ``ssd_chunked_plain``
(1e-5 of each gradient's max in f32, 1e-12 in float64) and to ``jax.vjp`` of
the reference's ``ssd_chunked`` (1e-4, the f32 tolerance of K6), on the same
numpy inputs, where the reference is finite. Where the decay across a chunk
overflows the reference's unmasked ``exp``, ``jax.grad`` of its
``ssd_chunked`` gives NaN in ddt and dA; the plain backward takes ``exp`` of
masked differences only and equals autograd of the step recurrence
``ssd_reference`` in float64. The emulation holds the card's tolerances
(BWD_TOL) against the plain backward. Tests marked ``cuda`` hold the kernel
to the plain backward on the card and skip here; they need no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_scan_bwd.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

GRADS = ("dx", "ddt", "dA", "dB", "dC", "dh0")
# the kernel against the plain backward, of each gradient's max: f32 inputs;
# f32 outputs of bf16 inputs; outputs written in bf16 (one rounding, 2^-8 of
# the value at most, and the f32 outputs' share)
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-3, "bf16_out": 2.0 ** -8 + 1e-3}
CHUNKS = [(16, 64), (32, 128), (100, 200), (256, 512)]  # (chunk, S)
# dt scaled so that sum dt |A| over a 256-step chunk (about 25) stays inside
# exp's f32 range: where it does not, autograd of the plain forward and the
# reference's jax.grad are NaN (test_reference_grad_is_nan_where_the_port_is_finite)
FINITE_DT = 0.1


def _inputs(B, S, nh, hd, ds, seed, dt_scale=1.0):
    """numpy inputs at the reference test's scales: x, B, C ~ N(0, 0.25),
    dt = softplus(N(0, 1)), A = -exp(0.3 N(0, 1)); h0, dy and dh_final
    ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {
        "x": (rng.standard_normal((B, S, nh, hd)) * 0.5).astype(f),
        "dt": (np.log1p(np.exp(rng.standard_normal((B, S, nh)))) * dt_scale).astype(f),
        "A": (-np.exp(rng.standard_normal(nh) * 0.3)).astype(f),
        "B_": (rng.standard_normal((B, S, ds)) * 0.5).astype(f),
        "C_": (rng.standard_normal((B, S, ds)) * 0.5).astype(f),
        "h0": rng.standard_normal((B, nh, hd, ds)).astype(f),
        "dy": rng.standard_normal((B, S, nh, hd)).astype(f),
        "dhf": rng.standard_normal((B, nh, hd, ds)).astype(f),
    }


ARGS = ("x", "dt", "A", "B_", "C_")


def _torch(arrs, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in arrs.items()}


def _rel(got, exp):
    """max |got - exp| over max |exp|: a gradient's error at its own scale."""
    got, exp = (t.double() if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
                .double() for t in (got, exp))
    return float((got - exp).abs().max() / exp.abs().max())


def _plain_bwd(t, chunk, h0, dhf):
    """The plain backward of the plain forward at ``t``'s inputs."""
    args = [t[k] for k in ARGS]
    _, _, h_in = ssd_scan.ssd_chunked_plain(*args, chunk, t["h0"] if h0 else None,
                                            return_h_in=True)
    return ssd_scan.ssd_chunked_bwd_plain(*args, chunk, h_in, t["dy"],
                                          t["dhf"] if dhf else None)


def _autograd(fn, t, h0, dhf):
    """torch.autograd's gradients of <y, dy> + <h_final, dh_final> through
    ``fn(x, dt, A, B_, C_, h0)``; dh0 None without h0."""
    leaves = [t[k].clone().requires_grad_() for k in ARGS]
    init = t["h0"].clone().requires_grad_() if h0 else None
    y, h = fn(*leaves, init)
    loss = (y * t["dy"]).sum() + ((h * t["dhf"]).sum() if dhf else 0)
    grads = torch.autograd.grad(loss, leaves + ([init] if h0 else []))
    return tuple(grads) + (() if h0 else (None,))


@pytest.mark.parametrize("h0,dhf", [(False, False), (True, True)], ids=["bare", "h0_dhf"])
@pytest.mark.parametrize("chunk,S", CHUNKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_plain_bwd_equals_autograd_of_plain(chunk, S, h0, dhf, dtype):
    t = _torch(_inputs(1, S, 2, 16, 8, seed=chunk, dt_scale=FINITE_DT), dtype)
    got = _plain_bwd(t, chunk, h0, dhf)
    exp = _autograd(lambda *a: ssd_scan.ssd_chunked_plain(*a[:5], chunk, a[5]), t, h0, dhf)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for name, g, e in zip(GRADS, got, exp):
        if e is not None:
            assert g.dtype == dtype and g.shape == e.shape, name
            assert _rel(g, e) < tol, (name, _rel(g, e))


def _reference():
    jax = pytest.importorskip("jax")
    from repro.models import ssm as ref_ssm

    return jax, ref_ssm


@pytest.mark.parametrize("h0,dhf", [(False, False), (True, True)], ids=["bare", "h0_dhf"])
@pytest.mark.parametrize("chunk,S", CHUNKS)
def test_plain_bwd_equals_jax_vjp_of_reference(chunk, S, h0, dhf):
    """The same numpy inputs through ``jax.vjp`` of the reference's
    ``ssd_chunked``: every gradient within 1e-4 of its max (all finite
    here: sum dt |A| over a chunk stays below the overflow)."""
    jax, ref_ssm = _reference()
    arrs = _inputs(1, S, 2, 16, 8, seed=chunk, dt_scale=FINITE_DT)
    j = {k: jax.numpy.asarray(v) for k, v in arrs.items()}
    args = tuple(j[k] for k in ARGS) + ((j["h0"],) if h0 else ())
    (_, h_r), vjp = jax.vjp(lambda *a: ref_ssm.ssd_chunked(*a[:5], chunk, *a[5:]), *args)
    ct = (j["dy"], j["dhf"] if dhf else jax.numpy.zeros_like(h_r))
    exp = vjp(ct)
    got = _plain_bwd(_torch(arrs), chunk, h0, dhf)
    for name, g, e in zip(GRADS, got, exp):
        assert np.isfinite(np.asarray(e)).all(), name
        assert _rel(g, e) < 1e-4, (name, _rel(g, e))


def _decay_inputs(dt_value, hd=8, ds=4):
    """chunk 32, A = (-1, -16), a constant dt: sum dt |A| over a chunk of
    the second head is 32 * 16 * dt (154 at dt 0.3, past exp's f32 range
    of about 88)."""
    arrs = _inputs(1, 64, 2, hd, ds, seed=5)
    arrs["A"] = np.array([-1.0, -16.0], np.float32)
    arrs["dt"] = np.full_like(arrs["dt"], dt_value)
    return arrs


@pytest.mark.parametrize("dt_value", [0.01, 0.3, 1.0])
def test_plain_bwd_equals_step_recurrence_in_f64(dt_value):
    """Against autograd of the step recurrence ``ssd_reference`` (every
    factor <= 1) in float64: equal, and finite at every decay."""
    t = _torch(_decay_inputs(dt_value), torch.float64)
    got = _plain_bwd(t, 32, True, True)
    exp = _autograd(lambda *a: ssm.ssd_reference(*a), t, True, True)
    for name, g, e in zip(GRADS, got, exp):
        assert bool(torch.isfinite(g).all()) and bool(torch.isfinite(e).all()), name
        assert _rel(g, e) < 1e-12, (name, _rel(g, e))


@pytest.mark.parametrize("dt_value", [0.3, 1.0])
def test_reference_grad_is_nan_where_the_port_is_finite(dt_value):
    """The reference's limit (ROADMAP queue 3): ``jax.grad`` of its
    ``ssd_chunked`` masks after ``exp``, so where the decay overflows its
    ddt and dA come out NaN. The port's plain backward on the same inputs
    is finite and, in f32, within 1e-4 of the f64 step recurrence."""
    jax, ref_ssm = _reference()
    arrs = _decay_inputs(dt_value)
    j = {k: jax.numpy.asarray(v) for k, v in arrs.items()}

    def loss(x, dt, A, B_, C_):
        y, h = ref_ssm.ssd_chunked(x, dt, A, B_, C_, 32)
        return (y * j["dy"]).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(j[k] for k in ARGS))
    assert np.isnan(np.asarray(ref[1])).any() and np.isnan(np.asarray(ref[2])[1])
    got = _plain_bwd(_torch(arrs), 32, False, False)
    exp = _autograd(lambda *a: ssm.ssd_reference(*a[:5]), _torch(arrs, torch.float64),
                    False, False)
    for name, g, e in zip(GRADS[:5], got, exp):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, e) < 1e-4, (name, _rel(g, e))


def test_bwd_wrapper_rejects_what_it_does_not_take():
    t = _torch(_inputs(1, 64, 2, 32, 16, seed=2))
    args = [t[k] for k in ARGS]
    _, _, h_in = ssd_scan.ssd_scan_with_h_in(*args, 16)
    assert tuple(h_in.shape) == (1, 2, 4, 32, 16)
    with pytest.raises(ValueError, match="h_in, dy and dh_final"):
        ssd_scan.ssd_scan_bwd(*args, 32, h_in, t["dy"])  # h_in of chunks of 16
    with pytest.raises(ValueError, match="h_in, dy and dh_final"):
        ssd_scan.ssd_scan_bwd(*args, 16, h_in, t["dy"][:, :32])
    with pytest.raises(ValueError, match="h_in, dy and dh_final"):
        ssd_scan.ssd_scan_bwd(*args, 16, h_in, t["dy"], t["dhf"][:, :1])
    grads = ssd_scan.ssd_scan_bwd(*args, 16, h_in, t["dy"], t["dhf"])
    assert [tuple(g.shape) for g in grads] == [
        (1, 64, 2, 32), (1, 64, 2), (1, 2), (1, 64, 16), (1, 64, 16), (1, 2, 32, 16)]


# --- the Functions on the CPU (their plain routes) -----------------------------


@pytest.mark.parametrize("h0", [False, True], ids=["zero_state", "h0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_functions_equal_autograd_of_plain(h0, dtype, monkeypatch):
    """``ssd_scan`` under autograd goes through ``SSDScan``: one plain
    forward with the entering states, one plain backward, gradients equal
    to autograd of the plain forward (x, B and C's in their dtype)."""
    arrs = _inputs(2, 64, 3, 32, 16, seed=11)
    t = _torch(arrs)
    for k in ("x", "B_", "C_"):
        t[k] = t[k].to(dtype)
    calls = []
    bwd = ssd_scan.ssd_chunked_bwd_plain
    monkeypatch.setattr(ssd_scan, "ssd_chunked_bwd_plain",
                        lambda *a, **kw: calls.append(1) or bwd(*a, **kw))
    got = _autograd(lambda *a: ssd_scan.ssd_scan(*a[:5], 16, a[5]), t, h0, True)
    assert len(calls) == 1
    exp = _autograd(lambda *a: ssd_scan.ssd_chunked_plain(*a[:5], 16, a[5]), t, h0, True)
    for name, g, e in zip(GRADS, got, exp):
        if e is not None:
            assert g.dtype == e.dtype, name
            tol = 1e-5 if g.dtype == torch.float32 else BWD_TOL["bf16_out"]
            assert _rel(g, e) < tol, (name, _rel(g, e))
    with torch.no_grad():  # no gradient wanted: the plain forward, no Function
        y, _ = ssd_scan.ssd_scan(*(t[k] for k in ARGS), 16)
    assert y.grad_fn is None


@pytest.mark.parametrize("a_dim", [0, None], ids=["A_per_client", "A_shared"])
def test_vmap_grad_equals_a_loop_over_clients(a_dim, monkeypatch):
    """``vmap(grad)`` over a cohort of 3, as the FL clients train: one
    folded backward for the cohort, each client's gradients equal to its
    own ``grad`` call. With A vmapped, each client's A reaches its rows."""
    n = 3
    arrs = [_inputs(2, 64, 3, 32, 16, seed=20 + i) for i in range(n)]
    stack = {k: torch.stack([torch.from_numpy(a[k]) for a in arrs]) for k in arrs[0]}
    if a_dim is None:
        stack["A"] = stack["A"][0]

    def loss(x, dt, A, B_, C_, h0, dy, dhf):
        y, h = ssd_scan.ssd_scan(x, dt, A, B_, C_, 16, h0)
        return (y * dy).sum() + (h * dhf).sum()

    grad = torch.func.grad(loss, argnums=(0, 1, 2, 3, 4, 5))
    calls = []
    bwd = ssd_scan.ssd_chunked_bwd_plain
    monkeypatch.setattr(ssd_scan, "ssd_chunked_bwd_plain",
                        lambda *a, **kw: calls.append(a[0].shape[0]) or bwd(*a, **kw))
    keys = ARGS + ("h0", "dy", "dhf")
    dims = tuple(a_dim if k == "A" else 0 for k in keys)
    batched = torch.func.vmap(grad, in_dims=dims)(*(stack[k] for k in keys))
    assert calls == [n * 2]  # one backward, the cohort folded into its batch
    for i in range(n):
        one = grad(*(stack[k] if (k == "A" and a_dim is None) else stack[k][i] for k in keys))
        for name, b, s in zip(GRADS, batched, one):
            torch.testing.assert_close(b[i], s, rtol=1e-5, atol=1e-6, msg=name)


# --- the kernel's schedule on CPU tensors --------------------------------------

BLK = 64  # rows of a block in the chunk kernel


def _terms(t, n):
    """t's f32 values as n bf16 terms, each the remainder of the ones before
    rounded, in float64 (how the tensor-core route feeds an f32 operand)."""
    out, rest = [], t.float()
    for _ in range(n):
        part = rest.to(torch.bfloat16).float()
        out.append(part.double())
        rest = rest - part
    return out


def _mm(eq, a, b, terms, exact):
    """``einsum(eq, a, b)`` as the chunk kernel's route computes it: f32
    (``terms`` None: the FMA kernel), or on the tensor cores with the f32
    operand(s) as ``terms`` bf16 terms, products summed in float64 and
    rounded to f32. ``exact`` names the operand that is an exact bf16 input
    ("a", "b"); None: both are f32, and the products of term pairs (s, t)
    with s + t < terms are taken (hi hi, hi lo, lo hi for two)."""
    if terms is None:
        return torch.einsum(eq, a.float(), b.float())
    if exact == "a":
        return sum(torch.einsum(eq, a.double(), t) for t in _terms(b, terms)).float()
    if exact == "b":
        return sum(torch.einsum(eq, t, b.double()) for t in _terms(a, terms)).float()
    ta, tb = _terms(a, terms), _terms(b, terms)
    return sum(torch.einsum(eq, ta[s], tb[t]) for s in range(terms)
               for t in range(terms - s)).float()


def warp_scan_cumsum(v):
    """Inclusive cumsum of v (..., L), L <= 256, in f32 and in the kernels'
    fixed order (``ssd_common.cuh::chunk_cumsum``): a shuffle scan in each
    warp of 32 rows, then the warps' totals added in order."""
    L = v.shape[-1]
    x = torch.zeros(v.shape[:-1] + (256,), dtype=torch.float32)
    x[..., :L] = v.float()
    x = x.reshape(*v.shape[:-1], 8, 32)
    lane = torch.arange(32)
    for off in (1, 2, 4, 8, 16):
        up = torch.zeros_like(x)
        up[..., off:] = x[..., :-off]
        x = torch.where(lane >= off, x + up, x)
    base, run = torch.zeros(x.shape[:-1]), torch.zeros(x.shape[:-2])
    for w in range(8):
        base[..., w] = run
        run = run + x[..., w, 31]
    return (base[..., None] + x).reshape(*v.shape[:-1], 256)[..., :L]


def emulate_bwd(x, dt, A, B_, C_, chunk, h_in, dy, dh_final=None, terms=None):
    """The backward kernels' schedule on CPU tensors, in f32, each (batch,
    head, chunk) at once, products as the tensor-core route takes them
    (``terms`` bf16 terms of each f32 operand) or in f32 (``terms`` None):
    CB once per (batch, chunk); the pre-pass's warp-scan cumsum, dy's terms
    (made once) and each chunk's own state term (exp(cs) dy)^T C; the reverse
    pass giving dH_out, dh0 and <dH_out, h_in>; the j side, per 64-row j block
    and head: the leaving state's terms (dx_j = w_j dH_out B_j, dB_j, u_j),
    then for each i block >= j dM^T = x_j dy_i^T, M^T and P^T masked before
    exp, d cs's and ddt's column sums, dx_j += M^T dy_i (hi hi, hi lo, lo
    hi), dB_j += P^T C_i; the i side, per i block and head: the entering
    state's R = exp(cs_i) dy_i h_in (three products) into dC_i and C_i . R_i
    into d cs_i, then for each j block <= i dM = dy_i x_j^T, G's row sums
    and dC_i += P B_j; each head group's dB and dC as its two consumers'
    sums (heads 0, 2, .. then 1, 3, ..), the groups summed in order; the
    tail's reverse cumsum (the same warp scan over the reversed rows), ddt
    and dA. Returns what ``ssd_scan_bwd`` returns (dA one row per batch
    row)."""
    Bb, S, nh, hd = x.shape
    ds = B_.shape[-1]
    L = min(chunk, S)
    nc = S // L
    f = torch.float32

    def heads(t):  # (B, S, nh, w) -> (B, nh, nc, L, w)
        return t.float().reshape(Bb, nc, L, nh, -1).permute(0, 3, 1, 2, 4)

    def shared(t):  # (B, S, w) -> (B, 1, nc, L, w)
        return t.float().reshape(Bb, 1, nc, L, -1)

    xs, dys = heads(x), heads(dy)
    Bs, Cs = shared(B_), shared(C_)
    dts = heads(dt[..., None])[..., 0]  # (B, nh, nc, L)
    a = ssd_scan._rows(A, Bb).float()[:, :, None, None]  # (B, nh, 1, 1)
    cs = warp_scan_cumsum(dts * a)
    total = cs[..., -1:]
    cb = torch.einsum("bxcin,bxcjn->bxcij", Cs, Bs)  # CB once per (b, chunk)
    # the pre-pass and the pass
    own = _mm("bhcip,bxcin->bhcpn", torch.exp(cs)[..., None] * dys, Cs, terms, "b")
    g = torch.zeros((Bb, nh, hd, ds), dtype=f) if dh_final is None else dh_final.float()
    d_out = torch.empty((Bb, nh, nc, hd, ds), dtype=f)
    for c in reversed(range(nc)):
        d_out[:, :, c] = g
        g = torch.exp(total[:, :, c])[..., None] * g + own[:, :, c]
    dh0 = g
    dot = (d_out * h_in.float()).sum((-2, -1))
    w = torch.exp(total - cs) * dts
    blocks = [slice(r, min(r + BLK, L)) for r in range(0, L, BLK)]
    idx = torch.arange(L)

    def pair(I, J):  # the block pair's decay, masked before exp
        diff = cs[..., I][..., :, None] - cs[..., J][..., None, :]
        return torch.exp(torch.where(idx[J][None, :] <= idx[I][:, None], diff, -torch.inf))

    # the j side
    dx = torch.zeros_like(xs)
    dBh = torch.zeros((Bb, nh, nc, L, ds), dtype=f)
    col = torch.zeros_like(cs)
    ddt_dir = torch.zeros_like(cs)
    wu = torch.zeros_like(cs)
    for jb, J in enumerate(blocks):
        xj, bj, wj, dtj = xs[..., J, :], Bs[..., J, :], w[..., J], dts[..., J][..., None, :]
        vx = _mm("bxcjn,bhcpn->bhcjp", bj, d_out, terms, "a")  # dH_out B_j
        wx = _mm("bhcjp,bhcpn->bhcjn", xj, d_out, terms, "a")  # dH_out^T x_j
        u = (wx * bj).sum(-1)
        dxa, dba = wj[..., None] * vx, wj[..., None] * wx
        sg, sq = torch.zeros_like(wj), torch.zeros_like(wj)
        for I in blocks[jb:]:
            e = pair(I, J)
            dm = _mm("bhcip,bhcjp->bhcij", dys[..., I, :], xj, terms, "b")
            cbe = cb[..., I, J] * e
            Q = dm * cbe
            sq = sq + Q.sum(-2)
            sg = sg + (Q * dtj).sum(-2)
            dxa = dxa + _mm("bhcij,bhcip->bhcjp", cbe * dtj, dys[..., I, :], terms, None)
            dba = dba + _mm("bhcij,bxcin->bhcjn", dm * e * dtj, Cs[..., I, :], terms, "b")
        dx[..., J, :] = dxa
        dBh[..., J, :] = dba
        wu[..., J] = wj * u
        col[..., J] = -(wj * u + sg)
        ddt_dir[..., J] = torch.exp(total - cs[..., J]) * u + sq
    # the i side
    dCh = torch.zeros((Bb, nh, nc, L, ds), dtype=f)
    row = torch.zeros_like(cs)
    for ib, I in enumerate(blocks):
        dyi, ci = dys[..., I, :], Cs[..., I, :]
        r = torch.exp(cs[..., I])[..., None] * _mm("bhcip,bhcpn->bhcin", dyi, h_in.float(),
                                                    terms, None)
        dca, rg = r, (r * ci).sum(-1)
        for J in blocks[:ib + 1]:
            e = pair(I, J)
            dtj = dts[..., J][..., None, :]
            dm = _mm("bhcip,bhcjp->bhcij", dyi, xs[..., J, :], terms, "b")
            rg = rg + (dm * cb[..., I, J] * e * dtj).sum(-1)
            dca = dca + _mm("bhcij,bxcjn->bhcin", dm * e * dtj, Bs[..., J, :], terms, "b")
        dCh[..., I, :] = dca
        row[..., I] = rg
    # the head groups, then the tail
    group = min(nh, ssd_scan.BWD_GROUP)
    dB = torch.zeros((Bb, nc, L, ds), dtype=f)
    dC = torch.zeros((Bb, nc, L, ds), dtype=f)
    for g0 in range(0, nh, group):
        parts = [range(g0 + k, min(nh, g0 + group), 2) for k in (0, 1)]
        dB = dB + sum((sum(dBh[:, h] for h in hs) for hs in parts if len(hs)), 0)
        dC = dC + sum((sum(dCh[:, h] for h in hs) for hs in parts if len(hs)), 0)
    dcs = row + col
    dcs[..., -1] += torch.exp(total[..., 0]) * dot + wu.sum(-1)
    dl = torch.flip(warp_scan_cumsum(torch.flip(dcs, (-1,))), (-1,))
    ddt = ddt_dir + a * dl
    dA = (dts * dl).sum(-1).sum(-1)  # over the chunk's rows, then the chunks in order
    return (dx.permute(0, 2, 3, 1, 4).reshape(Bb, S, nh, hd).to(x.dtype),
            ddt.permute(0, 2, 3, 1).reshape(Bb, S, nh), dA,
            dB.reshape(Bb, S, ds).to(x.dtype), dC.reshape(Bb, S, ds).to(x.dtype), dh0)


def _model_like(B, S, nh, hd, ds, dtype, seed):
    """Inputs at ``chip_smoke.py``'s K6 scales: x, B, C ~ 0.5 N(0, 1) sliced
    from one conv-output buffer, dt = softplus(N(0, 1) + dt_bias) with the
    model's dt_bias for dt = 0.01, A = -linspace(1, 16); dy ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy((rng.standard_normal((B, S, nh * hd + 2 * ds)) * 0.5)
                           .astype(np.float32)).to(dtype)
    x = buf[..., :nh * hd].reshape(B, S, nh, hd)
    B_, C_ = buf[..., nh * hd:nh * hd + ds], buf[..., nh * hd + ds:]
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, nh)).astype(np.float32)) + float(np.log(np.expm1(0.01))))
    dy = torch.from_numpy(rng.standard_normal((B, S, nh, hd)).astype(np.float32))
    return x, dt, -torch.linspace(1.0, 16.0, nh), B_, C_, dy


def _tol(name, dtype):
    if dtype == torch.bfloat16 and name in ("dx", "dB", "dC"):
        return BWD_TOL["bf16_out"]
    return BWD_TOL["float32" if dtype == torch.float32 else "bfloat16"]


def _emulated(shape, chunk, dtype, h0, terms):
    """(emulated, plain) backward at model-scale inputs, the plain one given
    the plain forward's entering states."""
    B, S, nh, hd, ds = shape
    x, dt, A, B_, C_, dy = _model_like(B, S, nh, hd, ds, dtype, seed=S + chunk)
    rng = np.random.default_rng(1)
    init = torch.from_numpy(rng.standard_normal((B, nh, hd, ds)).astype(np.float32)) if h0 else None
    dhf = torch.from_numpy(rng.standard_normal((B, nh, hd, ds)).astype(np.float32)) if h0 else None
    _, _, h_in = ssd_scan.ssd_chunked_plain(x, dt, A, B_, C_, chunk, init, return_h_in=True)
    got = emulate_bwd(x, dt, A, B_, C_, chunk, h_in, dy, dhf, terms=terms)
    exp = ssd_scan.ssd_chunked_bwd_plain(x, dt, A.expand(B, nh), B_, C_, chunk, h_in, dy, dhf)
    return got, exp


def _route_terms(dtype, ds, chunk):
    """The bf16 terms of the route the kernel takes: the tensor cores' two
    for bf16 inputs with d_state >= 64 and chunks <= 256, else FMA (None)."""
    tc = dtype == torch.bfloat16 and ds >= 64 and chunk <= 256
    return ssd_scan.BWD_TERMS if tc else None


@pytest.mark.parametrize("h0", [False, True], ids=["bare", "h0_dhf"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,chunk", [((1, 512, 4, 64, 128), 256), ((2, 128, 3, 32, 16), 16),
                                         ((1, 200, 2, 64, 64), 100), ((1, 128, 2, 32, 64), 64)])
def test_emulated_schedule_holds_the_card_tolerance(shape, chunk, dtype, h0):
    """The kernel's phases, blocks and sums, in f32 on exact bf16 (or f32)
    inputs, with the route's bf16 terms, against the plain backward given
    the plain forward's entering states: within BWD_TOL of each gradient's
    max."""
    got, exp = _emulated(shape, chunk, dtype, h0, _route_terms(dtype, shape[-1], chunk))
    for name, g, e in zip(GRADS, got, exp):
        assert g.shape == e.shape, name
        assert _rel(g, e) < _tol(name, dtype), (name, _rel(g, e))


@pytest.mark.parametrize("h0", [False, True], ids=["bare", "h0_dhf"])
def test_two_bf16_terms_hold_the_card_tolerance(h0):
    """Why the tensor-core route splits each f32 operand into two bf16
    terms: at mamba2-370m's (hd, ds) and chunk, two keep ddt and dA within
    1e-5 of their max (1e-3 is the tolerance); one term misses 1e-3."""
    two, exp = _emulated((1, 512, 4, 64, 128), 256, torch.bfloat16, h0, 2)
    one, _ = _emulated((1, 512, 4, 64, 128), 256, torch.bfloat16, h0, 1)
    for name in ("ddt", "dA"):
        k = GRADS.index(name)
        assert _rel(two[k], exp[k]) < 1e-5, name
    assert max(_rel(one[k], exp[k]) for k in (1, 2)) > BWD_TOL["bfloat16"]


def test_emulated_schedule_is_finite_past_the_overflow():
    """At the decays where the reference's gradient is NaN the schedule is
    finite and equals the plain backward."""
    t = _torch(_decay_inputs(1.0))
    args = [t[k] for k in ARGS]
    _, _, h_in = ssd_scan.ssd_chunked_plain(*args, 32, t["h0"], return_h_in=True)
    got = emulate_bwd(*args, 32, h_in, t["dy"], t["dhf"])
    exp = ssd_scan.ssd_chunked_bwd_plain(args[0], args[1], args[2].expand(1, 2), *args[3:], 32,
                                         h_in, t["dy"], t["dhf"])
    for name, g, e in zip(GRADS, got, exp):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, e) < 1e-5, (name, _rel(g, e))


# --- the CUDA kernel against its plain version (skip without a GPU) ------------


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain version's einsums in full f32, as the kernel's FMAs
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _on_card(B, S, nh, hd, ds, dtype, seed, strided=True):
    x, dt, A, B_, C_, dy = (t.cuda() for t in _model_like(B, S, nh, hd, ds, dtype, seed))
    if not strided:
        x, B_, C_ = x.contiguous(), B_.contiguous(), C_.contiguous()
    return x, dt, A, B_, C_, dy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,strided", [
    (4, 2048, 32, 64, 128, 256, True),  # mamba2-370m's training shape
    (2, 64, 8, 32, 16, 16, True),  # the reduced mamba2
    (1, 200, 2, 64, 64, 100, False),  # L not a multiple of the 64-row block
    (2, 512, 4, 64, 128, 64, True),
    (1, 256, 3, 32, 128, 256, True),
    (1, 600, 2, 64, 16, 300, True),  # a chunk above 256
])
def test_backward_kernel_matches_plain_on_gpu(cuda, B, S, nh, hd, ds, chunk, strided, dtype):
    """The kernel's entering states at K6's 1e-4 against the plain
    forward's; its gradients, given the plain states, within BWD_TOL of the
    plain backward's; two launches bitwise equal."""
    x, dt, A, B_, C_, dy = _on_card(B, S, nh, hd, ds, dtype, S + nh, strided)
    gen = torch.Generator(device="cuda").manual_seed(3)
    h0 = torch.randn((B, nh, hd, ds), generator=gen, device="cuda")
    dhf = torch.randn((B, nh, hd, ds), generator=gen, device="cuda")
    for init, dh in ((None, None), (h0, dhf)):
        _, _, h_in = ssd_scan.ssd_scan_with_h_in(x, dt, A, B_, C_, chunk, init)
        _, _, h_plain = ssd_scan.ssd_chunked_plain(x, dt, A, B_, C_, chunk, init,
                                                   return_h_in=True)
        torch.testing.assert_close(h_in, h_plain, atol=1e-4, rtol=1e-4)
        before = ssd_scan.bwd_launches
        got = ssd_scan.ssd_scan_bwd(x, dt, A, B_, C_, chunk, h_plain, dy, dh)
        again = ssd_scan.ssd_scan_bwd(x, dt, A, B_, C_, chunk, h_plain, dy, dh)
        assert ssd_scan.bwd_launches == before + 2
        exp = ssd_scan.ssd_chunked_bwd_plain(x, dt, A.expand(B, nh), B_, C_, chunk, h_plain,
                                             dy, dh)
        torch.cuda.synchronize()
        for name, g, a, e in zip(GRADS, got, again, exp):
            assert torch.equal(g, a), name
            assert bool(torch.isfinite(g).all()), name
            assert _rel(g.cpu(), e.cpu()) < _tol(name, dtype), (name, _rel(g.cpu(), e.cpu()))


@pytest.mark.cuda
def test_backward_kernel_is_finite_past_the_overflow_on_gpu(cuda):
    t = {k: v.cuda() for k, v in _torch(_decay_inputs(1.0, 32, 16)).items()}
    args = [t[k] for k in ARGS]
    _, _, h_in = ssd_scan.ssd_chunked_plain(*args, 32, t["h0"], return_h_in=True)
    got = ssd_scan.ssd_scan_bwd(*args, 32, h_in, t["dy"], t["dhf"])
    exp = ssd_scan.ssd_chunked_bwd_plain(args[0], args[1], args[2].expand(1, 2), *args[3:], 32,
                                         h_in, t["dy"], t["dhf"])
    for name, g, e in zip(GRADS, got, exp):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g.cpu(), e.cpu()) < 1e-4, (name, _rel(g.cpu(), e.cpu()))


@pytest.mark.cuda
def test_three_launches_and_a_cohort_repeat_bitwise_at_the_training_shape_on_gpu(cuda):
    """mamba2-370m's training shape, bf16, the tensor-core route: three
    launches give the same bits; ``vmap(grad)`` over a cohort of 4 clients of
    (1, 2048) each is one forward and one backward launch, each client's
    gradients bitwise its own call's (the head groups depend on nh alone)."""
    x, dt, A, B_, C_, dy = _on_card(4, 2048, 32, 64, 128, torch.bfloat16, 7)
    _, _, h_in = ssd_scan.ssd_scan_with_h_in(x, dt, A, B_, C_, 256)
    runs = [ssd_scan.ssd_scan_bwd(x, dt, A, B_, C_, 256, h_in, dy) for _ in range(3)]
    torch.cuda.synchronize()
    for name, a, b, c in zip(GRADS, *runs):
        assert torch.equal(a, b) and torch.equal(a, c), name
    del runs

    def loss(x_, dt_, A_, B__, C__, dy_):
        return (ssd_scan.ssd_scan(x_, dt_, A_, B__, C__, 256)[0] * dy_).sum()

    grad = torch.func.grad(loss, argnums=(0, 1, 2, 3, 4))
    cohort = [t[:, None] for t in (x, dt, B_, C_, dy)]  # 4 clients of batch 1
    f0, b0 = ssd_scan.launches, ssd_scan.bwd_launches
    batched = torch.func.vmap(grad, in_dims=(0, 0, None, 0, 0, 0))(
        cohort[0], cohort[1], A, cohort[2], cohort[3], cohort[4])
    assert (ssd_scan.launches - f0, ssd_scan.bwd_launches - b0) == (1, 1)
    for i in range(4):
        one = grad(*(t[i] for t in cohort[:2]), A, *(t[i] for t in cohort[2:]))
        for name, b, s in zip(GRADS, batched, one):
            assert torch.equal(b[i], s), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_vmap_grad_through_the_kernels_equals_a_loop_on_gpu(cuda, dtype):
    """A cohort of 4 with its own A each: one forward and one backward
    launch for the cohort, each client's gradients bitwise its own call's."""
    n = 4
    xs = [_on_card(1, 128, 4, 64, 64, dtype, 40 + i) for i in range(n)]
    x, dt, A, B_, C_, dy = (torch.stack(t) for t in zip(*xs))
    A = A * torch.linspace(0.5, 2.0, n, device="cuda")[:, None]

    def loss(x_, dt_, A_, B__, C__, dy_):
        return (ssd_scan.ssd_scan(x_, dt_, A_, B__, C__, 64)[0] * dy_).sum()

    grad = torch.func.grad(loss, argnums=(0, 1, 2, 3, 4))
    f0, b0 = ssd_scan.launches, ssd_scan.bwd_launches
    batched = torch.func.vmap(grad)(x, dt, A, B_, C_, dy)
    assert (ssd_scan.launches - f0, ssd_scan.bwd_launches - b0) == (1, 1)
    for i in range(n):
        for b, s in zip(batched, grad(x[i], dt[i], A[i], B_[i], C_[i], dy[i])):
            assert torch.equal(b[i], s)
