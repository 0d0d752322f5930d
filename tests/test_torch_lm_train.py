"""LM training in the port (slice G2) against the reference on the CPU.

- K4's backward: ``flash_attention_bwd_plain`` and the gradients of
  ``Attention`` (the autograd Function that takes the kernels on a card and
  their plain versions here) against ``jax.vjp`` of the reference's
  ``_attend_direct``, for the three masks, G 1/4/8 and D 32/64, in f32,
  within 1e-5 of each gradient's max (f32 sums in other orders; the
  backward works from ``D = rowsum(dO * O)`` where autodiff of softmax sums
  ``dW * W``, the same value in exact arithmetic). ``vmap(grad)`` through
  the Functions equals a loop of single calls within 1e-6.
- ``model.loss`` gradients of the reduced tinyllama-1.1b in f32, from the
  reference's params (``convert.lm_params_from_jax``), against ``jax.grad``
  of the reference's ``model.loss``, within 1e-5 of each leaf's max: at
  S = 64 (the direct route) and S = 128 (K4's route: the Function here).
- Three ``sgd_train_step``s against the reference's (params within atol
  1e-6 / rtol 1e-5 after each, each step from the reference's params);
  remat on and off give the same loss bitwise and gradients within 1e-6
  (f32 sums in another order); ``build_sized`` configs equal the
  reference's; mamba2 trains on the CPU through K6's Function (the forward
  twice a layer, the plain backward once).
- The reduced mamba2's ``model.loss`` gradients against ``jax.grad`` of the
  reference's loss from the same converted weights (1e-4 of each leaf's
  max), and one ``sgd_train_step`` against the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs.base import AttentionSpec as RefSpec  # noqa: E402
from repro.launch.train import build_sized as ref_build_sized  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import factory as ref_factory  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.kernels import ssd_scan as k6  # noqa: E402
from repro_torch.launch.train import build_sized  # noqa: E402
from repro_torch.models import factory  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

ARCH = "tinyllama-1.1b"
MASKS = [("full", 0), ("sliding", 24), ("chunked", 32)]


def _inputs(B, Hk, G, S, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hk, G, S, D)).astype(np.float32),
            rng.standard_normal((B, Hk, S, D)).astype(np.float32),
            rng.standard_normal((B, Hk, S, D)).astype(np.float32),
            rng.standard_normal((B, Hk, G, S, D)).astype(np.float32))


def _ref_vjp(q, k, v, dout, kind, window, scale):
    """(out, (dq, dk, dv)) of the reference's kernel-off attention."""
    S = q.shape[3]
    pos = jnp.arange(S)
    spec = RefSpec(num_heads=1, num_kv_heads=1, head_dim=q.shape[-1], kind=kind,
                   window=window)
    mask = ref_attn._pair_mask(spec, pos, pos)[None, None, None]
    out, vjp = jax.vjp(lambda a, b, c: ref_attn._attend_direct(a, b, c, mask, scale),
                       *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _assert_rel(got, exp, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got - exp).max()
    assert err <= tol * np.abs(exp).max(), f"{what}: {err} vs max {np.abs(exp).max()}"


@pytest.mark.parametrize("kind,window", MASKS, ids=[m for m, _ in MASKS])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("D", [32, 64])
def test_backward_matches_jax_vjp(kind, window, G, D):
    B, Hk, S = 2, 2, 128
    q, k, v, dout = _inputs(B, Hk, G, S, D, seed=G * 100 + D)
    scale = D**-0.5
    out_r, grads_r = _ref_vjp(q, k, v, dout, kind, window, scale)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    # the plain backward from the plain forward's out and lse
    out, lse = k4.flash_attention_with_lse(tq, tk, tv, scale=scale, kind=kind,
                                           window=window)
    _assert_rel(out, out_r, 1e-5, "out")
    plain = k4.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, scale, kind, window)
    # the Function, as autograd reaches it
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    before = (k4.launches, k4.bwd_launches)
    fn_out = k4.flash_attention(*leaves, scale=scale, kind=kind, window=window,
                                block_q=S, block_k=S)
    fn_grads = torch.autograd.grad(fn_out, leaves, tdo)
    assert (k4.launches, k4.bwd_launches) == before  # no kernel on the CPU
    for name, p, f, r in zip("qkv", plain, fn_grads, grads_r):
        _assert_rel(p, r, 1e-5, f"plain d{name}")
        _assert_rel(f, r, 1e-5, f"Function d{name}")


def test_vmap_grad_through_the_functions_equals_a_loop():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((3, 1, 2, 4, 128, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((3, 1, 2, 128, 32)).astype(np.float32))
            for _ in range(2))

    def loss(q_, k_, v_):
        out = k4.flash_attention(q_, k_, v_, scale=0.2, kind="sliding", window=40,
                                 block_q=128, block_k=128)
        return (out * out).sum()

    grad = torch.func.grad(loss, argnums=(0, 1, 2))
    batched = torch.func.vmap(grad)(q, k, v)
    shared = torch.func.vmap(grad, in_dims=(0, None, None))(q, k[0], v[0])
    for i in range(3):
        for b, s in zip(batched, grad(q[i], k[i], v[i])):
            torch.testing.assert_close(b[i], s, rtol=1e-6, atol=1e-6)
        for b, s in zip(shared, grad(q[i], k[0], v[0])):
            torch.testing.assert_close(b[i], s, rtol=1e-6, atol=1e-6)


def test_backward_of_the_backward_raises():
    q, k, v, dout = map(torch.from_numpy, _inputs(1, 1, 2, 128, 32, seed=1))
    q.requires_grad_()
    out = k4.flash_attention(q, k, v, scale=0.2)
    (dq,) = torch.autograd.grad(out, (q,), dout, create_graph=True)
    with pytest.raises(RuntimeError, match="no backward of its own"):
        dq.sum().backward()


@pytest.fixture(scope="module")
def lm():
    """(ref model, ref params, port model, port params) of the reduced
    tinyllama in f32."""
    mr = ref_factory.build(ref_get_arch(ARCH).reduced())
    m = factory.build(get_arch(ARCH).reduced())
    pr = mr.init(jax.random.PRNGKey(0))
    return mr, pr, m, convert.lm_params_from_jax(jax.tree.map(np.asarray, pr), "cpu")


def _batch(cfg, S, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, S + 1)).astype(
        np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])})


def _grads(m, params, batch):
    tracked = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = m.loss(tracked, batch)
    grads = torch.autograd.grad(loss, tree_leaves(tracked))
    return loss, grads


@pytest.mark.parametrize("S", [64, 128], ids=["direct_route", "k4_route"])
def test_loss_gradients_match_jax_grad(lm, S, monkeypatch):
    mr, pr, m, p = lm
    br, bp = _batch(m.cfg, S, seed=S)
    calls = []
    plain_bwd = k4.flash_attention_bwd_plain
    monkeypatch.setattr(k4, "flash_attention_bwd_plain",
                        lambda *a, **kw: calls.append(1) or plain_bwd(*a, **kw))
    loss, grads = _grads(m, p, bp)
    # K4's route (the Function) exactly where the reference would take its
    # kernel: S % 128 == 0; one backward a layer
    assert len(calls) == (m.cfg.num_layers if S % 128 == 0 else 0)
    loss_r, grads_r = jax.value_and_grad(lambda pp: mr.loss(pp, br)[0])(pr)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-6)
    it = iter(grads)
    got = convert.lm_params_to_jax(tree_map(lambda _: next(it), p))
    for (path, g_r), g in zip(jax.tree_util.tree_leaves_with_path(grads_r),
                              jax.tree.leaves(got)):
        _assert_rel(g, np.asarray(g_r), 1e-5, jax.tree_util.keystr(path))


def test_sgd_train_steps_match_reference(lm):
    mr, pr, m, _ = lm
    step_r = jax.jit(mr.sgd_train_step)
    params_r = pr
    for i in range(3):
        br, bp = _batch(m.cfg, 128, seed=10 + i)
        new_r, met_r = step_r(params_r, br, 3e-3)
        port = convert.lm_params_from_jax(jax.tree.map(np.asarray, params_r), "cpu")
        new, met = m.sgd_train_step(port, bp, 3e-3)
        assert set(met) == set(met_r) == {"loss", "moe_aux", "total_loss"}
        np.testing.assert_allclose(float(met["loss"]), float(met_r["loss"]), rtol=1e-6)
        got = convert.lm_params_to_jax(new)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(new_r),
                                jax.tree.leaves(got)):
            np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, rtol=1e-5,
                                       err_msg=f"step {i} {jax.tree_util.keystr(path)}")
        assert not np.array_equal(np.asarray(new_r["embed"]), np.asarray(params_r["embed"]))
        params_r = new_r


def test_remat_changes_no_gradient(lm):
    _, _, m, p = lm
    _, bp = _batch(m.cfg, 128, seed=3)
    off = factory.build(m.cfg, remat=False)
    loss_on, g_on = _grads(m, p, bp)
    loss_off, g_off = _grads(off, p, bp)
    assert torch.equal(loss_on, loss_off)
    # autograd sums a layer input's gradient contributions in another order
    # under checkpointing: equal up to f32 rounding
    for a, b in zip(g_on, g_off):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


def test_mamba2_trains_on_the_cpu_through_k6_plain(monkeypatch):
    """A step goes through K6's Function, on the CPU its plain routes: the
    forward twice a layer (remat), the plain backward once."""
    cfg = get_arch("mamba2-370m").reduced()
    m = factory.build(cfg)
    p = m.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = k6.ssd_chunked_plain, k6.ssd_chunked_bwd_plain
    monkeypatch.setattr(k6, "ssd_chunked_plain",
                        lambda *a, **kw: calls.__setitem__("fwd", calls["fwd"] + 1) or fwd(*a, **kw))
    monkeypatch.setattr(k6, "ssd_chunked_bwd_plain",
                        lambda *a, **kw: calls.__setitem__("bwd", calls["bwd"] + 1) or bwd(*a, **kw))
    new, met = m.sgd_train_step(p, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, 1e-2)
    assert calls == {"fwd": 2 * cfg.num_layers, "bwd": cfg.num_layers}
    assert bool(torch.isfinite(met["loss"]))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(new)))


SSM_ARCH = "mamba2-370m"


@pytest.fixture(scope="module")
def ssm_lm():
    """(ref model, ref params, port model, port params) of the reduced
    mamba2 in f32."""
    mr = ref_factory.build(ref_get_arch(SSM_ARCH).reduced())
    m = factory.build(get_arch(SSM_ARCH).reduced())
    pr = mr.init(jax.random.PRNGKey(0))
    return mr, pr, m, convert.lm_params_from_jax(jax.tree.map(np.asarray, pr), "cpu")


@pytest.mark.parametrize("S", [32, 64])
def test_ssm_loss_gradients_match_jax_grad(ssm_lm, S):
    """The reduced mamba2's ``model.loss`` gradients (K6's Function with its
    plain routes) against ``jax.grad`` of the reference's loss from the same
    converted weights: each leaf within 1e-4 of its max."""
    mr, pr, m, p = ssm_lm
    br, bp = _batch(m.cfg, S, seed=S + 1)
    loss, grads = _grads(m, p, bp)
    loss_r, grads_r = jax.value_and_grad(lambda pp: mr.loss(pp, br)[0])(pr)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-6)
    it = iter(grads)
    got = convert.lm_params_to_jax(tree_map(lambda _: next(it), p))
    for (path, g_r), g in zip(jax.tree_util.tree_leaves_with_path(grads_r),
                              jax.tree.leaves(got)):
        assert np.isfinite(np.asarray(g_r)).all()
        _assert_rel(g, np.asarray(g_r), 1e-4, jax.tree_util.keystr(path))


def test_ssm_sgd_train_step_matches_reference(ssm_lm):
    mr, pr, m, p = ssm_lm
    br, bp = _batch(m.cfg, 64, seed=12)
    new_r, met_r = jax.jit(mr.sgd_train_step)(pr, br, 3e-3)
    new, met = m.sgd_train_step(p, bp, 3e-3)
    np.testing.assert_allclose(float(met["loss"]), float(met_r["loss"]), rtol=1e-6)
    got = convert.lm_params_to_jax(new)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(new_r), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch,target", [("tinyllama-1.1b", 20e6), ("llama3-8b", 5e6),
                                         ("tinyllama-1.1b", 1e9), ("mamba2-370m", 20e6)])
def test_build_sized_matches_reference(arch, target):
    assert dataclasses.asdict(build_sized(arch, target)) == dataclasses.asdict(
        ref_build_sized(arch, target))
