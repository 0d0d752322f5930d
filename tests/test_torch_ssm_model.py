"""The port's Mamba2 model against the reference, on the reduced
mamba2-370m in f32 (d_model 256, d_inner 512, d_state 16, head_dim 32,
chunk 16), with the reference's params converted by
``repro_torch.convert.lm_params_from_jax``: the SSM block, the prefill
logits and its ``h``/``conv`` caches, 16 decode steps, the loss forward,
and the serve flow's greedy tokens. Also the reference's own SSM contracts
(``tests/test_ssm.py``) held within the port, and the convert round trip
bit for bit.

On the CPU the port's K6 call takes its plain version (``ssd_chunked``).
Values agree within atol/rtol 1e-4 (f32 sums in other orders); the port's
decode updates caches in place, so each comparison starts from fresh
converted caches.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import factory as ref_factory  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.serve.batching import prefill_tokens as ref_prefill_tokens  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import SSMSpec  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import factory  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.serve.batching import prefill_tokens  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "mamba2-370m"


@pytest.fixture(scope="module")
def lm():
    """(ref cfg, ref model, ref params, port cfg, port model, port params)."""
    cfg_r, cfg = ref_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    mr, m = ref_factory.build(cfg_r), factory.build(cfg)
    pr = mr.init(jax.random.PRNGKey(0))
    p = convert.lm_params_from_jax(jax.tree.map(np.asarray, pr), "cpu")
    return cfg_r, mr, pr, cfg, m, p


def _tokens(cfg, B, S_, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S_)).astype(np.int32)


def test_the_reduced_config_is_the_one_under_test(lm):
    cfg = lm[3]
    s = cfg.pattern[0].ssm
    assert (cfg.d_model, s.d_inner, s.d_state, s.head_dim, s.chunk) == (256, 512, 16, 32, 16)
    assert factory.build(get_arch(ARCH)).cfg.num_layers == 48


def test_init_matches_the_reference_tree_and_distributions(lm):
    _, _, pr, _, m, _ = lm
    p = m.init(torch.Generator().manual_seed(0))
    ref_leaves = jax.tree_util.tree_leaves_with_path(pr)
    port_leaves = jax.tree_util.tree_leaves_with_path(convert.lm_params_to_jax(p))
    assert [k for k, _ in ref_leaves] == [k for k, _ in port_leaves]
    for (path, a), (_, b) in zip(ref_leaves, port_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.size > 1000:  # same scale of the same normal law
            assert np.std(b) == pytest.approx(np.std(np.asarray(a)), rel=0.1), path
        elif "A_log" in str(path) or "dt_bias" in str(path) or "'D'" in str(path):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6)  # constants


def test_ssm_block_fwd_and_decode_match_the_reference(lm):
    cfg_r, _, pr, cfg, _, p = lm
    spec_r, spec = cfg_r.pattern[0].ssm, cfg.pattern[0].ssm
    ps_r = jax.tree.map(lambda t: t[0], pr["blocks"][0]["ssm"])
    ps = {k: v[0] for k, v in p["blocks"][0]["ssm"].items()}
    x = np.random.default_rng(1).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    y_r, h_r = ref_ssm.ssm_fwd(ps_r, jnp.asarray(x), spec_r, return_state=True)
    y, h = S.ssm_fwd(ps, torch.from_numpy(x), spec, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), **TOL)
    c_r = ref_ssm.init_ssm_cache(spec_r, 2, jnp.float32)
    c = S.init_ssm_cache(spec, 2, torch.float32)
    for t in range(8):
        y_r, c_r = ref_ssm.ssm_decode(ps_r, jnp.asarray(x[:, t:t + 1]), spec_r, c_r)
        y, c = S.ssm_decode(ps, torch.from_numpy(x[:, t:t + 1]), spec, c)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(c_r[key]), **TOL)


def test_prefill_then_16_decode_steps_match_the_reference(lm):
    cfg_r, mr, pr, cfg, m, p = lm
    toks = _tokens(cfg, 2, 48, seed=3)
    lg_r, c_r = mr.prefill(pr, {"tokens": jnp.asarray(toks[:, :32])})
    lg, c = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :32])})
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), **TOL)
    ref_leaves = jax.tree_util.tree_leaves_with_path(c_r)
    port_leaves = jax.tree_util.tree_leaves_with_path(convert.lm_caches_to_jax(c))
    assert [k for k, _ in ref_leaves] == [k for k, _ in port_leaves]
    assert {str(k[-1]) for k, _ in ref_leaves} == {"['h']", "['conv']"}
    for (path, a), (_, b) in zip(ref_leaves, port_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(b, np.asarray(a), **TOL)
    # decode on from the reference's caches (converted)
    c = convert.lm_caches_from_jax(jax.tree.map(np.asarray, c_r), "cpu")
    step_r = jax.jit(mr.decode_step)
    for t in range(32, 48):
        lg_r, c_r = step_r(pr, c_r, jnp.asarray(toks[:, t:t + 1]))
        lg, c = m.decode_step(p, c, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), **TOL)
    for a, b in zip(jax.tree.leaves(c_r), jax.tree.leaves(convert.lm_caches_to_jax(c))):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)


def test_loss_forward_matches_the_reference(lm):
    cfg_r, mr, pr, cfg, m, p = lm
    toks, labels = _tokens(cfg, 2, 64, seed=4), _tokens(cfg, 2, 64, seed=5)
    labels[0, :3] = -1  # ignored positions
    loss_r, _ = mr.loss(pr, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    loss, metrics = m.loss(p, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels)})
    assert float(loss) == pytest.approx(float(loss_r), rel=1e-5)
    assert float(metrics["moe_aux"]) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_and_caches_round_trip_bit_for_bit(dtype):
    cfg_r = dataclasses.replace(ref_get_arch(ARCH).reduced(), param_dtype=dtype,
                                compute_dtype=dtype)
    mr = ref_factory.build(cfg_r)
    pr = jax.tree.map(np.asarray, mr.init(jax.random.PRNGKey(1)))
    _, c_r = mr.prefill(pr, {"tokens": jnp.asarray(_tokens(cfg_r, 2, 32, seed=6))})
    c_r = jax.tree.map(np.asarray, c_r)
    for tree, there, back in ((pr, convert.lm_params_from_jax, convert.lm_params_to_jax),
                              (c_r, convert.lm_caches_from_jax, convert.lm_caches_to_jax)):
        port = there(tree, "cpu")
        for a, t in zip(jax.tree.leaves(tree), jax.tree.leaves(port)):
            assert str(t.dtype) == f"torch.{a.dtype}"
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back(port))):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    assert c_r["blocks"][0]["h"].dtype == np.float32
    assert str(c_r["blocks"][0]["conv"].dtype) == dtype


# --- the reference's SSM contracts, held within the port ------------------------


def _inputs(B, L, nh, hd, ds, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy((rng.standard_normal((B, L, nh, hd)) * 0.5).astype(np.float32)),
            torch.from_numpy(np.log1p(np.exp(rng.standard_normal((B, L, nh)))).astype(np.float32)),
            torch.from_numpy((-np.exp(rng.standard_normal(nh) * 0.3)).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((B, L, ds)) * 0.5).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((B, L, ds)) * 0.5).astype(np.float32)))


@pytest.mark.parametrize("chunk,L,seed", [(8, 64, 0), (16, 128, 1), (32, 64, 2),
                                          (64, 128, 3)])
def test_chunked_equals_reference(chunk, L, seed):
    x, dt, A, B_, C_ = _inputs(1, L, 2, 16, 8, seed)
    y1, h1 = S.ssd_chunked(x, dt, A, B_, C_, chunk)
    y2, h2 = S.ssd_reference(x, dt, A, B_, C_)
    torch.testing.assert_close(y1, y2, **TOL)
    torch.testing.assert_close(h1, h2, **TOL)


def test_state_carry_across_calls():
    """Two halves with the carried state == one full pass."""
    x, dt, A, B_, C_ = _inputs(2, 64, 2, 16, 8)
    y_full, h_full = S.ssd_chunked(x, dt, A, B_, C_, 16)
    y1, h1 = S.ssd_chunked(x[:, :32], dt[:, :32], A, B_[:, :32], C_[:, :32], 16)
    y2, h2 = S.ssd_chunked(x[:, 32:], dt[:, 32:], A, B_[:, 32:], C_[:, 32:], 16, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, **TOL)
    torch.testing.assert_close(h2, h_full, **TOL)


def test_block_decode_matches_fwd():
    """The full mamba2 block: step-by-step decode == full-sequence forward."""
    spec = SSMSpec(d_inner=32, d_state=8, head_dim=16, conv_width=4, chunk=8)
    p = S.init_ssm(torch.Generator().manual_seed(0), 24, spec, torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 24, 24))
                         .astype(np.float32) * 0.5)
    full = S.ssm_fwd(p, x, spec)
    cache = S.init_ssm_cache(spec, 1, torch.float32)
    outs = []
    for t in range(24):
        y, cache = S.ssm_decode(p, x[:, t:t + 1], spec, cache)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full, **TOL)


def test_decode_state_is_constant_size_and_updated_in_place():
    spec = SSMSpec(d_inner=32, d_state=8, head_dim=16)
    c = S.init_ssm_cache(spec, 3, torch.float32)
    assert c["h"].shape == (3, 2, 16, 8) and c["conv"].shape == (3, 3, 32 + 16)
    p = S.init_ssm(torch.Generator().manual_seed(1), 24, spec, torch.float32)
    ptrs = (c["h"].data_ptr(), c["conv"].data_ptr())
    for _ in range(5):
        _, c = S.ssm_decode(p, torch.randn(3, 1, 24), spec, c)
    assert (c["h"].data_ptr(), c["conv"].data_ptr()) == ptrs
    assert c["h"].shape == (3, 2, 16, 8) and bool(c["h"].abs().sum() > 0)


def test_decay_bounds():
    """exp(dt*A) in (0, 1): the state is a contraction (no blowup)."""
    x, dt, A, B_, C_ = _inputs(1, 512, 2, 8, 4)
    y, h = S.ssd_chunked(x, dt, A, B_, C_, 64)
    assert bool(torch.isfinite(y).all()) and float(h.abs().max()) < 1e3


def test_prefill_decode_consistency(lm):
    """The port's own contract: prefill logits == step-by-step decode."""
    _, _, _, cfg, m, p = lm
    toks = torch.from_numpy(_tokens(cfg, 2, 48, seed=7))
    lg_p, c_p = m.prefill(p, {"tokens": toks})
    lg_d, c_d = prefill_tokens(m.decode_step, p, m.init_decode_caches(2, 48), toks)
    torch.testing.assert_close(lg_p, lg_d, atol=3e-4, rtol=3e-4)
    torch.testing.assert_close(c_p["blocks"][0]["h"], c_d["blocks"][0]["h"], **TOL)
    torch.testing.assert_close(c_p["blocks"][0]["conv"], c_d["blocks"][0]["conv"], **TOL)


# --- the serve flow ---------------------------------------------------------


B, PROMPT, GEN = 4, 8, 32


def test_greedy_serve_matches_the_reference(lm):
    """The reference's ``prefill_tokens`` plus a greedy loop against the
    port's ``launch.serve.serve`` at temperature 0: equal tokens."""
    cfg_r, mr, pr, cfg, _, p = lm
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    caches = mr.init_decode_caches(B, PROMPT + GEN)
    logits, caches = jax.jit(
        lambda pp, c, t: ref_prefill_tokens(mr.decode_step, pp, c, t)
    )(pr, caches, jnp.asarray(prompts))
    step = jax.jit(mr.decode_step)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    tokens, step_logits = [], []
    for _ in range(GEN):
        tokens.append(np.asarray(tok)[:, 0])
        logits, caches = step(pr, caches, tok)
        step_logits.append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    res = serve_mod.serve(cfg, B, PROMPT, GEN, temperature=0.0, device="cpu",
                          params=p, prompts=torch.from_numpy(prompts))
    # no top-2 gap of the reference's logits is within float noise, so the
    # greedy tokens must agree exactly
    top2 = np.sort(np.stack(step_logits, 1), axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-4
    np.testing.assert_array_equal(res.tokens, np.stack(tokens, 1))


def test_serve_driver_runs_mamba2_on_the_cpu():
    res = serve_mod.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                          "--prompt-len", "8", "--gen", "4"])
    assert res.tokens.shape == (2, 4)
