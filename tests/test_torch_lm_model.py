"""The port's LM (``repro_torch.models``) against the reference on the
reduced tinyllama-1.1b in f32, with the reference's params converted by
``repro_torch.convert.lm_params_from_jax``: configs, attention, MLP, the
prefill forward and its caches, 16 decode steps, and the loss forward.

On the CPU the port's K4/K5 calls take their plain versions; the reference
runs its kernel-off route or, under ``set_kernel_attention(True)``, the
Pallas kernel in interpret mode. Logits agree within atol/rtol 1e-4 (f32
sums in other orders; the reference's own prefill/decode consistency
tolerance is 3e-4); cache indices are exact. The port's decode updates
caches in place, so each comparison starts from fresh converted caches.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import all_archs as ref_all_archs  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import factory as ref_factory  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models.common import rope_frequencies as ref_rope  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import all_archs, get_arch  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import factory, transformer  # noqa: E402
from repro_torch.models.common import rope_frequencies  # noqa: E402
from repro_torch.models.mlp import mlp_fwd  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def lm():
    """(ref cfg, ref model, ref params, port cfg, port model, port params)."""
    cfg_r, cfg = ref_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    mr, m = ref_factory.build(cfg_r), factory.build(cfg)
    pr = mr.init(jax.random.PRNGKey(0))
    p = convert.lm_params_from_jax(jax.tree.map(np.asarray, pr), "cpu")
    return cfg_r, mr, pr, cfg, m, p


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _layer0(p):
    return {k: v[0] for k, v in p["blocks"][0]["attn"].items()}


def test_configs_agree_with_the_reference():
    ref, port = ref_all_archs(), all_archs()
    assert sorted(ref) == sorted(port)
    for name, cfg in port.items():
        assert cfg.param_count() == ref[name].param_count(), name
        assert cfg.active_param_count() == ref[name].active_param_count(), name
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref[name]), name
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref[name].reduced())


def test_builds_what_the_slice_runs_and_names_the_rest():
    assert factory.build(get_arch("llama3-8b")).cfg.name == "llama3-8b"
    assert factory.build(get_arch("mamba2-370m")).cfg.name == "mamba2-370m"
    assert factory.build(get_arch("mamba2-370m").reduced()).cfg.num_layers == 2
    for name in ("gemma3-27b", "deepseek-v2-236b", "whisper-tiny",
                 "pixtral-12b", "jamba-v0.1-52b", "llama4-maverick-400b-a17b"):
        assert factory.build(get_arch(name)).cfg.name == name  # slice G3
    # what is still refused: a shape the kernels on the model's path do not take
    cfg = get_arch(ARCH).reduced()
    odd = dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(s, attn=dataclasses.replace(s.attn, head_dim=48))
        for s in cfg.pattern))
    with pytest.raises(NotImplementedError, match="K4/K5"):
        factory.build(odd)
    # LM training arrived with slice G2: the step runs and moves the params
    m = factory.build(get_arch(ARCH).reduced())
    p = m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(m.cfg, 2, 33, seed=1))
    new, metrics = m.sgd_train_step(p, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, 0.1)
    assert bool(torch.isfinite(metrics["total_loss"]))
    assert not torch.equal(new["embed"], p["embed"])


def test_init_matches_the_reference_tree_and_distributions(lm):
    cfg_r, _, pr, cfg, m, _ = lm
    p = m.init(torch.Generator().manual_seed(0))
    ref_leaves = jax.tree_util.tree_leaves_with_path(pr)
    port = convert.lm_params_to_jax(p)
    port_leaves = jax.tree_util.tree_leaves_with_path(port)
    assert [k for k, _ in ref_leaves] == [k for k, _ in port_leaves]
    for (path, a), (_, b) in zip(ref_leaves, port_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.size > 1000:  # same scale of the same normal law
            assert np.std(b) == pytest.approx(np.std(np.asarray(a)), rel=0.1), path


def test_attention_fwd_and_decode_match_the_reference(lm):
    cfg_r, _, pr, cfg, _, p = lm
    spec_r, spec = cfg_r.pattern[0].attn, cfg.pattern[0].attn
    pa_r = jax.tree.map(lambda t: t[0], pr["blocks"][0]["attn"])
    pa = _layer0(p)
    rng = np.random.default_rng(1)
    S = 24
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    inv_r, rot = ref_rope(spec.head_dim, cfg.rope_theta)
    inv, _ = rope_frequencies(spec.head_dim, cfg.rope_theta)
    tab_r, tab = ref_attn.RopeTable(inv_r, rot), A.RopeTable(inv, rot)
    pos = np.arange(S, dtype=np.int32)
    full_r = ref_attn.attention_fwd(pa_r, jnp.asarray(x), spec_r, tab_r, jnp.asarray(pos))
    full = A.attention_fwd(pa, torch.from_numpy(x), spec, tab, torch.from_numpy(pos))
    np.testing.assert_allclose(full.numpy(), np.asarray(full_r), **TOL)
    # decode into a ring shorter than the sequence: the ring wraps
    c_r = ref_attn.init_cache(spec_r, 2, 16, jnp.float32)
    c = A.init_cache(spec, 2, 16, torch.float32)
    for t in range(S):
        y_r, c_r = ref_attn.attention_decode(pa_r, jnp.asarray(x[:, t:t + 1]), spec_r,
                                             tab_r, c_r)
        y, c = A.attention_decode(pa, torch.from_numpy(x[:, t:t + 1]), spec, tab, c)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    assert int(c["index"]) == int(c_r["index"]) == S
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(c_r["k"]), **TOL)


def test_mlp_matches_the_reference(lm):
    cfg_r, _, pr, cfg, _, p = lm
    x = np.random.default_rng(2).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    pm_r = jax.tree.map(lambda t: t[0], pr["blocks"][0]["mlp"])
    pm = {k: v[0] for k, v in p["blocks"][0]["mlp"].items()}
    y_r = ref_mlp.mlp_fwd(pm_r, jnp.asarray(x), cfg_r.pattern[0].mlp)
    np.testing.assert_allclose(mlp_fwd(pm, torch.from_numpy(x), cfg.pattern[0].mlp).numpy(),
                               np.asarray(y_r), **TOL)


def test_prefill_then_16_decode_steps_match_the_reference(lm):
    cfg_r, mr, pr, cfg, m, p = lm
    toks = _tokens(cfg, 2, 48, seed=3)
    lg_r, c_r = mr.prefill(pr, {"tokens": jnp.asarray(toks[:, :32])})
    lg, c = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :32])})
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), **TOL)
    ref_leaves, port_leaves = jax.tree.leaves(c_r), jax.tree.leaves(convert.lm_caches_to_jax(c))
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b, np.asarray(a), **TOL)
    # decode on from the reference's caches (converted): ring of 32 slots wraps
    c = convert.lm_caches_from_jax(jax.tree.map(np.asarray, c_r), "cpu")
    step_r = jax.jit(mr.decode_step)
    for t in range(32, 48):
        lg_r, c_r = step_r(pr, c_r, jnp.asarray(toks[:, t:t + 1]))
        lg, c = m.decode_step(p, c, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), **TOL)
    for a, b in zip(jax.tree.leaves(c_r), jax.tree.leaves(convert.lm_caches_to_jax(c))):
        if a.dtype == np.int32:
            np.testing.assert_array_equal(b, np.asarray(a))  # indices exact
        else:
            np.testing.assert_allclose(b, np.asarray(a), **TOL)


@pytest.mark.parametrize("ref_kernel", [True, False], ids=["ref_pallas", "ref_jnp"])
def test_loss_forward_matches_the_reference(lm, ref_kernel):
    """The analogue of ``test_kernel_integration.py``: the whole-model loss
    at S = 256, the reference through its Pallas kernel (interpret mode) or
    its jnp route, the port through K4's entry point."""
    cfg_r, mr, pr, cfg, m, p = lm
    toks, labels = _tokens(cfg, 1, 256, seed=4), _tokens(cfg, 1, 256, seed=5)
    labels[0, :3] = -1  # ignored positions
    try:
        ref_attn.set_kernel_attention(ref_kernel)
        loss_r, _ = mr.loss(pr, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    finally:
        ref_attn.set_kernel_attention(False)
    loss, metrics = m.loss(p, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels)})
    assert float(loss) == pytest.approx(float(loss_r), rel=1e-5)
    assert float(metrics["moe_aux"]) == 0.0


def test_kernel_switch_routes_agree():
    """Port, kernel entry point on or off: the same forward (the off route
    is the reference's ``_attend_direct``)."""
    cfg = get_arch(ARCH).reduced()
    m = factory.build(cfg)
    gen = torch.Generator().manual_seed(1)
    p = m.init(gen)
    batch = factory.synth_batch(gen, cfg, 1, 256)
    assert {k: (v.shape, v.dtype) for k, v in batch.items()} == {
        k: ((1, 256), torch.int32) for k in ("tokens", "labels")}
    toks = batch["tokens"]
    x_on, _, _ = transformer.forward(p, cfg, toks)
    try:
        A.set_kernel_attention(False)
        x_off, _, _ = transformer.forward(p, cfg, toks)
    finally:
        A.set_kernel_attention(True)
    torch.testing.assert_close(x_on, x_off, **TOL)


def test_blocked_online_softmax_matches_the_reference(monkeypatch):
    """``_attend_flash_jnp``, the reference's kernel-off route above 2048
    tokens, at small blocks."""
    monkeypatch.setattr(ref_attn, "BLOCK_Q", 64)
    monkeypatch.setattr(ref_attn, "BLOCK_K", 32)
    monkeypatch.setattr(A, "BLOCK_Q", 64)
    monkeypatch.setattr(A, "BLOCK_K", 32)
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 2, 2, 128, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, 128, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, 128, 32)).astype(np.float32)
    pos = np.arange(128, dtype=np.int32)
    for kw in ({}, {"kind": "sliding", "window": 40}, {"kind": "chunked", "window": 32}):
        spec_r = ref_attn.AttentionSpec(num_heads=4, num_kv_heads=2, head_dim=32, **kw)
        spec = A.AttentionSpec(num_heads=4, num_kv_heads=2, head_dim=32, **kw)
        out_r = ref_attn._attend_flash_jnp(*map(jnp.asarray, (q, k, v)), spec_r,
                                           jnp.asarray(pos), jnp.asarray(pos), 0.2)
        out = A._attend_flash_jnp(*map(torch.from_numpy, (q, k, v)), spec,
                                  torch.from_numpy(pos), torch.from_numpy(pos), 0.2)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_r), **TOL)


def test_decode_matches_fwd_full():
    """Port analogue of ``test_attention.py::test_decode_matches_fwd_full``:
    cached decode over a sequence == the full forward."""
    spec = A.AttentionSpec(num_heads=4, num_kv_heads=2, head_dim=32)
    gen = torch.Generator().manual_seed(0)
    p = A.init_attention(gen, 64, spec, torch.float32)
    S = 12
    x = torch.randn((1, S, 64), generator=gen)
    inv, rot = rope_frequencies(spec.head_dim, 10_000.0)
    table = A.RopeTable(inv, rot)
    full = A.attention_fwd(p, x, spec, table, torch.arange(S, dtype=torch.int32))
    cache = A.init_cache(spec, 1, S, torch.float32)
    outs = []
    for t in range(S):
        y, cache = A.attention_decode(p, x[:, t:t + 1], spec, table, cache)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full, **TOL)


def test_prefill_decode_consistency_dense():
    """Port analogue of ``test_models_smoke.py::
    test_prefill_decode_consistency_dense``: prefill logits == step-by-step
    decode logits, at the reference's tolerance (3e-4)."""
    cfg = get_arch(ARCH).reduced()
    m = factory.build(cfg)
    p = m.init(torch.Generator().manual_seed(2))
    S = 16
    toks = torch.from_numpy(_tokens(cfg, 1, S, seed=8))
    logits_p, _ = m.prefill(p, {"tokens": toks})
    caches = m.init_decode_caches(1, S)
    for t in range(S):
        lg, caches = m.decode_step(p, caches, toks[:, t:t + 1])
    torch.testing.assert_close(logits_p, lg, atol=3e-4, rtol=3e-4)


def test_reference_decode_caches_have_the_ports_tree(lm):
    cfg_r, mr, _, cfg, m, _ = lm
    ref_c = mr.init_decode_caches(2, 40)
    port_c = convert.lm_caches_to_jax(m.init_decode_caches(2, 40))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_c)
    port_leaves = jax.tree_util.tree_leaves_with_path(port_c)
    assert [k for k, _ in ref_leaves] == [k for k, _ in port_leaves]
    for (_, a), (_, b) in zip(ref_leaves, port_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
