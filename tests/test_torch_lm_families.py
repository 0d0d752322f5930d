"""The LM families of slice G3 against the reference on the CPU, each at its
reduced size in f32, from the reference's params (``convert``) and inputs
drawn with numpy:

* gemma3 (sliding and full layers, ``qk_norm``, the local RoPE table,
  ``embed_scale``), deepseek-v2 (MLA and MoE with shared experts), llama4
  (chunked attention, MoE, the vision stub), pixtral (the vision stub), a
  small hybrid built the same in both packages (one mamba layer with a
  dense MLP, one attention layer without RoPE with MoE: ``reduced()`` of
  jamba keeps no attention layer) and whisper (the encoder-decoder);
* per family: the param tree, ``model.loss`` and ``moe_aux`` at 128 tokens
  (the port's causal layers on K4's route: its autograd Function, whose
  plain versions run here; the reference's kernel-off route), prefill
  logits and every cache leaf at 32 tokens, 8 decode steps from the
  reference's caches, and one ``sgd_train_step``'s new params against the
  reference's (``jax.value_and_grad``);
* ``build()`` takes every config of ``all_archs()``.

Tolerances: logits, caches and hidden states atol/rtol 1e-4 (as
``test_torch_lm_model.py``); loss and aux 1e-5 relative; new params atol
1e-6 / rtol 1e-5 (as ``test_torch_lm_train.py``); cache indices exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as ref_configs  # noqa: E402
from repro.models import factory as ref_factory  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import factory  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

TOL = dict(atol=1e-4, rtol=1e-4)
KEY = jax.random.PRNGKey(0)
FAMILIES = ["gemma3-27b", "deepseek-v2-236b", "llama4-maverick-400b-a17b",
            "pixtral-12b", "hybrid", "whisper-tiny"]
S_LOSS, S_PREFILL, DECODE_STEPS, B, LR = 128, 32, 8, 2, 0.1


def _hybrid(pkg):
    """jamba's reduced mamba + dense layer, then an attention layer (no
    RoPE, as jamba's) with jamba's reduced MoE."""
    base = pkg.get_arch("jamba-v0.1-52b").reduced()
    attn = pkg.LayerSpec(kind="attn", mlp=base.pattern[1].mlp, attn=pkg.AttentionSpec(
        num_heads=4, num_kv_heads=1, head_dim=64, rope=False))
    return dataclasses.replace(base, name="hybrid-small", pattern=(base.pattern[0], attn))


def _cfg(pkg, name):
    return _hybrid(pkg) if name == "hybrid" else pkg.get_arch(name).reduced()


_CACHE = {}


def _family(name):
    """(ref cfg, ref model, ref params, port cfg, port model, port params)."""
    if name not in _CACHE:
        cfg_r, cfg = _cfg(ref_configs, name), _cfg(configs, name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_r)
        mr, m = ref_factory.build(cfg_r), factory.build(cfg)
        pr = jax.jit(mr.init)(KEY)
        p = convert.lm_params_from_jax(jax.tree.map(np.asarray, pr), "cpu")
        _CACHE[name] = (cfg_r, mr, pr, cfg, m, p)
    return _CACHE[name]


def _batch(cfg, S, seed):
    """numpy inputs: tokens, labels (the vision stub's positions -1), and
    ``frontend`` or ``frames`` embeddings."""
    rng = np.random.default_rng(seed)
    ft = cfg.frontend_tokens if cfg.frontend != "none" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S - ft)).astype(np.int32)}
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, :ft] = -1
    out["labels"] = labels
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder.source_len, cfg.d_model)).astype(np.float32)
    elif ft:
        out["frontend"] = rng.standard_normal((B, ft, cfg.d_model)).astype(np.float32)
    return out


def _ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(port_tree, ref_tree):
    leaves_r = jax.tree_util.tree_leaves_with_path(ref_tree)
    leaves = jax.tree_util.tree_leaves_with_path(port_tree)
    assert [k for k, _ in leaves_r] == [k for k, _ in leaves]
    for (path, a), (_, b) in zip(leaves_r, leaves):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype == np.int32:
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=str(path))
        else:
            np.testing.assert_allclose(b, np.asarray(a), err_msg=str(path), **TOL)


def test_build_takes_every_registered_config():
    for name, cfg in configs.all_archs().items():
        assert factory.build(cfg).cfg.name == name
        assert factory.build(cfg.reduced()).cfg.name == cfg.reduced().name
    assert factory._unsupported(_hybrid(configs)) == ""


@pytest.mark.parametrize("name", FAMILIES)
def test_init_gives_the_references_tree(name):
    cfg_r, mr, pr, cfg, m, _ = _family(name)
    p = m.init(torch.Generator().manual_seed(0))
    leaves_r = jax.tree_util.tree_leaves_with_path(pr)
    leaves = jax.tree_util.tree_leaves_with_path(convert.lm_params_to_jax(p))
    assert [k for k, _ in leaves_r] == [k for k, _ in leaves]
    for (path, a), (_, b) in zip(leaves_r, leaves):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    # and the reference's tree crosses back bit for bit
    back = convert.lm_params_to_jax(_family(name)[5])
    for a, b in zip(jax.tree.leaves(pr), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_moe_aux_match_the_reference(name):
    cfg_r, mr, pr, cfg, m, p = _family(name)
    batch = _batch(cfg, S_LOSS, seed=1)
    loss_r, met_r = jax.jit(mr.loss)(pr, _ref(batch))
    loss, met = m.loss(p, _port(batch))
    assert float(loss) == pytest.approx(float(loss_r), rel=1e-5)
    assert float(met["loss"]) == pytest.approx(float(met_r["loss"]), rel=1e-5)
    assert float(met["moe_aux"]) == pytest.approx(float(met_r["moe_aux"]), rel=1e-5)
    has_moe = any(s.mlp.kind == "moe" for s in cfg.all_layers())
    assert (float(met["moe_aux"]) > 0) == has_moe


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_steps_match_the_reference(name):
    cfg_r, mr, pr, cfg, m, p = _family(name)
    batch = _batch(cfg, S_PREFILL, seed=2)
    batch.pop("labels")
    ctx = S_PREFILL + DECODE_STEPS
    rb, pb = _ref(batch), _port(batch)
    if cfg.encoder is not None:
        rb["seq_len"] = pb["seq_len"] = ctx
        lg_r, c_r = mr.prefill(pr, rb)
    else:
        lg_r, c_r = jax.jit(mr.prefill)(pr, rb)
    lg, c = m.prefill(p, pb)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), **TOL)
    _assert_tree_close(convert.lm_caches_to_jax(c), c_r)
    # decode on from the reference's caches (converted: bit for bit across
    # and back), greedy tokens
    c = convert.lm_caches_from_jax(jax.tree.map(np.asarray, c_r), "cpu")
    for a, b in zip(jax.tree.leaves(c_r), jax.tree.leaves(convert.lm_caches_to_jax(c))):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), b)
    step_r = jax.jit(mr.decode_step)
    tok = np.asarray(jnp.argmax(lg_r[:, -1:], -1)).astype(np.int32)
    for _ in range(DECODE_STEPS):
        lg_r, c_r = step_r(pr, c_r, jnp.asarray(tok))
        lg, c = m.decode_step(p, c, torch.from_numpy(tok))
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), **TOL)
        tok = np.asarray(jnp.argmax(lg_r[:, -1:], -1)).astype(np.int32)
    _assert_tree_close(convert.lm_caches_to_jax(c), c_r)


@pytest.mark.parametrize("name", FAMILIES)
def test_sgd_train_step_matches_the_reference(name):
    cfg_r, mr, pr, cfg, m, p = _family(name)
    batch = _batch(cfg, S_LOSS, seed=3)
    new_r, met_r = jax.jit(mr.sgd_train_step)(pr, _ref(batch), LR)
    new, met = m.sgd_train_step(p, _port(batch), LR)
    assert float(met["total_loss"]) == pytest.approx(float(met_r["total_loss"]), rel=1e-5)
    leaves_r = jax.tree_util.tree_leaves_with_path(new_r)
    leaves = jax.tree_util.tree_leaves_with_path(convert.lm_params_to_jax(new))
    assert [k for k, _ in leaves_r] == [k for k, _ in leaves]
    moved = 0
    for (path, a), (_, b), old in zip(leaves_r, leaves, jax.tree.leaves(pr)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, rtol=1e-5,
                                   err_msg=str(path))
        moved += not np.array_equal(np.asarray(a), np.asarray(old))
    assert moved > len(leaves) // 2
