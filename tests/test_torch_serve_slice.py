"""The serve flow of the port against the reference, at reduced size
(tinyllama-1.1b reduced, f32, the reference's params converted):

* the reference's ``prefill_tokens`` plus a greedy decode loop, and the
  port's ``launch.serve.serve`` at temperature 0, over the same prompts:
  the generated tokens are equal for 32 steps at batch 4;
* the port's ``prefill_tokens`` is bitwise the per-token decode loop (the
  analogue of ``test_serve.py::test_prefill_scan_matches_per_token_loop``);
* the trees and weights carry LM state: ``tree_map``/``tree_leaves`` over
  tuples and lists, and bf16 leaves bit for bit through ``convert``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import factory as ref_factory  # noqa: E402
from repro.serve.batching import prefill_tokens as ref_prefill_tokens  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import factory  # noqa: E402
from repro_torch.serve.batching import prefill_tokens  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

ARCH = "tinyllama-1.1b"
B, PROMPT, GEN = 4, 8, 32


@pytest.fixture(scope="module")
def ref_run():
    """The reference serve flow: params, prompts, greedy tokens, and the
    per-step logits (B, GEN, V)."""
    cfg = ref_get_arch(ARCH).reduced()
    model = ref_factory.build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    caches = model.init_decode_caches(B, PROMPT + GEN)
    logits, caches = jax.jit(
        lambda p, c, t: ref_prefill_tokens(model.decode_step, p, c, t)
    )(params, caches, jnp.asarray(prompts))
    step = jax.jit(model.decode_step)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    tokens, step_logits = [], []
    for _ in range(GEN):
        tokens.append(np.asarray(tok)[:, 0])
        logits, caches = step(params, caches, tok)
        step_logits.append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    return {"params": jax.tree.map(np.asarray, params), "prompts": prompts,
            "tokens": np.stack(tokens, 1), "logits": np.stack(step_logits, 1)}


def test_greedy_serve_matches_the_reference(ref_run):
    cfg = get_arch(ARCH).reduced()
    params = convert.lm_params_from_jax(ref_run["params"], "cpu")
    res = serve_mod.serve(cfg, B, PROMPT, GEN, temperature=0.0, device="cpu",
                          params=params, prompts=torch.from_numpy(ref_run["prompts"]))
    assert res.tokens.shape == (B, GEN)
    # no top-2 gap of the reference's logits is within float noise, so the
    # greedy tokens must agree exactly
    top2 = np.sort(ref_run["logits"], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-4
    np.testing.assert_array_equal(res.tokens, ref_run["tokens"])


def test_prefill_tokens_is_the_per_token_loop(ref_run):
    cfg = get_arch(ARCH).reduced()
    model = factory.build(cfg)
    params = convert.lm_params_from_jax(ref_run["params"], "cpu")
    prompts = torch.from_numpy(ref_run["prompts"][:2, :6])
    lg_scan, c_scan = prefill_tokens(model.decode_step, params,
                                     model.init_decode_caches(2, 16), prompts)
    c_loop = model.init_decode_caches(2, 16)
    for t in range(prompts.shape[1]):
        lg_loop, c_loop = model.decode_step(params, c_loop, prompts[:, t:t + 1])
    assert torch.equal(lg_scan, lg_loop)
    for a, b in zip(tree_leaves(c_scan), tree_leaves(c_loop)):
        assert torch.equal(a, b)


def test_sampling_is_seeded_and_the_driver_runs_on_cpu(capsys):
    res = serve_mod.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
                          "--gen", "6", "--temperature", "0.8"])
    again = serve_mod.serve(get_arch(ARCH).reduced(), 2, 4, 6, 0.8, device="cpu")
    assert np.array_equal(res.tokens, again.tokens)
    assert res.tokens.shape == (2, 6)
    assert ((0 <= res.tokens) & (res.tokens < 512)).all()
    assert "generated 2x6 tokens" in capsys.readouterr().out


def test_tree_ops_walk_tuples_and_lists():
    tree = {"blocks": (torch.ones(2), {"w": torch.zeros(3)}), "prefix": [torch.ones(1)]}
    doubled = tree_map(lambda t: t * 2, tree)
    assert isinstance(doubled["blocks"], tuple) and isinstance(doubled["prefix"], list)
    assert [t.tolist() for t in tree_leaves(doubled)] == [[2.0, 2.0], [0.0] * 3, [2.0]]
    summed = tree_map(lambda a, b: a + b, tree, doubled)
    assert [t.tolist() for t in tree_leaves(summed)] == [[3.0, 3.0], [0.0] * 3, [3.0]]


def test_bf16_params_round_trip_bit_for_bit():
    cfg = ref_get_arch(ARCH).reduced()
    cfg = type(cfg)(**{**cfg.__dict__, "param_dtype": "bfloat16",
                       "compute_dtype": "bfloat16"})
    ref_params = ref_factory.build(cfg).init(jax.random.PRNGKey(1))
    port = convert.lm_params_from_jax(ref_params, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(port))
    back = convert.lm_params_to_jax(port)
    for a, b in zip(jax.tree.leaves(ref_params), jax.tree.leaves(back)):
        assert b.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16), b.view(np.uint16))
    caches = ref_factory.build(cfg).init_decode_caches(2, 8)
    back_c = convert.lm_caches_to_jax(convert.lm_caches_from_jax(caches, "cpu"))
    for a, b in zip(jax.tree.leaves(caches), jax.tree.leaves(back_c)):
        assert b.dtype == np.asarray(a).dtype and b.shape == a.shape
