"""The port's MLA (multi-head latent attention, deepseek-v2) against the
reference's on the CPU, in f32, from the reference's params and inputs
drawn with numpy, within atol/rtol 1e-4 (indices exact):

* ``_mla_fwd`` at S = 24 (the direct route) and S = 256 with small blocks
  (the blocked online softmax): the key width D + dr is not the value
  width, so neither side reaches its attention kernel;
* ``_mla_decode`` absorbed and not, step by step over a ring that wraps,
  outputs and latent caches; the absorbed and decompressed routes agree,
  and decode equals the forward (the reference's ``test_attention.py``);
* the MLA prefill cache (``_write_prefill_cache``: ``c_kv``, the RoPE key
  ``k_rope`` and the index, in ring order) of the reduced deepseek-v2;
* a per-row (B,) index, each row at its own position, against the
  reference's decode of each row alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs.base import AttentionSpec as RefSpec  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import factory as ref_factory  # noqa: E402
from repro.models.common import rope_frequencies as ref_rope  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import AttentionSpec  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import factory  # noqa: E402
from repro_torch.models.common import rope_frequencies  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

TOL = dict(atol=1e-4, rtol=1e-4)
KEY = jax.random.PRNGKey(0)
D_MODEL = 64
SPECS = {
    "q_lora": dict(num_heads=4, num_kv_heads=4, head_dim=32, kv_lora=16, q_lora=24,
                   rope_dim=8),
    "no_q_lora": dict(num_heads=4, num_kv_heads=4, head_dim=32, kv_lora=16, rope_dim=8),
}


def _setup(name):
    kw = SPECS[name]
    spec_r, spec = RefSpec(**kw), AttentionSpec(**kw)
    pr = ref_attn.init_attention(KEY, D_MODEL, spec_r, jnp.float32)
    p = convert.lm_params_from_jax(jax.tree.map(np.asarray, pr), "cpu")
    inv_r, rot = ref_rope(spec.rope_dim, 10_000.0)
    inv, _ = rope_frequencies(spec.rope_dim, 10_000.0)
    return spec_r, spec, pr, p, ref_attn.RopeTable(inv_r, rot), A.RopeTable(inv, rot)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_init_matches_the_reference_tree():
    for name in SPECS:
        _, spec, pr, _, _, _ = _setup(name)
        p = A.init_attention(torch.Generator().manual_seed(0), D_MODEL, spec, torch.float32)
        assert sorted(p) == sorted(pr)
        assert all(tuple(p[k].shape) == pr[k].shape for k in p)


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("S", [24, 256])
def test_mla_fwd_matches_the_reference(name, S, monkeypatch):
    for mod in (ref_attn, A):  # small blocks: S = 256 takes the blocked route
        monkeypatch.setattr(mod, "FLASH_THRESHOLD", 128)
        monkeypatch.setattr(mod, "BLOCK_Q", 64)
        monkeypatch.setattr(mod, "BLOCK_K", 64)
    spec_r, spec, pr, p, tab_r, tab = _setup(name)
    x = _x((2, S, D_MODEL), seed=S)
    pos = np.arange(S, dtype=np.int32)
    out_r = ref_attn.attention_fwd(pr, jnp.asarray(x), spec_r, tab_r, jnp.asarray(pos))
    out = A.attention_fwd(p, torch.from_numpy(x), spec, tab, torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), **TOL)


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("absorb", [True, False], ids=["absorb", "decompress"])
def test_mla_decode_matches_the_reference(name, absorb):
    """12 steps into a ring of 8 slots (it wraps), from a zero cache."""
    spec_r, spec, pr, p, tab_r, tab = _setup(name)
    x = _x((2, 12, D_MODEL), seed=1)
    c_r = ref_attn.init_cache(spec_r, 2, 8, jnp.float32)
    c = A.init_cache(spec, 2, 8, torch.float32)
    step_r = jax.jit(lambda c_, x_: ref_attn.attention_decode(pr, x_, spec_r, tab_r, c_,
                                                              mla_absorb=absorb))
    for t in range(12):
        y_r, c_r = step_r(c_r, jnp.asarray(x[:, t:t + 1]))
        y, c = A.attention_decode(p, torch.from_numpy(x[:, t:t + 1]), spec, tab, c,
                                  mla_absorb=absorb)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    assert int(c["index"]) == int(c_r["index"]) == 12
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(c_r[key]), **TOL)


def test_absorbed_equals_decompressed_and_decode_equals_fwd():
    spec_r, spec, pr, p, tab_r, tab = _setup("no_q_lora")
    S = 8
    x = torch.from_numpy(_x((1, S, D_MODEL), seed=2))
    full = A._mla_fwd(p, x, spec, tab, torch.arange(S, dtype=torch.int32))
    c1, c2 = (A.init_cache(spec, 1, S, torch.float32) for _ in range(2))
    outs = []
    for t in range(S):
        y1, c1 = A._mla_decode(p, x[:, t:t + 1], spec, tab, c1, absorb=True)
        y2, c2 = A._mla_decode(p, x[:, t:t + 1], spec, tab, c2, absorb=False)
        torch.testing.assert_close(y1, y2, **TOL)
        outs.append(y1)
    torch.testing.assert_close(torch.cat(outs, 1), full, **TOL)


def test_per_row_index_matches_rows_decoded_alone():
    """Three rows at positions 0, 5 and 11 of a ring of 8 slots: a (B,)
    index against the reference's 0-d decode of each row."""
    spec_r, spec, pr, p, tab_r, tab = _setup("q_lora")
    rng = np.random.default_rng(3)
    ck = rng.standard_normal((3, 8, 16)).astype(np.float32)
    kr = rng.standard_normal((3, 8, 8)).astype(np.float32)
    idx = np.array([0, 5, 11], np.int32)
    cache = {"c_kv": torch.from_numpy(ck.copy()), "k_rope": torch.from_numpy(kr.copy()),
             "index": torch.from_numpy(idx.copy())}
    rows = [{"c_kv": jnp.asarray(ck[b:b + 1]), "k_rope": jnp.asarray(kr[b:b + 1]),
             "index": jnp.asarray(idx[b])} for b in range(3)]
    step_r = jax.jit(lambda c_, x_, a: ref_attn.attention_decode(pr, x_, spec_r, tab_r, c_,
                                                                 mla_absorb=a),
                     static_argnums=2)
    for t, absorb in enumerate((True, False, True, True)):
        x = _x((3, 1, D_MODEL), seed=10 + t)
        y, cache = A.attention_decode(p, torch.from_numpy(x), spec, tab, cache,
                                      mla_absorb=absorb)
        for b in range(3):
            y_r, rows[b] = step_r(rows[b], jnp.asarray(x[b:b + 1]), absorb)
            np.testing.assert_allclose(y[b:b + 1].numpy(), np.asarray(y_r), **TOL)
    for b in range(3):
        assert int(cache["index"][b]) == int(rows[b]["index"]) == idx[b] + 4
        np.testing.assert_allclose(cache["c_kv"][b].numpy(), np.asarray(rows[b]["c_kv"][0]),
                                   **TOL)


def test_prefill_caches_match_the_reference():
    """The reduced deepseek-v2's ``model.prefill``: logits and every cache
    leaf (MLA latents, RoPE keys, indices), then four decode steps per
    route."""
    cfg_r, cfg = ref_get_arch("deepseek-v2-236b").reduced(), get_arch(
        "deepseek-v2-236b").reduced()
    mr = ref_factory.build(cfg_r)
    pr = mr.init(KEY)
    p = convert.lm_params_from_jax(jax.tree.map(np.asarray, pr), "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    lg_r, c_r = jax.jit(mr.prefill)(pr, {"tokens": jnp.asarray(toks[:, :16])})
    for absorb in (True, False):
        m = factory.build(cfg, mla_absorb=absorb)
        lg, c = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :16])})
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), **TOL)
        leaves_r = jax.tree_util.tree_leaves_with_path(c_r)
        leaves = jax.tree_util.tree_leaves_with_path(convert.lm_caches_to_jax(c))
        assert [k for k, _ in leaves_r] == [k for k, _ in leaves]
        assert {str(k[-1]) for k, _ in leaves} >= {"['c_kv']", "['k_rope']"}
        for (_, a), (_, b) in zip(leaves_r, leaves):
            assert a.shape == b.shape and a.dtype == b.dtype
            if a.dtype == np.int32:
                np.testing.assert_array_equal(b, np.asarray(a))
            else:
                np.testing.assert_allclose(b, np.asarray(a), **TOL)
        mr_d = ref_factory.build(cfg_r, mla_absorb=absorb)
        step_r = jax.jit(mr_d.decode_step)
        cc_r = c_r
        for t in range(16, 20):
            l_r, cc_r = step_r(pr, cc_r, jnp.asarray(toks[:, t:t + 1]))
            l_, c = m.decode_step(p, c, torch.from_numpy(toks[:, t:t + 1]))
            np.testing.assert_allclose(l_.numpy(), np.asarray(l_r), **TOL)
