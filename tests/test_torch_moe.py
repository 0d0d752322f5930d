"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the CPU, in f32, from the reference's params
(``convert.lm_params_from_jax``) and inputs drawn with numpy:

* the reference's ``test_moe.py`` cases as parity: outputs within atol/rtol
  1e-4, the count of dropped routes exact (``drop_frac`` within 1e-6),
  ``aux_loss`` and ``router_entropy`` within 1e-6 relative; drops at capacity factors 8, 1
  and 0.5, shared experts, the single-token group, the aux loss under a
  collapsed router;
* the top-k tie rule: ties go to the lower expert index, as ``lax.top_k``;
* the slot pool's per-row routing: one pool tick of the reduced
  deepseek-v2 (MLA + MoE) equals the reference's vmapped batch-1 tick on
  the same slots (logits within 1e-4, greedy tokens and indices exact);
* gradients: ``torch.func.vmap(grad)`` over a cohort equals a loop of
  single calls (1e-6), and a single call's gradients equal ``jax.grad`` of
  the reference's within 1e-4 of each leaf's max.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs.base import MoESpec as RefSpec  # noqa: E402
from repro.models import factory as ref_factory  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.serve import batching as ref_batching  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import MoESpec  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models import factory  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.serve import batching  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

TOL = dict(atol=1e-4, rtol=1e-4)
KEY = jax.random.PRNGKey(0)


def _specs(**kw):
    base = dict(num_experts=4, top_k=2, d_ff_expert=32, capacity_factor=2.0)
    base.update(kw)
    return RefSpec(**base), MoESpec(**base)


def _params(spec_r, d, key=KEY):
    pr = ref_moe.init_moe(key, d, spec_r, jnp.float32)
    return pr, convert.lm_params_from_jax(jax.tree.map(np.asarray, pr), "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


_ref_fwd = jax.jit(ref_moe.moe_fwd, static_argnums=(2, 3))


def _both(pr, p, x, spec_r, spec, group):
    y_r, m_r = _ref_fwd(pr, jnp.asarray(x), spec_r, group)
    y, m = M.moe_fwd(p, torch.from_numpy(x), spec, group_size=group)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    routes = x.shape[0] * x.shape[1] * spec.top_k
    kept = [round((1 - float(mm["drop_frac"])) * routes) for mm in (m, m_r)]
    assert kept[0] == kept[1]  # the same number of routes dropped
    assert float(m["drop_frac"]) == pytest.approx(float(m_r["drop_frac"]), abs=1e-6)
    for name in ("aux_loss", "router_entropy"):
        assert float(m[name]) == pytest.approx(float(m_r[name]), rel=1e-6), name
    return y, m


CASES = {
    "base": (dict(), (2, 8, 16), 8),
    "cf8": (dict(capacity_factor=8.0), (2, 16, 16), 16),
    "cf1": (dict(capacity_factor=1.0), (2, 32, 16), 32),
    "cf0.5": (dict(capacity_factor=0.5), (2, 32, 16), 32),
    "shared": (dict(num_shared=1, d_ff_shared=32), (1, 8, 16), 8),
    "top1_shared": (dict(top_k=1, num_shared=2, d_ff_shared=16), (2, 24, 16), 8),
    "top6_of_16": (dict(num_experts=16, top_k=6, capacity_factor=1.25), (1, 64, 16), 32),
    "decode_group": (dict(), (1, 1, 16), 128),
    "groups_of_one": (dict(capacity_factor=1.0), (4, 1, 16), 1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_moe_fwd_matches_the_reference(name):
    kw, shape, group = CASES[name]
    spec_r, spec = _specs(**kw)
    pr, p = _params(spec_r, shape[-1])
    y, m = _both(pr, p, _x(shape, seed=len(name)), spec_r, spec, group)
    assert y.shape == shape and bool(torch.isfinite(y).all())
    assert float(m["aux_loss"]) > 0


def test_init_matches_the_reference_tree():
    spec_r, spec = _specs(num_shared=2, d_ff_shared=8)
    pr, _ = _params(spec_r, 16)
    p = M.init_moe(torch.Generator().manual_seed(0), 16, spec, torch.bfloat16)
    assert sorted(p) == sorted(pr)
    for k in p:
        assert tuple(p[k].shape) == pr[k].shape, k
    assert p["router"].dtype == torch.float32  # the router stays f32
    assert {p[k].dtype for k in p if k != "router"} == {torch.bfloat16}


def test_capacity_drops_monotone_and_equal_to_the_reference():
    x = _x((2, 32, 16), seed=3)
    drops = []
    for cf in (8.0, 1.0, 0.5):
        spec_r, spec = _specs(capacity_factor=cf)
        pr, p = _params(spec_r, 16)
        _, m = _both(pr, p, x, spec_r, spec, 32)
        drops.append(float(m["drop_frac"]))
    assert drops[0] == 0.0 and drops[0] <= drops[1] <= drops[2] and drops[2] > 0


def test_equals_dense_expert_mix_when_no_drop():
    spec_r, spec = _specs(capacity_factor=8.0)
    _, p = _params(spec_r, 16)
    xt = torch.from_numpy(_x((8, 16), seed=4))
    y, m = M.moe_fwd(p, xt[None], spec, group_size=8)
    assert float(m["drop_frac"]) == 0.0
    gk, ik = M.top_k(torch.softmax(xt @ p["router"], -1), spec.top_k)
    gk = gk / gk.sum(-1, keepdim=True)
    expect = torch.zeros_like(xt)
    for t in range(8):
        for j in range(spec.top_k):
            e = int(ik[t, j])
            h = xt[t] @ p["w_in"][e]
            g = xt[t] @ p["w_gate"][e]
            expect[t] += gk[t, j] * ((torch.nn.functional.silu(g) * h) @ p["w_out"][e])
    torch.testing.assert_close(y[0], expect, **TOL)


def test_shared_experts_contribute():
    spec_r, spec = _specs(num_shared=1, d_ff_shared=32)
    _, p = _params(spec_r, 16)
    x = torch.from_numpy(_x((1, 8, 16), seed=5))
    y1, _ = M.moe_fwd(p, x, spec, group_size=8)
    y2, _ = M.moe_fwd({**p, "shared_out": torch.zeros_like(p["shared_out"])}, x, spec,
                      group_size=8)
    assert float((y1 - y2).abs().max()) > 1e-6


def test_aux_loss_penalizes_imbalance_as_the_reference():
    spec_r, spec = _specs(top_k=1)
    pr, p = _params(spec_r, 16)
    x = _x((1, 64, 16), seed=6)
    bias = np.zeros((16, 4), np.float32)
    bias[:, 0] = 10.0
    _, m_uniform = _both(pr, p, x, spec_r, spec, 64)
    _, m_collapsed = _both({**pr, "router": jnp.asarray(bias)},
                           {**p, "router": torch.from_numpy(bias)}, x, spec_r, spec, 64)
    assert float(m_collapsed["aux_loss"]) > float(m_uniform["aux_loss"])


def test_top_k_ties_go_to_the_lower_index():
    rng = np.random.default_rng(7)
    probs = rng.integers(0, 3, (64, 16)).astype(np.float32) / 4  # many ties
    for k in (1, 2, 6, 16):
        v_r, i_r = jax.lax.top_k(jnp.asarray(probs), k)
        v, i = M.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_r))
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_r))
    # a zero router ties every expert: every token picks experts 0 .. K-1
    spec_r, spec = _specs(capacity_factor=1.0)
    pr, p = _params(spec_r, 16)
    _, m = _both({**pr, "router": jnp.zeros((16, 4))}, {**p, "router": torch.zeros(16, 4)},
                 _x((1, 16, 16), seed=8), spec_r, spec, 16)
    # experts 0 and 1 each take 16 routes and keep C = 8
    assert float(m["drop_frac"]) == 0.5


def test_pool_tick_routes_each_row_as_the_references_vmapped_tick():
    """The reduced deepseek-v2 (MLA + MoE): four slots prefilled with
    prompts of 2..5 tokens, then three pool ticks, against the reference's
    ``slot_decode_fn`` (``vmap`` of its batch-1 step) on the same slots."""
    cfg_r, cfg = ref_get_arch("deepseek-v2-236b").reduced(), get_arch(
        "deepseek-v2-236b").reduced()
    mr, m = ref_factory.build(cfg_r), factory.build(cfg)
    pr = mr.init(jax.random.PRNGKey(1))
    p = convert.lm_params_from_jax(jax.tree.map(np.asarray, pr), "cpu")
    S, ctx = 4, 12
    rng = np.random.default_rng(9)
    pool_r = ref_batching.init_slot_pool(mr, S, ctx)
    pool = batching.init_slot_pool(m, S, ctx, "cpu")
    step_r = jax.jit(mr.decode_step)
    toks = []
    for s in range(S):
        prompt = rng.integers(0, cfg.vocab_size, (1, s + 2)).astype(np.int32)
        one = mr.init_decode_caches(1, ctx)
        for t in range(prompt.shape[1]):  # one jitted step for every prompt length
            lg, one = step_r(pr, one, jnp.asarray(prompt[:, t:t + 1]))
        pool_r = ref_batching.write_slot(pool_r, s, one)
        batching.write_slot(pool, s, convert.lm_caches_from_jax(
            jax.tree.map(np.asarray, one), "cpu"))
        toks.append(int(jnp.argmax(lg[0, -1])))
    tick_r, tick = ref_batching.slot_decode_fn(mr), batching.slot_decode_fn(m)
    tok = np.asarray(toks, np.int32)[:, None]
    with torch.no_grad():
        for _ in range(3):
            lg_r, pool_r = tick_r(pr, pool_r, jnp.asarray(tok)[:, :, None])
            lg, pool = tick(p, pool, torch.from_numpy(tok))
            np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r)[:, 0], **TOL)
            nxt = lg[:, -1].argmax(-1).numpy()
            np.testing.assert_array_equal(nxt, np.asarray(lg_r)[:, 0, -1].argmax(-1))
            tok = nxt.astype(np.int32)[:, None]
    for s in range(S):
        one_r = ref_batching.read_slot(pool_r, s)
        one = convert.lm_caches_to_jax(batching.read_slot(pool, s))
        for a, b in zip(jax.tree.leaves(one_r), jax.tree.leaves(one)):
            if a.dtype == np.int32:
                np.testing.assert_array_equal(b, np.asarray(a))
            else:
                np.testing.assert_allclose(b, np.asarray(a), **TOL)


def _loss_t(p, x, spec):
    y, m = M.moe_fwd(p, x, spec, group_size=8)
    return (y * y).sum() + m["aux_loss"]


def test_vmap_grad_over_a_cohort_equals_a_loop_and_jax_grad():
    spec_r, spec = _specs(num_shared=1, d_ff_shared=16, capacity_factor=1.0)
    pr, p = _params(spec_r, 16)
    xs = torch.from_numpy(_x((3, 2, 8, 16), seed=10))
    grad = torch.func.grad(_loss_t)
    batched = torch.func.vmap(grad, in_dims=(None, 0, None))(p, xs, spec)
    for c in range(3):
        single = grad(p, xs[c], spec)
        for k in p:
            torch.testing.assert_close(batched[k][c], single[k], rtol=1e-6, atol=1e-6)

    def loss_r(pr_, x_):
        y, m = ref_moe.moe_fwd(pr_, x_, spec_r, group_size=8)
        return (y * y).sum() + m["aux_loss"]

    g_r = jax.jit(jax.grad(loss_r))(pr, jnp.asarray(xs[0].numpy()))
    single = grad(p, xs[0], spec)
    for k in p:
        exp = np.asarray(g_r[k])
        err = np.abs(single[k].numpy() - exp).max()
        assert err <= 1e-4 * max(np.abs(exp).max(), 1e-30), (k, err)
    assert len(tree_leaves(single)) == len(p)
