"""The port's CNN, local update and aggregators against the reference on
the reference's own initialized params (converted). Tolerances: f32
convolution sums in another order in torch than in XLA, so forward, loss
and gradient are allclose at rtol 1e-5 / atol 1e-5; a local update
compounds that over its SGD steps (rtol 1e-4 / atol 1e-5)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_cnn import MNIST_CNN as REF_MNIST  # noqa: E402
from repro.data import synthetic as ref_synth, partition as ref_part  # noqa: E402
from repro.engine import aggregators as ref_agg  # noqa: E402
from repro.fl.client import make_local_update as ref_make_local_update  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.configs.paper_cnn import MNIST_CNN  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.draws import ReplayDraws  # noqa: E402
from repro_torch.data import synthetic as pt_synth, partition as pt_part  # noqa: E402
from repro_torch.engine import aggregators as pt_agg  # noqa: E402
from repro_torch.fl.client import make_local_update  # noqa: E402
from repro_torch.models import cnn as pt_cnn  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_tree_close(pt_tree, ref_tree, **tol):
    got = dict(_leaves(params_to_jax(pt_tree)))
    for name, ref in _leaves(ref_tree):
        np.testing.assert_allclose(got[name], ref, err_msg=name, **tol)


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray, ref_cnn.init_params(jax.random.PRNGKey(0), REF_MNIST))


@pytest.fixture(scope="module")
def data():
    train, _ = ref_synth.load_dataset("mnist", seed=0, scale=0.01)
    return train.images[:8], train.labels[:8]


def test_copied_data_modules_give_the_same_arrays():
    a_tr, a_te = ref_synth.load_dataset("mnist", seed=3, scale=0.01)
    b_tr, b_te = pt_synth.load_dataset("mnist", seed=3, scale=0.01)
    np.testing.assert_array_equal(a_tr.images, b_tr.images)
    np.testing.assert_array_equal(a_te.labels, b_te.labels)
    np.testing.assert_array_equal(
        ref_part.partition_iid(len(a_tr.labels), 7, 3),
        pt_part.partition_iid(len(b_tr.labels), 7, 3))
    np.testing.assert_array_equal(
        ref_part.partition_dirichlet(a_tr.labels, 5, 0.6, 3),
        pt_part.partition_dirichlet(b_tr.labels, 5, 0.6, 3))
    assert dataclasses.astuple(MNIST_CNN) == dataclasses.astuple(REF_MNIST)


def test_init_params_from_replayed_normals(ref_params):
    """init_params draws its normals at params/<layer>; fed the reference's
    normals (models/cnn.py: split(key, 4)), it returns its params."""
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    shapes = {k: v["w"].shape for k, v in ref_params.items()}
    init = {f"params/{name}": np.asarray(jax.random.normal(kk, shapes[name]))
            for name, kk in zip(("conv1", "conv2", "fc1", "fc2"), ks)}
    params = pt_cnn.init_params(ReplayDraws(init, [], "cpu"), MNIST_CNN)
    _assert_tree_close(params, ref_params, rtol=0, atol=0)


def test_forward_loss_grad_allclose(ref_params, data):
    x, y = data
    ref_logits = ref_cnn.forward(ref_params, jnp.asarray(x))
    params = params_from_jax(ref_params, "cpu")
    logits = pt_cnn.forward(params, torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), **TOL)

    def ref_loss(p):
        return ref_cnn.loss_and_acc(p, jnp.asarray(x), jnp.asarray(y))[0]

    loss_r, g_r = jax.value_and_grad(ref_loss)(ref_params)
    from torch.func import grad_and_value

    g_p, loss_p = grad_and_value(
        lambda p: pt_cnn.loss_and_acc(p, torch.from_numpy(x),
                                      torch.from_numpy(y).long())[0])(params)
    np.testing.assert_allclose(float(loss_p), float(loss_r), **TOL)
    _assert_tree_close(g_p, g_r, **TOL)


def test_local_update_allclose(ref_params, data):
    """One cohort of 3 slots, each from the same params with its own shard,
    permutations and lr."""
    x, y = data
    B, examples, epochs, batch = 3, 4, 2, 3
    rng = np.random.default_rng(0)
    sx = np.stack([x[rng.permutation(8)[:examples]] for _ in range(B)])
    sy = np.stack([y[rng.permutation(8)[:examples]] for _ in range(B)])
    lr = np.array([0.05, 0.02, 0.1], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), B)

    def loss_fn(p, b):
        return ref_cnn.loss_and_acc(p, b["x"], b["y"])[0]

    ref_update = ref_make_local_update(loss_fn, epochs, batch, examples)
    stacked = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), ref_params)
    ref_new, ref_loss = jax.vmap(ref_update)(
        stacked, {"x": jnp.asarray(sx), "y": jnp.asarray(sy)}, keys, jnp.asarray(lr))
    # the reference's per-slot, per-epoch permutations (fl/client.py:26-27)
    perms = np.stack([
        np.stack([np.asarray(jax.random.permutation(ke, examples))
                  for ke in jax.random.split(kb, epochs)])
        for kb in keys])
    draws = ReplayDraws({}, [{"local_perm": perms}], "cpu").step(0)

    def pt_loss(p, b):
        return pt_cnn.cross_entropy(pt_cnn.forward(p, b["x"]), b["y"])

    update = make_local_update(pt_loss, epochs, batch, examples)
    params = params_from_jax(ref_params, "cpu")
    stacked_p = {k: {kk: vv[None].expand((B,) + vv.shape).clone()
                     for kk, vv in v.items()} for k, v in params.items()}
    new, loss = update(stacked_p, {"x": torch.from_numpy(sx),
                                   "y": torch.from_numpy(sy).long()},
                       draws, torch.from_numpy(lr))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref_loss), rtol=1e-4,
                               atol=1e-5)
    _assert_tree_close(new, jax.tree.map(np.asarray, ref_new), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,kw", [
    ("fedavg", {}), ("fedbuff", {}), ("fedbuff", {"staleness_mode": "const"}),
    ("fedprox", {"prox_mu": 0.3}),
])
@pytest.mark.parametrize("all_masked", [False, True])
def test_aggregators_allclose(name, kw, all_masked):
    rng = np.random.default_rng(1)
    B = 5
    g = {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
         "b": rng.normal(size=(6,)).astype(np.float32)}
    upd = jax.tree.map(lambda a: (a + rng.normal(size=(B,) + a.shape)).astype(np.float32), g)
    base = jax.tree.map(lambda a: (a + 0.1 * rng.normal(size=(B,) + a.shape))
                        .astype(np.float32), g)
    mask = np.zeros(B, bool) if all_masked else np.array([1, 0, 1, 1, 0], bool)
    stale = np.array([0, 3, 1, 2, 0], np.int32)
    ra = ref_agg.make_fedavg() if name == "fedavg" else (
        ref_agg.make_fedbuff(**kw) if name == "fedbuff" else ref_agg.make_fedprox(**kw))
    pa = pt_agg.make_fedavg() if name == "fedavg" else (
        pt_agg.make_fedbuff(**kw) if name == "fedbuff" else pt_agg.make_fedprox(**kw))
    w_r = ra.weigh(jnp.asarray(mask), jnp.asarray(stale))
    w_p = pa.weigh(torch.from_numpy(mask), torch.from_numpy(stale))
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_r), rtol=1e-6)
    out_r = ra.finalize(g, ra.accumulate(ra.init(g), upd, base, w_r))
    to_t = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    out_p = pa.finalize(to_t(g), pa.accumulate(pa.init(to_t(g)), to_t(upd),
                                               to_t(base), w_p))
    _assert_tree_close(out_p, out_r, rtol=1e-5, atol=1e-6)
    if all_masked:
        _assert_tree_close(out_p, g, rtol=0, atol=0)
