"""The port's schedules and optimizers (``repro_torch.optim``) against the
reference's (``repro.optim``) on the CPU, from the same numpy params and
gradients.

Schedules: steps 0 .. 40, rtol 1e-6 (f32 arithmetic in another order:
``cos``/``pow`` in torch and XLA). Optimizers: five updates of a small
param tree with fresh gradients each step; f32 leaves within rtol 1e-6 /
atol 1e-7 (one f32 rounding per op, XLA may fuse into FMAs), bf16 leaves
within one bf16 ulp of the reference's result (atol 2**-7 relative: the
two frameworks round the same f32 values, but the f32 values can differ in
their last bit); AdamW's moments and step as converted state
(``convert.opt_state_from_jax``) between the steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import constant as ref_constant  # noqa: E402
from repro.optim import cosine as ref_cosine  # noqa: E402
from repro.optim import exponential_decay as ref_exp  # noqa: E402
from repro.optim import sgd as ref_sgd  # noqa: E402
from repro.optim import warmup_cosine as ref_warmup_cosine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    adamw,
    constant,
    cosine,
    exponential_decay,
    sgd,
    warmup_cosine,
)
from _torch_threads import _worker_threads  # noqa: E402,F401

STEPS = 5
SCHEDULES = [
    ("constant", lambda m: m.constant(0.3)),
    ("exponential_decay", lambda m: m.exponential_decay(0.1, 0.998)),
    ("cosine", lambda m: m.cosine(0.5, 30, 0.01)),
    ("warmup_cosine", lambda m: m.warmup_cosine(1.0, 10, 35)),
    ("warmup_cosine_min", lambda m: m.warmup_cosine(3e-3, 3, 30, 1e-4)),
]


class _Ns:
    def __init__(self, **fns):
        self.__dict__.update(fns)


REF = _Ns(constant=ref_constant, exponential_decay=ref_exp, cosine=ref_cosine,
          warmup_cosine=ref_warmup_cosine)
PORT = _Ns(constant=constant, exponential_decay=exponential_decay, cosine=cosine,
           warmup_cosine=warmup_cosine)


@pytest.mark.parametrize("name,make", SCHEDULES, ids=[n for n, _ in SCHEDULES])
def test_schedule_matches_reference(name, make):
    ref, port = make(REF), make(PORT)
    steps = np.arange(41, dtype=np.int32)
    got = port(torch.from_numpy(steps))
    assert got.dtype == torch.float32 and got.shape == (41,)
    exp = np.stack([np.asarray(ref(jnp.asarray(s))) for s in steps])
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-6, atol=1e-9)
    # a 0-d step gives a 0-d rate, as the drivers pass it
    assert port(torch.tensor(7)).shape == ()


OPTIMIZERS = [
    ("sgd", lambda m: m.sgd()),
    ("sgd_m0.9", lambda m: m.sgd(momentum=0.9)),
    ("sgd_nesterov", lambda m: m.sgd(momentum=0.9, nesterov=True)),
    ("adamw", lambda m: m.adamw()),
    ("adamw_wd", lambda m: m.adamw(weight_decay=0.01)),
]
OPT_REF = _Ns(sgd=ref_sgd, adamw=ref_adamw)
OPT_PORT = _Ns(sgd=sgd, adamw=adamw)


def _tree(rng, dtype):
    """A small param-shaped tree: a dict, a tuple of stacked leaves."""
    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tree = {"embed": leaf(16, 8), "blocks": ({"w": leaf(2, 8, 4), "b": leaf(2, 4)},),
            "norm": leaf(8)}
    if dtype == "bfloat16":
        import ml_dtypes

        tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
    return tree


def _to_port(tree):
    return convert.lm_params_from_jax(tree, "cpu")


def _assert_tree_close(got_np, exp, dtype, what):
    for (path, e), g in zip(jax.tree_util.tree_leaves_with_path(exp),
                            jax.tree.leaves(got_np)):
        e32, g32 = np.asarray(e, np.float32), np.asarray(g, np.float32)
        assert np.asarray(g).dtype == np.asarray(e).dtype, (what, path)
        if dtype == "bfloat16":
            np.testing.assert_allclose(g32, e32, rtol=2**-7, atol=1e-6,
                                       err_msg=f"{what} {path}")
        else:
            np.testing.assert_allclose(g32, e32, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{what} {path}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,make", OPTIMIZERS, ids=[n for n, _ in OPTIMIZERS])
def test_optimizer_steps_match_reference(name, make, dtype):
    """Five updates from the same params and gradients, each port step
    started from the reference's params and state of the step before."""
    rng = np.random.default_rng(3)
    ref_opt, opt = make(OPT_REF), make(OPT_PORT)
    params = _tree(rng, dtype)
    ref_params = jax.tree.map(jnp.asarray, params)
    ref_state = ref_opt.init(ref_params)
    state = opt.init(_to_port(params))
    if name.startswith("adamw"):
        assert state["t"].dtype == torch.int32 and state["t"].shape == ()
        assert all(m.dtype == np.float32 for m in jax.tree.leaves(
            convert.opt_state_to_jax(state)["m"]))
    lr = 0.05
    for step in range(STEPS):
        grads = _tree(rng, dtype)
        ref_new, ref_state_new = ref_opt.update(
            ref_params, jax.tree.map(jnp.asarray, grads), ref_state, lr)
        port_params = _to_port(jax.tree.map(np.asarray, ref_params))
        port_state = convert.opt_state_from_jax(jax.tree.map(np.asarray, ref_state), "cpu")
        new, new_state = opt.update(port_params, _to_port(grads), port_state, lr)
        _assert_tree_close(convert.lm_params_to_jax(new),
                           jax.tree.map(np.asarray, ref_new), dtype, f"{name} step {step}")
        if ref_state_new:
            got_state = convert.opt_state_to_jax(new_state)
            for key in ("m", "v"):
                if key in ref_state_new:
                    _assert_tree_close(got_state[key],
                                       jax.tree.map(np.asarray, ref_state_new[key]),
                                       "float32" if name.startswith("adamw") else dtype,
                                       f"{name} {key} step {step}")
            if "t" in ref_state_new:
                assert int(got_state["t"]) == int(ref_state_new["t"]) == step + 1
        ref_params, ref_state = ref_new, ref_state_new
    # the updates moved the params
    first = np.asarray(params["embed"], np.float32)
    assert not np.allclose(np.asarray(ref_params["embed"], np.float32), first)


def _quad_loss(params):
    return torch.sum((params["w"] - 3.0) ** 2)


@pytest.mark.parametrize("name,make", OPTIMIZERS[:2] + OPTIMIZERS[3:4],
                         ids=["sgd", "sgd_m0.9", "adamw"])
def test_optimizers_converge_quadratic(name, make):
    """The analogue of ``tests/test_data_optim.py::
    test_optimizers_converge_quadratic``."""
    opt = make(OPT_PORT)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(_quad_loss({"w": w}), (w,))
        params, state = opt.update(params, {"w": g}, state, 0.1)
    assert float(_quad_loss(params)) < 1e-3
