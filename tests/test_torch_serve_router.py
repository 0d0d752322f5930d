"""The serving tier's routers and replica accumulators against the
reference (``repro.serve.router``, ``repro.core.load_metric``):

* the registry: names and error messages;
* the markov router replayed (the reference's ``choice``/``uniform`` draws
  under its own keys fed through ``ReplayDraws``) makes the reference's
  decisions exactly, over a load vector that changes every decision; on a
  1-replica pool its admissions are the port's markov selection policy's
  selections under the same draws;
* least-loaded-willing routing, dead-replica masking (+inf load) in all
  three routers, ``penalized_load`` against the reference's;
* the replica accumulators against the reference's on one assignment
  sequence: counts exact, moments allclose at rtol 1e-6 (both are f32
  Kahan pairs; the sums are integers below 2^24, so they agree exactly).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import load_metric as ref_lm  # noqa: E402
from repro.serve import router as ref_router  # noqa: E402
from repro_torch.core import load_metric, selection  # noqa: E402
from repro_torch.core.draws import GeneratorDraws, ReplayDraws  # noqa: E402
from repro_torch.serve import router as pt_router  # noqa: E402
from repro_torch.serve import make_router, penalized_load, router_names  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

BUILTINS = {"round_robin", "least_loaded", "markov"}


def _messages(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_registry_names_and_messages():
    assert BUILTINS <= set(router_names())
    assert BUILTINS <= set(ref_router.router_names())
    load = torch.zeros((3,))
    for name in BUILTINS:
        router = make_router(name, 3)
        assert router.name == name
        state = router.init(GeneratorDraws(0, "cpu"), 3)
        idx, state = router.step(state, load, GeneratorDraws(1, "cpu"))
        assert idx.dtype == torch.int32 and idx.shape == ()
        assert -1 <= int(idx) < 3
    got = _messages(lambda: make_router("nope", 3))
    want = _messages(lambda: ref_router.make_router("nope", 3))
    assert got.split("registered:")[0] == want.split("registered:")[0]
    assert got.startswith("unknown router 'nope'; registered: [")
    pt_router.register_router("_torch_test_dummy")(lambda r: make_router("round_robin", r))
    with pytest.raises(ValueError, match="router '_torch_test_dummy' already registered"):
        pt_router.register_router("_torch_test_dummy")(lambda r: None)


def _replay_router(key, R, m, probs, decisions):
    """The reference router's draws under its keys: ``choice`` at init from
    ``key``, decision d's uniform from ``fold_in(key, d)``."""
    pi = jnp.asarray(ref_lm.steady_state(probs).astype(np.float32))
    init = {"router/policy_init": np.asarray(jax.random.choice(key, m + 1, (R,), p=pi))}
    steps = [{"router/select": np.asarray(jax.random.uniform(jax.random.fold_in(key, d),
                                                             (R,)))}
             for d in range(decisions)]
    return ReplayDraws(init, steps, "cpu").sub("router")


@pytest.mark.parametrize("R,m,probs", [
    (4, 3, np.array([0.1, 0.4, 0.8, 1.0], np.float32)),
    (3, 10, None),  # the Theorem-2 chain for n := 3, k := 1
])
def test_markov_router_replayed_equals_reference(R, m, probs):
    key = jax.random.PRNGKey(5)
    T = 120
    p = (np.asarray(ref_lm.optimal_probs(R, 1, m)) if probs is None
         else probs).astype(np.float32)
    ref = ref_router.make_router("markov", R, m=m, probs=probs)
    port = make_router("markov", R, m=m, probs=probs)
    draws = _replay_router(key, R, m, p, T)
    rstate, pstate = ref.init(key, R), port.init(draws, R)
    loads = np.random.default_rng(0).integers(0, 4, (T, R)).astype(np.float32)
    loads[::7, 1] = np.inf  # replica 1 dead every seventh decision
    got, want = [], []
    for d in range(T):
        i_r, rstate = ref.step(rstate, jnp.asarray(loads[d]), jax.random.fold_in(key, d))
        i_p, pstate = port.step(pstate, torch.from_numpy(loads[d]), draws.step(d))
        want.append(int(i_r))
        got.append(int(i_p))
    assert got == want
    assert -1 in got and len(set(got) - {-1}) == R  # rejections and every replica
    np.testing.assert_array_equal(pstate["ages"].numpy(), np.asarray(rstate["ages"]))


def test_markov_router_is_the_selection_policy_at_one_replica():
    probs = np.array([0.3, 0.6, 1.0], np.float32)
    router = make_router("markov", 1, m=2, probs=probs)
    policy = selection.make_markov(1, 1, 2, probs=probs)
    rd, pd = GeneratorDraws(42, "cpu"), GeneratorDraws(42, "cpu")
    rstate, pstate = router.init(rd, 1), policy.init(pd, 1)
    load = torch.zeros((1,))
    admitted, selected = [], []
    for t in range(300):
        idx, rstate = router.step(rstate, load, rd.step(t))
        sel, pstate = policy.step(pstate, pd.step(t))
        admitted.append(int(idx) == 0)
        selected.append(bool(sel[0]))
    assert admitted == selected
    assert np.mean(admitted) == pytest.approx(load_metric.selection_rate(probs), abs=0.1)


def test_target_gap_chain_is_the_reference_chain():
    port = make_router("markov", 2, m=4, target_gap=3.0, steady_start=False)
    ref = ref_router.make_router("markov", 2, m=4, target_gap=3.0, steady_start=False)
    rstate = ref.init(jax.random.PRNGKey(0), 2)
    pstate = port.init(GeneratorDraws(0, "cpu"), 2)
    load = np.zeros((2,), np.float32)
    for d in range(50):
        # the reference's uniform draw is fed to the port as its replay
        key = jax.random.PRNGKey(d)
        u_d = np.asarray(jax.random.uniform(key, (2,)))
        i_r, rstate = ref.step(rstate, jnp.asarray(load), key)
        i_p, pstate = port.step(pstate, torch.from_numpy(load),
                                ReplayDraws({}, [{"select": u_d}], "cpu").step(0))
        assert int(i_p) == int(i_r)


def test_least_loaded_willing_and_dead_masking():
    key = jax.random.PRNGKey(0)
    markov = make_router("markov", 4, m=2, probs=np.array([1.0, 1.0, 1.0]))
    state = markov.init(GeneratorDraws(0, "cpu"), 4)
    # every replica willing (p == 1): the loaded ones lose
    idx, _ = markov.step(state, torch.tensor([3.0, 1.0, 0.0, 2.0]), GeneratorDraws(1, "cpu"))
    assert int(idx) == 2
    idx, _ = markov.step(state, torch.tensor([3.0, 1.0, np.inf, 2.0]), GeneratorDraws(1, "cpu"))
    assert int(idx) == 1
    dead = torch.full((4,), float("inf"))
    idx, _ = markov.step(state, dead, GeneratorDraws(1, "cpu"))
    assert int(idx) == -1
    cases = [np.array(c, np.float32) for c in (
        [2, 0, 0, 1], [np.inf, 0, 3, 0], [np.inf, np.inf, np.inf, np.inf],
        [1, np.inf, 1, 1], [0, 0, 0, 0])]
    for name in ("least_loaded", "round_robin"):
        ref, port = ref_router.make_router(name, 4), make_router(name, 4)
        rstate, pstate = ref.init(key, 4), port.init(None, 4)
        for step in range(3):  # round_robin's cursor walks past dead replicas
            for load in cases:
                i_r, rstate = ref.step(rstate, jnp.asarray(load), key)
                i_p, pstate = port.step(pstate, torch.from_numpy(load), None)
                assert int(i_p) == int(i_r), (name, step, load)
    ll = make_router("least_loaded", 4)
    assert int(ll.step({}, torch.tensor([2.0, 1.0, 1.0, 3.0]), None)[0]) == 1  # lowest tie


def test_penalized_load_matches_reference():
    load = np.array([0.0, 3.0, np.inf, 1.0], np.float32)
    pen = np.float32(0.25) * np.array([2.0, 0.0, 5.0, 0.98], np.float32)
    got = penalized_load(torch.from_numpy(load), pen).numpy()
    want = np.asarray(ref_router.penalized_load(jnp.asarray(load), pen))
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[2])


def test_replica_accum_matches_reference():
    rng = np.random.default_rng(0)
    T, R = 400, 5
    hist = np.zeros((T, R), bool)
    for t in range(T):
        if rng.random() < 0.85:
            hist[t, rng.integers(R)] = True
    acc = load_metric.init_replica_accum(R)
    ref_acc = ref_lm.init_replica_accum(R)
    upd = jax.jit(ref_lm.update_replica_accum)
    for row in hist:
        acc = load_metric.update_replica_accum(acc, torch.from_numpy(row))
        ref_acc = upd(ref_acc, jnp.asarray(row))
    for name in ref_acc:
        np.testing.assert_array_equal(acc[name].numpy(), np.asarray(ref_acc[name]), name)
    stats = load_metric.replica_stats_from_accum(acc)
    want = ref_lm.replica_stats_from_accum(ref_acc)
    assert stats.keys() == want.keys()
    for key in ("num_samples", "decisions", "replica_num_samples"):
        assert stats[key] == want[key]
    for key in ("mean_X", "var_X", "replica_mean_X", "replica_var_X"):
        np.testing.assert_allclose(stats[key], want[key], rtol=1e-6)
    gaps = ref_lm.peak_ages_from_history(hist)
    assert stats["num_samples"] == gaps.size and stats["decisions"] == T
    np.testing.assert_allclose(stats["var_X"], gaps.var(), rtol=1e-5)
