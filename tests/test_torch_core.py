"""The port's core against the reference: AoI dynamics and the load
accumulators bitwise on the same selection streams (Kahan pairs
included), the copied closed forms exactly, and all seven policies'
(rounds, n) histories exactly under replayed draws."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aoi as ref_aoi  # noqa: E402
from repro.core import load_metric as ref_lm  # noqa: E402
from repro.core import selection as ref_sel  # noqa: E402
from repro_torch.core import aoi as pt_aoi  # noqa: E402
from repro_torch.core import load_metric as pt_lm  # noqa: E402
from repro_torch.core import selection as pt_sel  # noqa: E402
from repro_torch.core.draws import GeneratorDraws, ReplayDraws  # noqa: E402
from repro_torch.engine import registry as pt_registry  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401


def _stream(rounds, n, p, seed):
    return np.random.default_rng(seed).random((rounds, n)) < p


def test_age_update_and_peak_age_bitwise():
    sel = _stream(12, 50, 0.2, 0)
    ages_r = jnp.zeros((50,), jnp.int32)
    ages_p = torch.zeros(50, dtype=torch.int32)
    z = jnp.zeros((), jnp.float32)
    acc_r = (z, z, z)
    zt = torch.zeros(())
    acc_p = (zt, zt, zt)
    for row in sel:
        acc_r = ref_aoi.peak_age_accumulate(ages_r, jnp.asarray(row), *acc_r)
        acc_p = pt_aoi.peak_age_accumulate(ages_p, torch.from_numpy(row), *acc_p)
        ages_r = ref_aoi.age_update(ages_r, jnp.asarray(row))
        ages_p = pt_aoi.age_update(ages_p, torch.from_numpy(row))
        np.testing.assert_array_equal(ages_p.numpy(), np.asarray(ages_r))
        assert ages_p.dtype == torch.int32
        for a, b in zip(acc_p, acc_r):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
    np.testing.assert_array_equal(pt_aoi.chain_state(ages_p, 3).numpy(),
                                  np.asarray(ref_aoi.chain_state(ages_r, 3)))


@pytest.mark.parametrize("n,k,rounds,p", [(40, 6, 30, 0.15), (300, 20, 25, 0.07)])
def test_selection_accum_bitwise(n, k, rounds, p):
    sel = _stream(rounds, n, p, n)
    acc_r = ref_lm.init_selection_accum(n, k)
    acc_p = pt_lm.init_selection_accum(n, k, "cpu")
    for row in sel:
        acc_r = ref_lm.update_selection_accum(acc_r, jnp.asarray(row))
        acc_p = pt_lm.update_selection_accum(acc_p, torch.from_numpy(row))
    assert set(acc_p) == set(acc_r)
    for key in acc_r:
        a, b = acc_p[key].numpy(), np.asarray(acc_r[key])
        assert a.dtype == b.dtype, key
        assert a.tobytes() == b.tobytes(), key
    assert pt_lm.selection_stats_from_accum(acc_p) == \
        ref_lm.selection_stats_from_accum(acc_r)
    stats = pt_lm.empirical_load_stats(sel)
    assert stats == ref_lm.empirical_load_stats(sel)


@pytest.mark.parametrize("n,k,m", [(100, 15, 10), (100, 15, 3), (50, 20, 1), (64, 8, 8)])
def test_closed_forms_equal_reference(n, k, m):
    assert pt_lm.random_selection_mean(n, k) == ref_lm.random_selection_mean(n, k)
    assert pt_lm.random_selection_var(n, k) == ref_lm.random_selection_var(n, k)
    p = pt_lm.optimal_probs(n, k, m)
    np.testing.assert_array_equal(p, ref_lm.optimal_probs(n, k, m))
    np.testing.assert_array_equal(pt_lm.steady_state(p), ref_lm.steady_state(p))
    assert pt_lm.markov_moments(p) == ref_lm.markov_moments(p)
    assert pt_lm.optimal_var(n, k, m) == ref_lm.optimal_var(n, k, m)
    assert pt_lm.selection_rate(p) == ref_lm.selection_rate(p)
    if 2 * k <= n:
        pr, vr = ref_lm.theorem1_optimal(n, k)
        pp, vp = pt_lm.theorem1_optimal(n, k)
        np.testing.assert_array_equal(pp, pr)
        assert vp == vr
        assert pt_lm.theorem1_var(n, k, *pp) == ref_lm.theorem1_var(n, k, *pr)


N, K, M, ROUNDS = 60, 9, 6, 15
POLICIES = [
    ("random", {}),
    ("markov", {}),
    ("markov_probs", {"probs": np.array([0, 0, 0.3, 0.6, 0.9, 1, 1])}),
    ("markov_hetero", {"rate_spread": 1.5}),
    ("oldest_age", {}),
    ("round_robin", {}),
    ("gumbel_age", {"beta": 0.7}),
]


def _replay_policy_draws(name, policy_kwargs, key):
    """The primitive draws ``selection.simulate`` makes under its own key
    schedule (core/selection.py): the init draw from ``key``, then step r
    from ``split(fold_in(key, 1), rounds)[r]``."""
    init = {}
    if name in ("markov", "markov_probs"):
        p = (ref_lm.optimal_probs(N, K, M) if "probs" not in policy_kwargs
             else policy_kwargs["probs"]).astype(np.float32)
        pi = jnp.asarray(ref_lm.steady_state(p).astype(np.float32))
        init["policy_init"] = np.asarray(
            jax.random.choice(key, M + 1, shape=(N,), p=pi))
    elif name == "markov_hetero":
        init["policy_init"] = np.asarray(jax.random.uniform(key, (N,)))
    elif name == "oldest_age":
        init["policy_init"] = np.asarray(jax.random.permutation(key, N))
    steps = []
    for kr in jax.random.split(jax.random.fold_in(key, 1), ROUNDS):
        if name == "random":
            steps.append({"select": np.asarray(jax.random.permutation(kr, N))})
        elif name in ("markov", "markov_probs", "markov_hetero"):
            steps.append({"select": np.asarray(jax.random.uniform(kr, (N,)))})
        elif name == "oldest_age":
            steps.append({"select": np.asarray(
                jax.random.uniform(kr, (N,), minval=0.0, maxval=0.5))})
        elif name == "gumbel_age":
            steps.append({"select": np.asarray(jax.random.gumbel(kr, (N,)))})
        else:
            steps.append({})
    return ReplayDraws(init, steps, "cpu")


def test_registry_names_match_reference():
    # the reference's built-ins (other test files register extra policies
    # in its process-wide registry)
    assert set(ref_sel.POLICY_NAMES) == {name for name, _ in POLICIES}
    assert set(pt_registry.policy_names()) >= set(ref_sel.POLICY_NAMES)
    assert {"fedavg", "fedbuff", "fedprox"} <= set(pt_registry.aggregator_names())


@pytest.mark.parametrize("name,kw", POLICIES, ids=[p[0] for p in POLICIES])
def test_policy_histories_equal_under_replay(name, kw):
    key = jax.random.PRNGKey(3)
    ref_hist = ref_sel.simulate(ref_sel.make_policy(name, N, K, M, **kw),
                                key, N, ROUNDS)
    policy = pt_sel.make_policy(name, N, K, M, **kw)
    hist = pt_sel.simulate(policy, _replay_policy_draws(name, kw, key), N, ROUNDS)
    np.testing.assert_array_equal(hist, ref_hist)
    stats = pt_sel.simulate_stats(policy, _replay_policy_draws(name, kw, key),
                                  N, ROUNDS, expected_cohort=K)
    ref_stats = ref_sel.simulate_stats(ref_sel.make_policy(name, N, K, M, **kw),
                                       key, N, ROUNDS, expected_cohort=K)
    assert stats == ref_stats


def test_markov_native_draws_hit_theory():
    """Torch-generated draws: the Markov policy's Var[X] sits at the
    Theorem-2 optimum and far below random selection (as
    tests/test_markov_theory.py holds the reference)."""
    n, k, m = 400, 40, 12
    policy = pt_sel.make_policy("markov", n, k, m)
    stats = pt_sel.simulate_stats(policy, GeneratorDraws(0, "cpu"), n, 400,
                                  expected_cohort=k)
    assert abs(stats["mean_X"] - n / k) < 0.1
    assert stats["var_X"] < pt_lm.optimal_var(n, k, m) + 0.1
    assert stats["var_X"] < 0.1 * pt_lm.random_selection_var(n, k)


def test_copied_engine_modules_match_reference():
    """engine/config.py's chunk_plan, engine/serialize.py and the registry
    errors are copies of the reference's: same outputs."""
    import dataclasses

    from repro.engine import config as ref_config, serialize as ref_ser
    from repro_torch.engine import config as pt_config, serialize as pt_ser

    for rounds, every, chunk in [(20, 1, 1), (20, 20, 64), (37, 5, 3), (7, 10, 4)]:
        assert pt_config.chunk_plan(rounds, every, chunk) == \
            ref_config.chunk_plan(rounds, every, chunk)
    payload = {"a": float("nan"), "b": np.arange(3), "c": (np.float32(1.5), True),
               "d": np.bool_(False), "e": {"f": [np.int64(4), float("inf")]}}
    assert pt_ser.to_jsonable(payload) == ref_ser.to_jsonable(payload)
    assert pt_ser.to_jsonable(torch.arange(3)) == [0, 1, 2]
    ref_fields = {f.name for f in dataclasses.fields(ref_config.RunConfig)}
    assert {f.name for f in dataclasses.fields(pt_config.RunConfig)} == ref_fields
    cfg = dict(mode="async", n_clients=10, k=3, buffer_size=None, eval_every=4)
    a, b = pt_config.RunConfig(**cfg), ref_config.RunConfig(**cfg)
    assert (a.resolved_aggregator(), a.resolved_buffer_size(),
            a.resolved_steps_per_chunk(), a.profile_name()) == \
        (b.resolved_aggregator(), b.resolved_buffer_size(),
         b.resolved_steps_per_chunk(), b.profile_name())
    with pytest.raises(ValueError, match="unknown policy"):
        pt_registry.make_policy("nope", 10, 2)
    with pytest.raises(ValueError, match="unknown aggregator"):
        pt_registry.make_aggregator("nope")
    with pytest.raises(ValueError):
        pt_config.RunConfig(mode="async", n_clients=4, k=5)
