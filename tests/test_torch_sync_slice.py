"""The port's calm sync slice as a whole against the reference
``SyncEngine``: the same fleet, data, initial params and — through
``ReplayDraws`` — the same random draws, round by round.

Exact: send masks, ``cohort_indices`` output, ages, the selection
accumulators and ``RunResult.selection``. Within tolerance: params after
every round (rtol 1e-4 / atol 1e-5: f32 convolutions and the cohort sum
run in another order), train and eval loss at each record (rtol 1e-4)
and the ``RunResult`` load statistics (rtol 1e-6).

Params are compared round by round with each port round started from the
reference's params of the round before (``convert.params_from_jax``), so
each check holds the port's round function to the reference's on the same
inputs. Free-running, the ~1e-7 drift of f32 arithmetic meets a
subgradient discontinuity: at round 5 of this run one conv1 max-pool
window has a top-2 gap of 2.4e-7, the frameworks route its gradient to
different pixels, and one conv1.w element ends 1.7e-5 apart (every other
param within 1e-7; ROADMAP queue 3). The free-running run is held to the
reference on every discrete output and on its records.

The learning rate is 0.02, not the driver's 0.1: at larger rates such
discontinuities (ReLU kinks, pool ties) are crossed within a few rounds.

The rest are the port's own contracts, on native draws: chunked ==
per-step bitwise, an empty cohort reports a NaN train loss, the eval
cadence, degenerate async == sync, and the ``fl_train`` driver.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.engine.sync as ref_sync_mod  # noqa: E402
from repro.configs.paper_cnn import MNIST_CNN as REF_MNIST  # noqa: E402
from repro.core import load_metric as ref_lm  # noqa: E402
from repro.data.synthetic import load_dataset as ref_load  # noqa: E402
from repro.engine import RunConfig as RefRunConfig  # noqa: E402
from repro.engine import SyncEngine as RefSyncEngine  # noqa: E402
from repro.engine import run_engine as ref_run_engine  # noqa: E402
from repro.engine.config import default_cohort_width as ref_cohort_width  # noqa: E402
from repro.engine.config import run_config_from_legacy as ref_from_legacy  # noqa: E402
from repro.fl import FLConfig as RefFLConfig  # noqa: E402
from repro.fl import make_cnn_task as ref_make_cnn_task  # noqa: E402
from repro.fl import run_training as ref_run_training  # noqa: E402
from repro.sim import AsyncConfig as RefAsyncConfig  # noqa: E402
from repro.sim import get_profile as ref_get_profile  # noqa: E402
from repro.sim.latency import simulate_sync_duration as ref_sync_duration  # noqa: E402
import repro_torch.engine.sync as pt_sync_mod  # noqa: E402
from repro_torch.configs.paper_cnn import MNIST_CNN  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.draws import ReplayDraws  # noqa: E402
from repro_torch.core.selection import Policy  # noqa: E402
from repro_torch.data.synthetic import load_dataset  # noqa: E402
from repro_torch.engine import RunConfig, SyncEngine, make_engine, run_engine  # noqa: E402
from repro_torch.engine.config import (  # noqa: E402
    chunk_plan,
    default_cohort_width,
    run_config_from_legacy,
)
from repro_torch.fl import FLConfig, make_cnn_task, make_round_fn, run_training  # noqa: E402
from repro_torch.kernels import fedavg_reduce as k1  # noqa: E402
from repro_torch.sim import AsyncConfig, get_profile, run_async_training  # noqa: E402
from repro_torch.sim.latency import simulate_sync_duration  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401


N, K, M, ROUNDS, EPOCHS, SEED, SCALE = 48, 8, 10, 6, 2, 0, 0.02
WIDTH = 19  # default_cohort_width(48, 8): k + 4 sigma of Binomial(48, 1/6)
CFG = dict(mode="sync", n_clients=N, k=K, m=M, policy="markov", rounds=ROUNDS,
           local_epochs=EPOCHS, batch_size=50, lr0=0.02, seed=SEED, eval_every=1)
LEGACY = {k: v for k, v in CFG.items() if k != "mode"}


def reference_draws(examples):
    """Every primitive draw of the reference's calm sync run under its own
    key schedule: engine/sync.py init (split(key, 3), the CNN's
    split(k_init, 4), the markov policy's choice from k_policy); per round
    engine/chunk.py:59 fold_in(k_run, r), sync.py:363 split into k_sel and
    k_local, the policy's uniform from k_sel, sync.py:368
    split(k_local, width) over every slot and fl/client.py:26-27."""
    k_init, k_policy, k_run = jax.random.split(jax.random.PRNGKey(SEED), 3)
    from repro.models.cnn import init_params

    shapes = jax.eval_shape(lambda k: init_params(k, REF_MNIST), k_init)
    init = {}
    for name, kk in zip(("conv1", "conv2", "fc1", "fc2"), jax.random.split(k_init, 4)):
        init[f"params/{name}"] = np.asarray(jax.random.normal(kk, shapes[name]["w"].shape))
    pi = jnp.asarray(ref_lm.steady_state(ref_lm.optimal_probs(N, K, M)).astype(np.float32))
    init["policy_init"] = np.asarray(jax.random.choice(k_policy, M + 1, shape=(N,), p=pi))
    steps = []
    for r in range(ROUNDS):
        k_sel, k_local = jax.random.split(jax.random.fold_in(k_run, r))
        perms = np.stack([
            np.stack([np.asarray(jax.random.permutation(ke, examples))
                      for ke in jax.random.split(kb, EPOCHS)])
            for kb in jax.random.split(k_local, WIDTH)])
        steps.append({"select": np.asarray(jax.random.uniform(k_sel, (N,))),
                      "local_perm": perms})
    return init, steps


def _copy(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _record_cohorts(mp, module, record):
    cohorts = []
    orig = module.cohort_indices

    def cohort_indices(selected, width):
        idx, w = orig(selected, width)
        record(cohorts, idx, w)
        return idx, w

    mp.setattr(module, "cohort_indices", cohort_indices)
    return cohorts


def _jax_record(cohorts, idx, w):
    jax.debug.callback(lambda i, v: cohorts.append((np.array(i), np.array(v))), idx, w)


def _torch_record(cohorts, idx, w):
    cohorts.append((idx.numpy().copy(), w.numpy().copy()))


def _snapshot(state, aux, ev_out):
    return {"send": np.asarray(aux["send"]), "params": state["params"],
            "ages": state["sched"]["ages"], "round": state["sched"]["round"],
            "load_acc": state["load_acc"], "loss": aux["loss"],
            "eval_loss": ev_out["loss"]}


@pytest.fixture(scope="module")
def runs():
    """Both engines round by round (snapshots and recorded cohorts), then
    through ``run_engine`` and through the legacy ``run_training``."""
    mp = pytest.MonkeyPatch()
    try:
        train, test = ref_load("mnist", seed=SEED, scale=SCALE)
        task_r = ref_make_cnn_task(REF_MNIST, train, test, N, seed=SEED)
        ref_cohorts = _record_cohorts(mp, ref_sync_mod, _jax_record)
        eng_r = RefSyncEngine(task_r, RefRunConfig(**CFG))
        state = eng_r.init()
        ref_steps = []
        for r in range(ROUNDS):
            state, aux = eng_r.step(state, r)
            ref_steps.append(_copy(_snapshot(state, aux, eng_r.evaluate(state))))
        ref_step_cohorts = list(ref_cohorts[:ROUNDS])
        ref_result = ref_run_engine(eng_r)
        ref_legacy = ref_run_training(task_r, RefFLConfig(**LEGACY))

        train_p, test_p = load_dataset("mnist", seed=SEED, scale=SCALE)
        task_p = make_cnn_task(MNIST_CNN, train_p, test_p, N, seed=SEED, device="cpu")
        init, steps = reference_draws(task_p.examples_per_client)
        pt_cohorts = _record_cohorts(mp, pt_sync_mod, _torch_record)
        eng_p = make_engine(task_p, RunConfig(**CFG), draws=ReplayDraws(init, steps, "cpu"))
        assert isinstance(eng_p, SyncEngine)
        state = eng_p.init()
        pt_steps = []
        for r in range(ROUNDS):
            state, aux = eng_p.step(state, r)
            pt_steps.append(_snapshot(state, aux, eng_p.evaluate(state)))
        pt_step_cohorts = list(pt_cohorts)
        # round r from the reference's params after round r - 1
        eng_f = make_engine(task_p, RunConfig(**CFG), draws=ReplayDraws(init, steps, "cpu"))
        state = eng_f.init()
        pt_forced = []
        for r in range(ROUNDS):
            if r:
                state["params"] = params_from_jax(ref_steps[r - 1]["params"], "cpu")
            state, aux = eng_f.step(state, r)
            pt_forced.append(_snapshot(state, aux, eng_f.evaluate(state)))
        pt_result = run_engine(eng_p)
        pt_legacy = run_training(task_p, FLConfig(**LEGACY),
                                 draws=ReplayDraws(init, steps, "cpu"))
    finally:
        mp.undo()
    return dict(ref_steps=ref_steps, ref_cohorts=ref_step_cohorts,
                ref_result=ref_result, ref_legacy=ref_legacy,
                pt_steps=pt_steps, pt_cohorts=pt_step_cohorts, pt_forced=pt_forced,
                pt_result=pt_result, pt_legacy=pt_legacy)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_discrete_outputs_equal_exactly(runs):
    assert len(runs["pt_cohorts"]) == len(runs["ref_cohorts"]) == ROUNDS
    for r, (pt, ref) in enumerate(zip(runs["pt_steps"], runs["ref_steps"])):
        np.testing.assert_array_equal(_np(pt["send"]), ref["send"], err_msg=f"send {r}")
        (pi, pw), (ri, rw) = runs["pt_cohorts"][r], runs["ref_cohorts"][r]
        assert pi.shape == (WIDTH,)
        np.testing.assert_array_equal(pi, ri, err_msg=f"cohort idx {r}")
        np.testing.assert_array_equal(pw, rw, err_msg=f"cohort weights {r}")
        np.testing.assert_array_equal(_np(pt["ages"]), ref["ages"])
        assert int(pt["round"]) == int(ref["round"]) == r + 1
        for key, val in ref["load_acc"].items():
            assert _np(pt["load_acc"][key]).tobytes() == val.tobytes(), key
    # the run is not degenerate: cohorts of varying size, padding in use
    sizes = [int(w.sum()) for _, w in runs["ref_cohorts"]]
    assert min(sizes) > 0 and max(sizes) < WIDTH and len(set(sizes)) > 1


def test_float_outputs_within_tolerance(runs):
    for r, (pt, ref) in enumerate(zip(runs["pt_forced"], runs["ref_steps"])):
        np.testing.assert_array_equal(_np(pt["send"]), ref["send"])
        got = params_to_jax(pt["params"])
        for layer, leaves in ref["params"].items():
            for name, val in leaves.items():
                np.testing.assert_allclose(got[layer][name], val, rtol=1e-4, atol=1e-5,
                                           err_msg=f"round {r} {layer}.{name}")
        np.testing.assert_allclose(float(pt["loss"]), float(ref["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(pt["eval_loss"]), float(ref["eval_loss"]),
                                   rtol=1e-4)
    # training moved the params
    first = runs["ref_steps"][0]["params"]["fc2"]["w"]
    assert not np.allclose(first, runs["ref_steps"][-1]["params"]["fc2"]["w"])


def _assert_results_match(pt_sel, ref_sel, pt_stats, ref_stats, pt_hist, ref_hist):
    np.testing.assert_array_equal(pt_sel, ref_sel)
    assert pt_stats.keys() == ref_stats.keys()
    for key, val in ref_stats.items():
        np.testing.assert_allclose(pt_stats[key], val, rtol=1e-6, err_msg=key)
    assert pt_hist.keys() == ref_hist.keys()
    assert pt_hist["round"] == ref_hist["round"] == list(range(1, ROUNDS + 1))
    for key in ("eval_loss", "train_loss", "accuracy"):
        np.testing.assert_allclose(pt_hist[key], ref_hist[key], rtol=1e-4, err_msg=key)


def test_run_result_matches(runs):
    pt, ref = runs["pt_result"], runs["ref_result"]
    _assert_results_match(pt.selection, ref.selection, pt.load_stats, ref.load_stats,
                          pt.history(), ref.history())
    assert pt.wall_stats is None and ref.wall_stats is None
    assert dataclasses.asdict(pt.config).keys() == dataclasses.asdict(ref.config).keys()


def test_legacy_run_training_matches(runs):
    pt, ref = runs["pt_legacy"], runs["ref_legacy"]
    _assert_results_match(pt["selection"], ref["selection"], pt["load_stats"],
                          ref["load_stats"], pt["history"], ref["history"])
    # the legacy wrapper is the engine run itself
    np.testing.assert_array_equal(pt["selection"], runs["pt_result"].selection)
    for a, b in zip(params_to_jax(pt["params"]).values(),
                    params_to_jax(runs["pt_result"].params).values()):
        for key in a:
            assert a[key].tobytes() == b[key].tobytes()


# ---------------------------------------------------------------------------
# copied config helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(100, 15), (16384, 256), (48, 8), (20, 4), (10, 10)])
def test_default_cohort_width_equals_the_reference(n, k):
    assert default_cohort_width(n, k) == ref_cohort_width(n, k)
    assert RunConfig(n_clients=n, k=k).cohort_width() == ref_cohort_width(n, k)
    assert FLConfig(n_clients=n, k=k).cohort_width() == ref_cohort_width(n, k)
    assert RunConfig(n_clients=n, k=k, max_cohort=k).cohort_width() == k


def test_run_config_from_legacy_equals_the_reference():
    fl = dict(n_clients=30, k=5, m=7, policy="random", rounds=9, seed=3, max_cohort=8)
    for acfg in (None, dict(buffer_size=4, staleness_mode="const", profile="uniform")):
        got = run_config_from_legacy(FLConfig(**fl), AsyncConfig(**acfg) if acfg else None)
        exp = ref_from_legacy(RefFLConfig(**fl), RefAsyncConfig(**acfg) if acfg else None)
        assert dataclasses.asdict(got) == {
            k: v for k, v in dataclasses.asdict(exp).items()
            if k in dataclasses.asdict(got)}
    assert dataclasses.asdict(AsyncConfig()) == dataclasses.asdict(RefAsyncConfig())
    assert dataclasses.asdict(FLConfig()) == dataclasses.asdict(RefFLConfig())


def test_simulate_sync_duration_matches_the_reference():
    """Replayed draws: client_speed from the key itself, round r's latency
    from fold_in(key, r) split into compute and comm (sim/latency.py)."""
    n, rounds = 16, 4
    sel = np.random.default_rng(0).random((rounds, n)) < 0.3
    key = jax.random.PRNGKey(7)
    profile = ref_get_profile("lognormal")
    init = {"speed": np.asarray(jax.random.normal(key, (n,), jnp.float32))}
    steps = []
    for r in range(rounds):
        k_c, k_t = jax.random.split(jax.random.fold_in(key, r))
        steps.append({
            "latency_compute": np.asarray(jax.random.normal(k_c, (n,), jnp.float32)),
            "latency_comm": np.asarray(jax.random.exponential(k_t, (n,), jnp.float32)),
        })
    got = simulate_sync_duration(sel, get_profile("lognormal"),
                                 ReplayDraws(init, steps, "cpu"))
    np.testing.assert_allclose(got, ref_sync_duration(sel, profile, key), rtol=1e-5)


# ---------------------------------------------------------------------------
# the port's own contracts (native draws, CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_task():
    train, test = load_dataset("mnist", seed=1, scale=0.01)
    return make_cnn_task(MNIST_CNN, train, test, 24, seed=1, device="cpu")


def _same_params(a, b):
    for la, lb in zip(params_to_jax(a).values(), params_to_jax(b).values()):
        for key in la:
            assert la[key].tobytes() == lb[key].tobytes(), key


@pytest.mark.parametrize("policy", ["markov", "random", "oldest_age"])
def test_chunked_equals_per_step_within_the_port(small_task, policy):
    out = []
    for chunk in (1, 3):
        cfg = RunConfig(**{**CFG, "n_clients": 24, "k": 4, "policy": policy,
                           "eval_every": 3, "steps_per_chunk": chunk})
        out.append(run_engine(make_engine(small_task, cfg)))
    a, b = out
    np.testing.assert_array_equal(a.selection, b.selection)
    np.testing.assert_equal(a.load_stats, b.load_stats)
    _same_params(a.params, b.params)
    np.testing.assert_equal([dataclasses.astuple(r) for r in a.records],
                            [dataclasses.astuple(r) for r in b.records])


def test_legacy_round_fn_is_one_engine_round(small_task):
    fl = FLConfig(n_clients=24, k=4, m=6, rounds=1, local_epochs=1, batch_size=10)
    engine = make_engine(small_task, run_config_from_legacy(fl))
    state = engine.init()
    params, sched, selected, loss = make_round_fn(small_task, fl, engine.policy)(
        state["params"], state["sched"], engine.draws.step(0))
    ref = SyncEngine(small_task, run_config_from_legacy(fl))
    ref_state, aux = ref.step(ref.init(), 0)
    assert torch.equal(selected, aux["send"]) and torch.equal(loss, aux["loss"])
    assert torch.equal(sched["ages"], ref_state["sched"]["ages"])
    _same_params(params, ref_state["params"])


def test_collect_history_off_matches_history_run(small_task):
    cfg = RunConfig(**{**CFG, "n_clients": 24, "k": 4, "rounds": 4, "eval_every": 2})
    with_hist = run_engine(make_engine(small_task, cfg))
    no_hist = run_engine(make_engine(small_task,
                                     dataclasses.replace(cfg, collect_history=False)))
    assert with_hist.selection is not None and no_hist.selection is None
    _same_params(with_hist.params, no_hist.params)
    for key, val in with_hist.load_stats.items():
        np.testing.assert_allclose(no_hist.load_stats[key], val, rtol=1e-5, err_msg=key)


def _never_send_policy(n):
    def init(draws, n_=n):
        return {"ages": torch.zeros((n_,), dtype=torch.int32),
                "round": torch.zeros((), dtype=torch.int32)}

    def step(state, draws):
        return torch.zeros((n,), dtype=torch.bool), {**state, "round": state["round"] + 1}

    return Policy("never_send", init, step, exact_k=False)


def test_empty_cohort_reports_nan_loss_and_keeps_params(small_task):
    cfg = RunConfig(**{**CFG, "n_clients": 24, "k": 4, "rounds": 2})
    res = run_engine(SyncEngine(small_task, cfg, policy=_never_send_policy(24)))
    assert all(np.isnan(rec.train_loss) for rec in res.records)
    assert not res.selection.any()
    # the same seed gives the same initial params, and no round moved them
    fresh = SyncEngine(small_task, cfg, policy=_never_send_policy(24)).init()["params"]
    _same_params(res.params, fresh)


def test_eval_cadence_identical_to_per_step_rule():
    for rounds, every, spc in [(7, 3, 2), (10, 4, 64), (5, 1, 2), (6, 10, 4), (60, 2, 2)]:
        legacy = [r for r in range(rounds) if (r + 1) % every == 0 or r == rounds - 1]
        plan = chunk_plan(rounds, every, spc)
        assert sum(ln for _, ln, _ in plan) == rounds
        assert [r0 + ln - 1 for r0, ln, ev in plan if ev] == legacy
        assert all(ln <= spc for _, ln, _ in plan)


@pytest.mark.parametrize("aggregator,kwargs", [
    ("fedavg", {}), ("fedbuff", {"staleness_mode": "const"}),
])
def test_degenerate_async_equals_sync(small_task, aggregator, kwargs):
    """Zero latency spread, buffer = k, exact-k random selection: every
    dispatch completes inside its own step with staleness 0, so the async
    loop is the sync round (the reference's
    test_degenerate_async_equals_sync_through_engine_api)."""
    base = RunConfig(n_clients=24, k=4, m=6, policy="random", rounds=5,
                     local_epochs=2, batch_size=10, eval_every=1)
    sync = run_engine(make_engine(small_task, base))
    acfg = dataclasses.replace(base, mode="async", buffer_size=base.k,
                               aggregator=aggregator, aggregator_kwargs=kwargs,
                               profile="uniform")
    asy = run_engine(make_engine(small_task, acfg))
    np.testing.assert_array_equal(sync.selection, asy.selection)
    for key in ("train_loss", "eval_loss"):
        np.testing.assert_allclose([getattr(r, key) for r in sync.records],
                                   [getattr(r, key) for r in asy.records], rtol=1e-4)
    assert asy.wall_stats["max_staleness"] == 0
    assert asy.wall_stats["aggregations"] == base.rounds
    assert asy.wall_stats["sim_time"] == base.rounds


def test_legacy_async_wrapper_is_the_engine_run(small_task):
    fl = FLConfig(n_clients=24, k=4, m=6, rounds=3, local_epochs=1, batch_size=10)
    acfg = AsyncConfig(buffer_size=4, profile="uniform")
    out = run_async_training(small_task, fl, acfg)
    res = run_engine(make_engine(small_task, run_config_from_legacy(fl, acfg)))
    np.testing.assert_array_equal(out["selection"], res.selection)
    np.testing.assert_equal(out["wall_stats"], res.wall_stats)  # NaN == NaN here
    _same_params(out["params"], res.params)


@pytest.mark.parametrize("option", [
    # fleet sharding runs since slice F: a mesh without cohort sharding,
    # or cohort sharding without a mesh, is rejected under sync with the
    # reference's message
    dict(topology="hierarchical", defense=True, shard_cohort=True),
    dict(defense_kwargs={"threshold": 0.5}),
    dict(defense=True, mesh_shards=0), dict(mesh_shards=0), dict(shard_cohort=True),
])
def test_later_slice_options_raise_under_sync(option):
    with pytest.raises(ValueError) as ref:
        RefRunConfig(**{**CFG, **option})
    with pytest.raises(ValueError) as got:
        RunConfig(**{**CFG, **option})
    assert str(got.value) == str(ref.value)


def test_fl_train_driver_runs_on_cpu(capsys):
    from repro_torch.launch import fl_train

    before = k1.launches
    res = fl_train.main(["--device", "cpu", "--clients", "12", "--k", "4",
                         "--rounds", "3", "--data-scale", "0.02", "--local-epochs", "1",
                         "--target-acc", "0.01"])
    out = capsys.readouterr().out
    assert "== load metric X ==" in out and "cohort   : mean=" in out
    assert "rounds to 1%: 1" in out
    assert res.config.mode == "sync" and res.config.resolved_aggregator() == "fedavg"
    assert res.config.eval_every == 1  # rounds // 30, at least 1
    assert len(res.records) == 3 and np.isfinite(res.records[-1].eval_loss)
    assert k1.launches == before  # on the CPU, K1's plain version
    # --arch runs since slice G2, every registered arch since slice G3
    lm = fl_train.main(["--device", "cpu", "--clients", "12", "--k", "4", "--rounds", "1",
                        "--local-epochs", "1", "--batch-size", "4", "--arch", "tinyllama-1.1b"])
    assert np.isfinite(lm.records[-1].eval_loss)
    for flags in (["--mesh-shards", "0"],
                  ["--topology", "hierarchical", "--defense", "--mesh-shards", "0"]):
        # a mesh runs since slice F; under sync it needs --shard-cohort, and
        # RunConfig says so with the reference's message
        with pytest.raises(ValueError, match="^mesh_shards requires mode='async'"):
            fl_train.main(["--device", "cpu", "--clients", "12", "--k", "4",
                           "--rounds", "1", "--data-scale", "0.02", *flags])
    for flags in (["--defense", "--arch", "gemma3-27b"], ["--arch", "gemma3-27b"]):
        g3 = fl_train.main(["--device", "cpu", "--clients", "12", "--k", "4", "--rounds", "1",
                            "--local-epochs", "1", "--batch-size", "4", *flags])
        assert np.isfinite(g3.records[-1].eval_loss)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            fl_train.main(["--clients", "8", "--k", "2", "--rounds", "1",
                           "--data-scale", "0.01"])
