"""The port's calm async slice as a whole against the reference
``AsyncEngine``: the same fleet, data, initial params and — through
``ReplayDraws`` — the same random draws, step by step.

Exact: send masks, popped indices and valid masks, versions, staleness
statistics, ages, event state and the selection-accumulator state.
Within tolerance: the clock (rtol 1e-6: exp and fused multiply-adds may
round differently by an ulp), params after every step (rtol 1e-4 /
atol 1e-5: f32 convolutions sum in another order), eval loss and the
``RunResult`` statistics.

The second case runs the reference with ``use_kernel=True``, so its pops
come from the Pallas K2 kernel in interpret mode.

The learning rate is 0.02, not the driver's 0.05: at 0.05 one hidden
activation of this run comes within rounding of the ReLU kink at step 5,
the two frameworks take different subgradients there, and fc1.b then
differs by 3e-4 — a property of f32 arithmetic, not of the port. At 0.02
every param stays within 1e-7 of the reference over the six steps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_cnn import MNIST_CNN as REF_MNIST  # noqa: E402
from repro.core import load_metric as ref_lm  # noqa: E402
from repro.data.synthetic import load_dataset as ref_load  # noqa: E402
from repro.engine import AsyncEngine as RefAsyncEngine  # noqa: E402
from repro.engine import RunConfig as RefRunConfig  # noqa: E402
from repro.engine import run_engine as ref_run_engine  # noqa: E402
from repro.fl import make_cnn_task as ref_make_cnn_task  # noqa: E402
from repro.sim import events as ref_events  # noqa: E402
from repro_torch.configs.paper_cnn import MNIST_CNN  # noqa: E402
from repro_torch.convert import params_to_jax, state_to_jax  # noqa: E402
from repro_torch.core.draws import ReplayDraws  # noqa: E402
from repro_torch.data.synthetic import load_dataset  # noqa: E402
from repro_torch.engine import RunConfig, make_engine, run_engine  # noqa: E402
from repro_torch.fl import make_cnn_task  # noqa: E402
from repro_torch.sim import events as pt_events  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401


N, K, M, STEPS, EPOCHS, SEED, SCALE = 48, 8, 10, 6, 2, 0, 0.02
CFG = dict(mode="async", n_clients=N, k=K, m=M, policy="markov", rounds=STEPS,
           local_epochs=EPOCHS, batch_size=50, lr0=0.02, seed=SEED,
           eval_every=1, profile="lognormal")


def reference_draws(examples):
    """Every primitive draw of the reference's calm async run under its own
    key schedule: engine/async_engine.py init (split(key, 3), the CNN's
    split(k_init, 4), the markov policy's choice, client_speed at
    fold_in(k_run, 2**31)); per step engine/chunk.py:59 fold_in(k_run, r),
    async_engine.py:408-410 (split, fold 101), sim/latency.py:118-128,
    async_engine.py:546 split(k_local, B) and fl/client.py:26-27."""
    k_init, k_policy, k_run = jax.random.split(jax.random.PRNGKey(SEED), 3)
    params = jax.eval_shape(lambda k: ref_task_init(k), k_init)
    init = {}
    for name, kk in zip(("conv1", "conv2", "fc1", "fc2"), jax.random.split(k_init, 4)):
        init[f"params/{name}"] = np.asarray(
            jax.random.normal(kk, params[name]["w"].shape))
    p = ref_lm.optimal_probs(N, K, M).astype(np.float32)
    pi = jnp.asarray(ref_lm.steady_state(p).astype(np.float32))
    init["policy_init"] = np.asarray(
        jax.random.choice(k_policy, M + 1, shape=(N,), p=pi))
    init["speed"] = np.asarray(
        jax.random.normal(jax.random.fold_in(k_run, 2**31), (N,), jnp.float32))
    steps = []
    for r in range(STEPS):
        k_sel, k_local = jax.random.split(jax.random.fold_in(k_run, r))
        k_c, k_t = jax.random.split(jax.random.fold_in(k_sel, 101))
        perms = np.stack([
            np.stack([np.asarray(jax.random.permutation(ke, examples))
                      for ke in jax.random.split(kb, EPOCHS)])
            for kb in jax.random.split(k_local, K)])
        steps.append({
            "select": np.asarray(jax.random.uniform(k_sel, (N,))),
            "latency_compute": np.asarray(jax.random.normal(k_c, (N,), jnp.float32)),
            "latency_comm": np.asarray(jax.random.exponential(k_t, (N,), jnp.float32)),
            "local_perm": perms,
        })
    return init, steps


def ref_task_init(key):
    from repro.models.cnn import init_params

    return init_params(key, REF_MNIST)


def _copy(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _record_pops(monkeypatch, module, callback_wrap):
    pops = []
    orig = module.pop_events

    def pop_events(ev, k, *, use_kernel=None):
        t, idx, valid, ev2 = orig(ev, k, use_kernel=use_kernel)
        callback_wrap(pops, idx, valid)
        return t, idx, valid, ev2

    monkeypatch.setattr(module, "pop_events", pop_events)
    return pops


def _jax_record(pops, idx, valid):
    jax.debug.callback(lambda i, v: pops.append((np.array(i), np.array(v))),
                       idx, valid)


def _torch_record(pops, idx, valid):
    pops.append((idx.numpy().copy(), valid.numpy().copy()))


def _snapshot(state, aux, ev_out):
    return {
        "send": np.asarray(aux["send"]),
        "params": state["params"], "version": state["version"],
        "clock": state["clock"], "ages": state["sched"]["ages"],
        "ev": state["ev"], "load_acc": state["load_acc"],
        "stale": {k: state["stats"][k] for k in ("stale_sum", "stale_cnt",
                                                  "stale_max", "updates", "aggs")},
        "eval_loss": ev_out["loss"],
    }


@pytest.fixture(scope="module", params=[False, True], ids=["lax_topk", "pallas_k2"])
def runs(request):
    return run_both(request.param)


def run_both(use_kernel):
    """Both engines step by step (snapshots and recorded pops), then
    through ``run_engine``."""
    mp = pytest.MonkeyPatch()
    try:
        train, test = ref_load("mnist", seed=SEED, scale=SCALE)
        task_r = ref_make_cnn_task(REF_MNIST, train, test, N, seed=SEED)
        cfg_r = RefRunConfig(**CFG, use_kernel=use_kernel)
        ref_pops = _record_pops(mp, ref_events, _jax_record)
        eng_r = RefAsyncEngine(task_r, cfg_r)
        state = eng_r.init()
        ref_steps = []
        for r in range(STEPS):
            state, aux = eng_r.step(state, r)
            ref_steps.append(_copy(_snapshot(state, aux, eng_r.evaluate(state))))
        del ref_pops[STEPS:]
        ref_step_pops = list(ref_pops)
        ref_pops.clear()
        ref_result = ref_run_engine(eng_r)

        train_p, test_p = load_dataset("mnist", seed=SEED, scale=SCALE)
        task_p = make_cnn_task(MNIST_CNN, train_p, test_p, N, seed=SEED, device="cpu")
        init, steps = reference_draws(task_p.examples_per_client)
        cfg_p = RunConfig(**CFG, use_kernel=use_kernel)
        pt_pops = _record_pops(mp, pt_events, _torch_record)
        eng_p = make_engine(task_p, cfg_p, draws=ReplayDraws(init, steps, "cpu"))
        state = eng_p.init()
        pt_steps = []
        for r in range(STEPS):
            state, aux = eng_p.step(state, r)
            pt_steps.append(_snapshot(state, aux, eng_p.evaluate(state)))
        pt_step_pops = list(pt_pops)
        pt_result = run_engine(eng_p)
    finally:
        mp.undo()
    return dict(ref_steps=ref_steps, ref_pops=ref_step_pops, ref_result=ref_result,
                pt_steps=pt_steps, pt_pops=pt_step_pops, pt_result=pt_result)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_discrete_outputs_equal_exactly(runs):
    assert len(runs["pt_pops"]) == len(runs["ref_pops"]) == STEPS
    for r, (pt, ref) in enumerate(zip(runs["pt_steps"], runs["ref_steps"])):
        np.testing.assert_array_equal(_np(pt["send"]), ref["send"], err_msg=f"send {r}")
        (pi, pv), (ri, rv) = runs["pt_pops"][r], runs["ref_pops"][r]
        np.testing.assert_array_equal(pv, rv, err_msg=f"valid {r}")
        np.testing.assert_array_equal(pi, ri, err_msg=f"idx {r}")
        assert int(pt["version"]) == int(ref["version"])
        np.testing.assert_array_equal(_np(pt["ages"]), ref["ages"])
        for key, val in ref["stale"].items():
            assert _np(pt["stale"][key]).tobytes() == val.tobytes(), key
        for key, val in ref["load_acc"].items():
            assert _np(pt["load_acc"][key]).tobytes() == val.tobytes(), key
        ev = state_to_jax(pt["ev"])
        for key in ("disp_ver", "dropped"):
            np.testing.assert_array_equal(ev[key], ref["ev"][key], err_msg=key)
        for key in ("t_done", "next_avail", "last_done"):
            np.testing.assert_allclose(ev[key], ref["ev"][key], rtol=1e-6, err_msg=key)
    # the run is not degenerate: events popped, versions advanced
    assert sum(int(v.sum()) for _, v in runs["ref_pops"]) > 2 * K
    assert int(runs["ref_steps"][-1]["version"]) >= 3


def test_float_outputs_within_tolerance(runs):
    for r, (pt, ref) in enumerate(zip(runs["pt_steps"], runs["ref_steps"])):
        np.testing.assert_allclose(float(pt["clock"]), float(ref["clock"]), rtol=1e-6)
        got = params_to_jax(pt["params"])
        for layer, leaves in ref["params"].items():
            for name, val in leaves.items():
                np.testing.assert_allclose(got[layer][name], val, rtol=1e-4, atol=1e-5,
                                           err_msg=f"step {r} {layer}.{name}")
        np.testing.assert_allclose(float(pt["eval_loss"]), float(ref["eval_loss"]),
                                   rtol=1e-4)


def test_run_result_matches(runs):
    pt, ref = runs["pt_result"], runs["ref_result"]
    np.testing.assert_array_equal(pt.selection, ref.selection)
    assert pt.load_stats.keys() == ref.load_stats.keys()
    for key, val in ref.load_stats.items():
        np.testing.assert_allclose(pt.load_stats[key], val, rtol=1e-6, err_msg=key)
    assert pt.wall_stats.keys() == ref.wall_stats.keys()
    for key, val in ref.wall_stats.items():
        np.testing.assert_allclose(pt.wall_stats[key], val, rtol=1e-5, err_msg=key)
    assert len(pt.records) == len(ref.records) == STEPS
    for a, b in zip(pt.records, ref.records):
        assert (a.round, a.version, a.buffer_fill) == (b.round, b.version, b.buffer_fill)
        np.testing.assert_allclose(a.eval_loss, b.eval_loss, rtol=1e-4)
        np.testing.assert_allclose(a.clock, b.clock, rtol=1e-6)
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=1e-4, equal_nan=True)
    assert dataclasses.asdict(pt.config).keys() == dataclasses.asdict(ref.config).keys()


def _config_parity(cfg):
    """The port's ``RunConfig`` raises the reference's ``ValueError`` with an
    equal message, or accepts what the reference accepts."""
    try:
        RefRunConfig(**cfg)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            RunConfig(**cfg)
        assert str(got.value) == str(exc)
        return
    RunConfig(**cfg)


@pytest.mark.parametrize("option", [
    # fleet sharding runs since slice F: each case, paired with a
    # topology or the defense, is validated as the reference validates it
    dict(mode="sync", topology="hierarchical", defense=True, shard_cohort=True),
    dict(topology="hierarchical", mesh_shards=0),
    dict(topology_kwargs={"tiers": (4,)}, topology="hierarchical", shard_cohort=True),
    dict(defense_kwargs={"threshold": 0.5}), dict(defense=True, mesh_shards=0),
    dict(mesh_shards=0), dict(shard_cohort=True), dict(rng_impl="rbg"),
])
def test_out_of_slice_options_raise(option):
    cfg = {**CFG, **option}
    if "rng_impl" in option:
        # a JAX PRNG implementation has no meaning in the port
        RefRunConfig(**cfg)
        with pytest.raises(NotImplementedError, match="torch.Generator"):
            RunConfig(**cfg)
        return
    _config_parity(cfg)


def test_driver_runs_on_cpu_and_rejects_later_slices(capsys):
    from repro_torch.launch import fl_async

    res = fl_async.main(["--device", "cpu", "--clients", "12", "--k", "4",
                         "--rounds", "2", "--data-scale", "0.02"])
    out = capsys.readouterr().out
    assert "== load metric X (wall clock) ==" in out
    assert len(res.records) == 2 and np.isfinite(res.records[-1].eval_loss)
    # --arch runs since slice G2 (the reduced LM as the workload), every
    # registered arch since slice G3 (gemma3: sliding and full layers)
    lm = fl_async.main(["--device", "cpu", "--clients", "12", "--k", "4",
                        "--rounds", "1", "--local-epochs", "1", "--batch-size", "4",
                        "--arch", "tinyllama-1.1b"])
    assert np.isfinite(lm.records[-1].eval_loss)
    g3 = fl_async.main(["--device", "cpu", "--clients", "12", "--k", "4", "--rounds", "1",
                        "--local-epochs", "1", "--batch-size", "4", "--arch", "gemma3-27b"])
    assert np.isfinite(g3.records[-1].eval_loss)
    # --mesh-shards runs since slice F: on one CPU it resolves to a world of
    # one, which the driver ends with its run; the one-device run bit for bit
    for flags in (["--topology", "hierarchical", "--mesh-shards", "0"],
                  ["--defense", "--mesh-shards", "0"]):
        argv = ["--device", "cpu", "--clients", "12", "--k", "4",
                "--rounds", "1", "--data-scale", "0.02", *flags]
        sharded = fl_async.main(argv)
        assert "/x1] step" in capsys.readouterr().out
        assert not torch.distributed.is_initialized()
        plain = fl_async.main(argv[:-2])
        np.testing.assert_array_equal(sharded.selection, plain.selection)
        for key, leaves in plain.params.items():
            for name, val in leaves.items():
                assert torch.equal(sharded.params[key][name], val)


@pytest.mark.parametrize("driver", ["fl_async", "fl_train"])
def test_drivers_run_the_robustness_tier_on_cpu(capsys, driver):
    """The fault flags run in both drivers (slice C) and the drivers print
    the counters as the reference's do."""
    import importlib

    mod = importlib.import_module(f"repro_torch.launch.{driver}")
    flags = ["--device", "cpu", "--clients", "12", "--k", "4", "--rounds", "2",
             "--data-scale", "0.02", "--local-epochs", "1",
             "--faults", "dropout,corrupt", "--fault-rate", "0.1",
             "--robust-agg", "trimmed_mean"]
    if driver == "fl_async":
        flags += ["--redispatch-timeout", "30"]
    res = mod.main(flags)
    out = capsys.readouterr().out
    assert "faults injected: dropout=" in out and ", corrupt=" in out
    assert "robust aggregation: unweighted=" in out
    assert res.config.resolved_aggregator() == "trimmed_mean"
    assert res.config.fault_names() == ("dropout", "corrupt")
    assert res.config.aggregator_kwargs == {}
    assert "fault_dropout_injected" in res.load_stats
    if driver == "fl_async":
        assert "re-dispatch: " in out and " deadline hits" in out
        assert res.config.redispatch_timeout == 30.0
        assert "rd_expired" in res.load_stats
    with pytest.raises(SystemExit, match="shorthand"):
        mod.main(flags + ["--aggregator", "fedavg"])
    with pytest.raises(SystemExit, match="unknown fault"):
        mod.main(["--device", "cpu", "--faults", "nope"])


@pytest.mark.parametrize("policy", ["markov", "random", "oldest_age"])
def test_chunked_equals_per_step_within_the_port(policy):
    """The reference pins chunked == per-step bit for bit
    (tests/test_engine_chunked.py); the port's chunk is the same loop of
    steps over native torch draws, so the two must agree exactly."""
    train, test = load_dataset("mnist", seed=1, scale=0.01)
    task = make_cnn_task(MNIST_CNN, train, test, 24, seed=1, device="cpu")
    out = []
    for chunk in (1, 3):
        cfg = RunConfig(**{**CFG, "n_clients": 24, "k": 4, "policy": policy,
                           "eval_every": 3, "steps_per_chunk": chunk})
        out.append(run_engine(make_engine(task, cfg)))
    a, b = out
    np.testing.assert_array_equal(a.selection, b.selection)
    np.testing.assert_equal(a.load_stats, b.load_stats)  # NaN == NaN here
    np.testing.assert_equal(a.wall_stats, b.wall_stats)
    for la, lb in zip(params_to_jax(a.params).values(), params_to_jax(b.params).values()):
        for key in la:
            assert la[key].tobytes() == lb[key].tobytes()
    np.testing.assert_equal([dataclasses.astuple(r) for r in a.records],
                            [dataclasses.astuple(r) for r in b.records])


def test_entry_points_default_to_the_gpu():
    """With no device asked for, the port runs on CUDA or raises; it never
    falls back to the CPU on its own."""
    from repro_torch.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    train, test = load_dataset("mnist", seed=0, scale=0.01)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_cnn_task(MNIST_CNN, train, test, 8)
    from repro_torch.launch import fl_async

    with pytest.raises(RuntimeError, match="--device cpu"):
        fl_async.main(["--clients", "8", "--k", "2", "--rounds", "1",
                       "--data-scale", "0.01"])
    assert resolve_device("cpu").type == "cpu"
