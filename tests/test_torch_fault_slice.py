"""The port's robustness tier (slice C) as a whole against the reference
engines: the same fleet, data, initial params and — through
``ReplayDraws`` — the same random draws, fault coins, corruption noise and
re-dispatch latencies included, step by step.

Async: dropout, straggler, stale_replay, corrupt, sign_flip and collude at
rate 0.5, a re-dispatch deadline that fires, and ``norm_clip``. Sync:
dropout, corrupt and scale_attack under ``trimmed_mean``, and once under
``coordinate_median``.

Exact: send masks, popped (or selected) indices and valid masks, ages,
event state, the fault state (``prone``, ``injected``, ``exposed``), the
re-dispatch retry counts and every counter. Within the tolerances of
``test_torch_async_slice.py`` and ``test_torch_sync_slice.py``: the clock
and the clock readings it stores (event times, re-dispatch times; rtol
1e-6) and params (rtol 1e-4 / atol 1e-5). As in the sync slice test,
each port sync round starts from the reference's params of the round
before (an order statistic of f32 deltas can pick a neighbouring value
when two deltas are within an ulp of each other).

Then the port's own contracts, the within-port counterparts of
``tests/test_faults.py``, on native draws: faults off adds no state and
makes no sub-stream; rate-0 armed == calm (sync and async, per-step and
chunked); armed chunked == per-step; sync rejects async-only faults;
stragglers stretch the clock; dropout cuts the applied updates; the
re-dispatch counts and gating; ``agg_clipped``.
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
from repro.data.synthetic import make_image_dataset as ref_make_images  # noqa: E402
from repro.engine import AsyncEngine as RefAsyncEngine  # noqa: E402
from repro.engine import RunConfig as RefRunConfig  # noqa: E402
from repro.engine import SyncEngine as RefSyncEngine  # noqa: E402
from repro.engine.config import default_cohort_width  # noqa: E402
from repro.fl import make_cnn_task as ref_make_cnn_task  # noqa: E402
from repro.sim import events as ref_events  # noqa: E402
import repro_torch.engine.sync as pt_sync_mod  # noqa: E402
from repro_torch.configs.paper_cnn import MNIST_CNN  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax, state_to_jax  # noqa: E402
from repro_torch.core.draws import ReplayDraws  # noqa: E402
from repro_torch.core.tree import tree_paths  # noqa: E402
from repro_torch.data.synthetic import make_image_dataset  # noqa: E402
from repro_torch.engine import RunConfig, SyncEngine, make_engine, run_engine  # noqa: E402
from repro_torch.fl import make_cnn_task  # noqa: E402
from repro_torch.sim import events as pt_events  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

N, K, M, STEPS, EPOCHS, SEED = 48, 8, 10, 3, 2, 0
SMALL = dict(name="paper-cnn-mnist-faults", image_size=8, conv_channels=(4, 8),
             fc_width=32)
DATA = ("mnist-fault-slice", 10, 8, 1, 480, 120)  # 10 examples a client
ASYNC_FAULTS = ("dropout", "straggler", "stale_replay", "corrupt", "sign_flip",
                "collude")
ASYNC_CFG = dict(mode="async", n_clients=N, k=K, m=M, policy="markov",
                 rounds=STEPS, local_epochs=EPOCHS, batch_size=5, lr0=0.02,
                 seed=SEED, eval_every=1, profile="lognormal",
                 aggregator="norm_clip", faults=ASYNC_FAULTS, fault_rate=0.5,
                 redispatch_timeout=2.0, redispatch_retries=1)
SYNC_FAULTS = ("dropout", "corrupt", "scale_attack")
SYNC_CFG = dict(mode="sync", n_clients=N, k=K, m=M, policy="markov",
                rounds=STEPS, local_epochs=EPOCHS, batch_size=5, lr0=0.02,
                seed=SEED, eval_every=1, faults=SYNC_FAULTS, fault_rate=0.5,
                fault_kwargs={"scale_attack": {"factor": -3.0}})


def _u(key, shape):
    return jax.random.uniform(key, shape)


def _normal(key, shape):
    return jax.random.normal(key, shape, jnp.float32)


def _latency(key, prefix=""):
    k_c, k_t = jax.random.split(key)
    return {f"{prefix}latency_compute": _normal(k_c, (N,)),
            f"{prefix}latency_comm": jax.random.exponential(k_t, (N,), jnp.float32)}


def _fault_pop_draws(key, faults, width):
    """The pop-time coins of each fault: fault ``i`` folds ``i`` off the
    pop key (``faults/inject.py::FaultSet.on_pop``); collude folds 0 for
    its coin and 1 for its jitter."""
    out = {}
    for i, name in enumerate(faults):
        ki = jax.random.fold_in(key, i)
        if name == "collude":
            out["faults/collude/hit"] = _u(jax.random.fold_in(ki, 0), (width,))
            out["faults/collude/jitter"] = _normal(jax.random.fold_in(ki, 1),
                                                   (width,))
        elif name != "straggler":
            out[f"faults/{name}/hit"] = _u(ki, (width,))
    return out


def _noise_draws(key, shapes, width):
    """``corrupt_updates``'s noise: leaf ``j`` of the reference's (sorted)
    leaf order draws from ``fold_in(key, j)``."""
    return {f"faults/noise/{path}": _normal(jax.random.fold_in(key, j),
                                            (width,) + shape)
            for j, (path, shape) in enumerate(shapes)}


_DRAWS = {}


def reference_draws(cfg, examples, shapes):
    """Every primitive draw of the reference's armed run under its own key
    schedule (engine/async_engine.py and engine/sync.py, folds 101, 105
    with sub-folds 0/1/2, 106; fault init at fold_in(k_run, 2**31), then
    fold 7 in the async engine). The draws do not depend on the
    aggregator, so runs that differ only in it share one table."""
    key = (cfg["mode"], cfg["faults"], examples, tuple(shapes))
    if key not in _DRAWS:
        _DRAWS[key] = _reference_draws(cfg, examples, shapes)
    return _DRAWS[key]


def _reference_draws(cfg, examples, shapes):
    asyn = cfg["mode"] == "async"
    faults = cfg["faults"]
    width = K if asyn else default_cohort_width(N, K)
    k_init, k_policy, k_run = jax.random.split(jax.random.PRNGKey(SEED), 3)

    @jax.jit
    def init_draws():
        init = {f"params/{name}": _normal(kk, dict(shapes)[f"{name}/w"])
                for name, kk in zip(("conv1", "conv2", "fc1", "fc2"),
                                    jax.random.split(k_init, 4))}
        pi = jnp.asarray(ref_lm.steady_state(ref_lm.optimal_probs(N, K, M))
                         .astype(np.float32))
        init["policy_init"] = jax.random.choice(k_policy, M + 1, shape=(N,), p=pi)
        k_fault_init = jax.random.fold_in(k_run, 2**31)
        if asyn:
            init["speed"] = _normal(k_fault_init, (N,))
            k_fault_init = jax.random.fold_in(k_fault_init, 7)
        for i, name in enumerate(faults):
            if name == "collude":  # client_frac 0.25: the only prone draw
                init["faults/collude/prone"] = _u(
                    jax.random.fold_in(k_fault_init, i), (N,))
        return init

    def perm(kb):  # fl/client.py: one permutation per slot and epoch
        return jax.vmap(lambda ke: jax.random.permutation(ke, examples))(
            jax.random.split(kb, EPOCHS))

    @jax.jit
    def step_draws(r):
        k_sel, k_local = jax.random.split(jax.random.fold_in(k_run, r))
        k_fault = jax.random.fold_in(k_sel, 105)
        st = {"select": _u(k_sel, (N,)),
              "local_perm": jax.vmap(perm)(jax.random.split(k_local, width))}
        st.update(_fault_pop_draws(jax.random.fold_in(k_fault, 1), faults, width))
        st.update(_noise_draws(jax.random.fold_in(k_fault, 2), shapes, width))
        if asyn:
            st.update(_latency(jax.random.fold_in(k_sel, 101)))
            st.update(_latency(jax.random.fold_in(k_sel, 106), "redispatch/"))
            kd = jax.random.fold_in(k_fault, 0)
            st["faults/straggler/hit"] = _u(
                jax.random.fold_in(kd, faults.index("straggler")), (N,))
        return st

    to_np = lambda tree: {k: np.asarray(v) for k, v in tree.items()}  # noqa: E731
    return to_np(init_draws()), [to_np(step_draws(r)) for r in range(STEPS)]


def _copy(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _snapshot(state, aux):
    snap = {"send": np.asarray(aux["send"]), "params": state["params"],
            "ages": state["sched"]["ages"], "faults": state["faults"],
            "load_acc": state["load_acc"]}
    if "ev" in state:
        snap.update(ev=state["ev"], rd=state["rd"], stats=state["stats"],
                    clock=state["clock"], version=state["version"])
    else:
        snap["agg_stats"] = state["agg_stats"]
    return snap


def _record(mp, module, name, wrap):
    """Record ``module.name``'s (indices, mask) outputs as the engine
    calls it: the async pop or the sync cohort."""
    out = []
    orig = getattr(module, name)

    def recorded(*a, **kw):
        res = orig(*a, **kw)
        i, v = (res[1], res[2]) if name == "pop_events" else res
        wrap(out, i, v)
        return res

    mp.setattr(module, name, recorded)
    return out


def _jax_record(out, i, v):
    jax.debug.callback(lambda a, b: out.append((np.array(a), np.array(b))), i, v)


def _torch_record(out, i, v):
    out.append((i.numpy().copy(), v.numpy().copy()))


def _tasks():
    train, test = ref_make_images(*DATA, seed=0, difficulty=0.8)
    task_r = ref_make_cnn_task(dataclasses.replace(REF_MNIST, **SMALL), train, test, N)
    train, test = make_image_dataset(*DATA, seed=0, difficulty=0.8)
    task_p = make_cnn_task(dataclasses.replace(MNIST_CNN, **SMALL), train, test, N,
                           device="cpu")
    return task_r, task_p


def run_both(cfg, forced=False):
    """Both engines step by step, recording pops/cohorts and snapshots.
    ``forced``: each port step starts from the reference's params of the
    step before."""
    mp = pytest.MonkeyPatch()
    asyn = cfg["mode"] == "async"
    module = (ref_events, pt_events) if asyn else (ref_sync_mod, pt_sync_mod)
    name = "pop_events" if asyn else "cohort_indices"
    try:
        task_r, task_p = _tasks()
        ref_rec = _record(mp, module[0], name, _jax_record)
        eng_r = (RefAsyncEngine if asyn else RefSyncEngine)(task_r, RefRunConfig(**cfg))
        state = eng_r.init()
        ref_steps = []
        for r in range(STEPS):
            state, aux = eng_r.step(state, r)
            ref_steps.append(_copy(_snapshot(state, aux)))
        ref_pops = list(ref_rec[:STEPS])
        ref_result = eng_r.finalize(state, [], None, 0.0)

        shapes = [(p, tuple(v.shape)) for p, v in
                  tree_paths(jax.tree.map(np.asarray, ref_steps[0]["params"]))]
        init, steps = reference_draws(cfg, task_p.examples_per_client, shapes)
        pt_rec = _record(mp, module[1], name, _torch_record)
        eng_p = make_engine(task_p, RunConfig(**cfg), draws=ReplayDraws(init, steps, "cpu"))
        state = eng_p.init()
        pt_steps = []
        for r in range(STEPS):
            if forced and r:
                state["params"] = params_from_jax(ref_steps[r - 1]["params"], "cpu")
            state, aux = eng_p.step(state, r)
            pt_steps.append(_snapshot(state, aux))
        pt_result = eng_p.finalize(state, [], None, 0.0)
    finally:
        mp.undo()
    return dict(ref_steps=ref_steps, ref_pops=ref_pops, pt_steps=pt_steps,
                pt_pops=list(pt_rec), ref_result=ref_result, pt_result=pt_result)


RUNS = {
    "async": (ASYNC_CFG, False),
    "sync_trimmed_mean": ({**SYNC_CFG, "aggregator": "trimmed_mean",
                           "aggregator_kwargs": {"trim": 0.2}}, True),
    "sync_coordinate_median": ({**SYNC_CFG, "aggregator": "coordinate_median"}, True),
}


@pytest.fixture(scope="module", params=list(RUNS))
def runs(request):
    cfg, forced = RUNS[request.param]
    return {**run_both(cfg, forced), "cfg": cfg}


def _same_bits(got, exp, what):
    got, exp = _np(got), np.asarray(exp)
    assert got.dtype == exp.dtype or got.dtype.kind == exp.dtype.kind, what
    np.testing.assert_array_equal(got, exp, err_msg=what)


def test_discrete_outputs_equal_exactly(runs):
    asyn = runs["cfg"]["mode"] == "async"
    assert len(runs["pt_pops"]) == len(runs["ref_pops"]) == STEPS
    for r, (pt, ref) in enumerate(zip(runs["pt_steps"], runs["ref_steps"])):
        _same_bits(pt["send"], ref["send"], f"send {r}")
        (pi, pv), (ri, rv) = runs["pt_pops"][r], runs["ref_pops"][r]
        np.testing.assert_array_equal(pi, ri, err_msg=f"idx {r}")
        np.testing.assert_array_equal(pv, rv, err_msg=f"valid {r}")
        _same_bits(pt["ages"], ref["ages"], f"ages {r}")
        for name, fst in ref["faults"].items():
            for key in ("prone", "injected", "exposed"):
                _same_bits(pt["faults"][name][key], fst[key], f"{name}.{key} {r}")
        for key, val in ref["load_acc"].items():
            assert _np(pt["load_acc"][key]).tobytes() == val.tobytes(), key
        if asyn:
            assert int(pt["version"]) == int(ref["version"])
            _same_bits(pt["rd"]["retries"], ref["rd"]["retries"], f"rd.retries {r}")
            # dispatch times are clock readings: within the clock's tolerance
            np.testing.assert_allclose(_np(pt["rd"]["t_disp"]), ref["rd"]["t_disp"],
                                       rtol=1e-6, err_msg=f"rd.t_disp {r}")
            for key, val in ref["stats"].items():
                if key.startswith(("wall_", "ep_")):
                    continue  # float sums of clock differences: below
                _same_bits(pt["stats"][key], val, f"stats.{key} {r}")
            ev = state_to_jax(pt["ev"])
            for key in ("disp_ver", "dropped"):
                np.testing.assert_array_equal(ev[key], ref["ev"][key], err_msg=key)
            for key in ("t_done", "next_avail", "last_done"):
                np.testing.assert_allclose(ev[key], ref["ev"][key], rtol=1e-6,
                                           err_msg=key)
        else:
            for key, val in ref["agg_stats"].items():
                _same_bits(pt["agg_stats"][key], val, f"agg_stats.{key} {r}")
    # the run is not degenerate: every fault hit, the deadline fired
    last = runs["ref_steps"][-1]
    for name, fst in last["faults"].items():
        assert float(fst["injected"]) > 0, name
    if asyn:
        assert float(last["stats"]["rd_expired"]) > 0
        assert float(last["stats"]["redispatched"]) > 0
        assert int(last["version"]) >= 2


def test_float_outputs_within_tolerance(runs):
    asyn = runs["cfg"]["mode"] == "async"
    for r, (pt, ref) in enumerate(zip(runs["pt_steps"], runs["ref_steps"])):
        if asyn:
            np.testing.assert_allclose(float(pt["clock"]), float(ref["clock"]),
                                       rtol=1e-6)
        got = params_to_jax(pt["params"])
        for layer, leaves in ref["params"].items():
            for name, val in leaves.items():
                np.testing.assert_allclose(got[layer][name], val, rtol=1e-4, atol=1e-5,
                                           err_msg=f"step {r} {layer}.{name}")
    # the attacks moved the params
    first, last = runs["ref_steps"][0]["params"], runs["ref_steps"][-1]["params"]
    assert not np.allclose(first["fc2"]["w"], last["fc2"]["w"])


def test_load_stats_match(runs):
    pt, ref = runs["pt_result"], runs["ref_result"]
    keys = [k for k in ref.load_stats if k.startswith(("fault_", "agg_", "rd_",
                                                          "redispatched"))]
    assert keys and sorted(keys) == sorted(
        k for k in pt.load_stats if k.startswith(("fault_", "agg_", "rd_",
                                                  "redispatched")))
    for key in keys:
        assert pt.load_stats[key] == ref.load_stats[key], key


# ---------------------------------------------------------------------------
# the port's own contracts (native draws, CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_task():
    train, test = make_image_dataset("mnist-faults", 10, 8, 1, 120, 60, seed=0,
                                     difficulty=0.8)
    return make_cnn_task(dataclasses.replace(MNIST_CNN, **SMALL), train, test, 16,
                         device="cpu")


def _cfg(**kw):
    base = dict(n_clients=16, k=4, m=4, policy="markov", rounds=4, local_epochs=1,
                batch_size=5, eval_every=2, mode="async", buffer_size=3,
                profile="mobile")
    base.update(kw)
    return RunConfig(**base)


def _same_state(a, b):
    assert [p for p, _ in tree_paths(a)] == [p for p, _ in tree_paths(b)]
    for (p, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        assert torch.equal(x, y), p


def test_faults_off_adds_no_state(small_task):
    engine = make_engine(small_task, _cfg())
    state = engine.init()
    engine.step(state, 0)
    assert "faults" not in state and "rd" not in state
    assert list(engine.draws.get_state()) == [""]  # no sub-stream was made
    armed = make_engine(small_task, _cfg(faults=("dropout",), redispatch_timeout=5.0))
    state = armed.init()
    armed.step(state, 0)
    assert "faults" in state and "rd" in state
    assert sorted(armed.draws.get_state()) == ["", "faults", "faults/dropout",
                                               "redispatch"]


ALL_ENGINE_FAULTS = ("dropout", "straggler", "stale_replay", "corrupt", "sign_flip",
                     "scale_attack")


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_rate_zero_fault_set_is_bitwise_identity(small_task, mode):
    """Every engine fault armed at rate 0 (and, async, a deadline that
    never fires) moves no bit: effects apply through per-slot ``where``
    and the fault draws come from their own sub-streams."""
    if mode == "sync":
        kw = dict(mode="sync", buffer_size=None, profile="lognormal")
        armed_kw = dict(faults=("dropout", "corrupt", "sign_flip", "scale_attack"))
    else:
        kw, armed_kw = {}, dict(faults=ALL_ENGINE_FAULTS, redispatch_timeout=1e9)
    base = make_engine(small_task, _cfg(**kw))
    armed = make_engine(small_task, _cfg(fault_rate=0.0, **armed_kw, **kw))
    sb, sa = base.init(), armed.init()
    for r in range(4):
        sb, auxb = base.step(sb, r)
        sa, auxa = armed.step(sa, r)
        assert torch.equal(auxb["send"], auxa["send"])
        assert torch.equal(auxb["loss"], auxa["loss"]) or (
            auxb["loss"].isnan() and auxa["loss"].isnan())
    _same_state(base.eval_params(sb), armed.eval_params(sa))
    # chunked == per-step under armed-but-cold faults too
    chunk = make_engine(small_task, _cfg(fault_rate=0.0, **armed_kw, **kw))
    sc, _ = chunk.run_chunk(chunk.init(), 0, 4, False)
    _same_state(armed.eval_params(sa), chunk.eval_params(sc))


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_armed_chunked_equals_per_step(small_task, mode):
    if mode == "sync":
        kw = dict(mode="sync", buffer_size=None, profile="lognormal",
                  faults=("dropout", "corrupt", "scale_attack", "collude"),
                  aggregator="coordinate_median")
    else:
        kw = dict(faults=ALL_ENGINE_FAULTS + ("collude",), redispatch_timeout=2.0,
                  aggregator="norm_clip")
    per_step = make_engine(small_task, _cfg(fault_rate=0.5, **kw))
    state = per_step.init()
    for r in range(4):
        state, _ = per_step.step(state, r)
    chunked = make_engine(small_task, _cfg(fault_rate=0.5, **kw))
    chunk_state, _ = chunked.run_chunk(chunked.init(), 0, 4, False)
    _same_state(state, chunk_state)
    assert sum(float(f["injected"]) for f in state["faults"].values()) > 0


def test_sync_rejects_async_only_faults(small_task):
    cfg = _cfg(mode="sync", buffer_size=None, profile="lognormal",
               faults=("straggler", "stale_replay"))
    with pytest.raises(ValueError, match="straggler, stale_replay"):
        SyncEngine(small_task, cfg)


def test_straggler_stretches_the_simulated_clock(small_task):
    base = run_engine(make_engine(small_task, _cfg(rounds=6)))
    stalled = run_engine(make_engine(small_task, _cfg(
        rounds=6, faults=("straggler",), fault_rate=1.0,
        fault_kwargs={"straggler": {"stall": 100.0}})))
    assert stalled.load_stats["fault_straggler_injected"] > 0
    assert stalled.wall_stats["sim_time"] > base.wall_stats["sim_time"]


def test_dropout_reduces_applied_updates(small_task):
    base = run_engine(make_engine(small_task, _cfg(rounds=6)))
    dropped = run_engine(make_engine(small_task, _cfg(
        rounds=6, faults=("dropout",), fault_rate=1.0)))
    assert dropped.load_stats["fault_dropout_injected"] > 0
    assert dropped.wall_stats["updates_applied"] < base.wall_stats["updates_applied"]


def test_redispatch_counts_and_gating(small_task):
    off = run_engine(make_engine(small_task, _cfg(rounds=6)))
    assert "redispatched" not in off.load_stats
    on = run_engine(make_engine(small_task, _cfg(
        rounds=6, faults=("straggler",), fault_rate=1.0,
        fault_kwargs={"straggler": {"stall": 1000.0}},
        redispatch_timeout=1.0, redispatch_retries=2)))
    # every dispatch straggles 1000x, so the deadline must fire
    assert on.load_stats["rd_expired"] > 0
    assert on.load_stats["redispatched"] > 0


def test_agg_clipped_and_exposure_in_engine_run(small_task):
    res = run_engine(make_engine(small_task, _cfg(
        aggregator="norm_clip", aggregator_kwargs={"clip": 1e-4},
        faults=("corrupt",), fault_rate=1.0, fault_exposure=True)))
    assert res.load_stats["agg_clipped"] > 0
    exp = res.fault_exposure["corrupt"]
    assert exp.shape == (16,) and exp.sum() == res.load_stats["fault_corrupt_injected"]
    calm = run_engine(make_engine(small_task, _cfg()))
    assert calm.fault_exposure is None and "agg_clipped" not in calm.load_stats
