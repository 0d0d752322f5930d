"""The port's adaptive defense (slice E) as a whole against the reference
engines: the same fleet, data, initial params and — through
``ReplayDraws`` — the same random draws, the quarantine chain's fold-108
coins included, step by step.

Runs (16 clients, ``tests/test_defense.py``'s small CNN and fleet):
  * async, reputation + quarantine + the mtd trim ladder (threshold 0.3,
    window 2) under a -3x scale attack on a quarter of the fleet, on the
    ``mobile`` profile (dropouts and availability gaps);
  * async, collusion sketches + the learned head fed exposure labels
    (``tests/test_collusion.py``'s ``ARMED``) under the ``collude`` fault;
  * sync, the aggregator-family ladder (base, trimmed_mean,
    coordinate_median, norm_clip) with collusion armed under the scale
    attack, walking up every rung.

Exact: send masks, popped (or selected) indices and valid masks, ages,
``status``, ``level``, ``win``, the defense counters (``quarantined``,
``readmitted``, ``pressure``, ``win_obs``, ``clique_hits``, ``sk_obs``,
the AUC histograms), the fault state and the ``def_*`` statistics.
Within tolerance: ``sketch`` and ``lw`` (rtol 1e-5, atol 1e-6: f32
functions of f32 deltas that the two frameworks sum in other orders),
``rep`` (rtol 1e-5, atol 1e-5: its cosine channel divides f32 cosines by a
MAD scale floored at 0.05, which amplifies an ordering difference up to
20x; ``tests/test_torch_defense.py``) and params (rtol 1e-4 / atol 1e-5,
the slice tests'). As in the other sync slice tests, each port sync round
starts from the reference's params of the round before (an order
statistic can pick a neighbouring value when two deltas are within an
ulp). Each run asserts that the reference quarantined someone, so parity
is never shown on a silent defense.

The reference's closed-loop tests
``tests/test_defense.py::test_quarantine_catches_attackers_and_bars_selection``,
``tests/test_defense.py::test_mtd_escalates_under_pressure`` and
``tests/test_collusion.py::test_sync_collusion_catches_coalition`` are red
on the reference (ROADMAP queue 3) and stay out of the parity targets:
the port holds their contracts through the replayed runs here (attackers
quarantined and barred from selection, the ladder escalating) and through
``chip_smoke.py``'s ``sync_defense`` phase on the card.

Then the port's own contracts on native draws, the within-port
counterparts of ``tests/test_defense.py`` and ``tests/test_collusion.py``
without the sharded cases (slice F): defense off adds no state and no
sub-stream; the collusion/learned leaves exist only when armed; an
explicit ``zscore`` detector is the default bit for bit; ``threshold=inf``
armed == calm (per-step and chunked, both engines); armed chunked ==
per-step; quarantined clients are never dispatched; the mtd host-read
rule; the learned head sees both classes.
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
from repro.fl import make_cnn_task as ref_make_cnn_task  # noqa: E402
from repro.sim import events as ref_events  # noqa: E402
import repro_torch.engine.sync as pt_sync_mod  # noqa: E402
from repro_torch.configs.paper_cnn import MNIST_CNN  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.draws import ReplayDraws  # noqa: E402
from repro_torch.core.tree import tree_paths  # noqa: E402
from repro_torch.data.synthetic import make_image_dataset  # noqa: E402
from repro_torch.engine import AsyncEngine, RunConfig, make_engine, run_engine  # noqa: E402
from repro_torch.fl import make_cnn_task  # noqa: E402
from repro_torch.sim import events as pt_events  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

N, SEED, EPOCHS = 16, 0, 1
SMALL = dict(name="paper-cnn-mnist-defense", image_size=8, conv_channels=(4, 8),
             fc_width=32)
DATA = ("mnist-defense", 10, 8, 1, 120, 60)
BASE = dict(n_clients=N, k=4, m=4, policy="markov", local_epochs=EPOCHS,
            batch_size=5, lr0=0.02, seed=SEED, eval_every=2)
ASYNC = dict(BASE, mode="async", buffer_size=3, profile="mobile")
SYNC = dict(BASE, mode="sync", k=12, m=12)
ATTACK = dict(faults=("scale_attack",), fault_rate=1.0,
              fault_kwargs={"scale_attack": {"factor": -3.0, "client_frac": 0.25}})
COLLUDE = dict(faults=("collude",), fault_rate=1.0,
               fault_kwargs={"collude": {"client_frac": 0.25, "jitter": 0.1}})
ARMED = dict(defense=True,
             defense_kwargs={"threshold": 0.3, "mtd": True, "mtd_window": 2,
                             "mtd_up": 0.05, "mtd_down": 0.01}, **ATTACK)
ARMED_COLLUSION = dict(defense=True,
                       defense_kwargs={"threshold": 0.3, "collusion": True,
                                       "detector": "learned", "clique_min_obs": 2},
                       fault_exposure=True, **COLLUDE)
FAMILIES = dict(defense=True,
                defense_kwargs={"threshold": 0.5, "ewma": 0.5, "collusion": True,
                                "clique_min_obs": 2, "mtd": True, "mtd_window": 2,
                                "mtd_up": 0.05, "mtd_down": 0.01,
                                "mtd_trims": (0.0, 0.1, 0.0, 0.0),
                                "mtd_families": ("base", "trimmed_mean",
                                                 "coordinate_median", "norm_clip")},
                **ATTACK)
RUNS = {
    "async_armed_mtd": (dict(ASYNC, rounds=8, **ARMED), False),
    "async_collusion_learned": (dict(ASYNC, rounds=8, **ARMED_COLLUSION), False),
    "sync_family_ladder": (dict(SYNC, rounds=8, **FAMILIES), True),
}


def _u(key, shape):
    return jax.random.uniform(key, shape)


def _normal(key, shape):
    return jax.random.normal(key, shape, jnp.float32)


def reference_draws(cfg, examples, shapes):
    """Every primitive draw of the reference's armed run under its own key
    schedule: engine/async_engine.py (folds 101, 102, 103, 105 with its
    sub-fold 1, 108 with its sub-folds 0 and 1) and engine/sync.py; the
    init as in ``test_torch_fault_slice.py``."""
    ref_cfg = RefRunConfig(**cfg)
    asyn = cfg["mode"] == "async"
    n, k, m = cfg["n_clients"], cfg["k"], cfg["m"]
    width = ref_cfg.resolved_buffer_size() if asyn else ref_cfg.cohort_width()
    faults = cfg["faults"]
    k_init, k_policy, k_run = jax.random.split(jax.random.PRNGKey(SEED), 3)

    @jax.jit
    def init_draws():
        init = {f"params/{name}": _normal(kk, dict(shapes)[f"{name}/w"])
                for name, kk in zip(("conv1", "conv2", "fc1", "fc2"),
                                    jax.random.split(k_init, 4))}
        pi = jnp.asarray(ref_lm.steady_state(ref_lm.optimal_probs(n, k, m))
                         .astype(np.float32))
        init["policy_init"] = jax.random.choice(k_policy, m + 1, shape=(n,), p=pi)
        k_fault_init = jax.random.fold_in(k_run, 2**31)
        if asyn:
            init["speed"] = _normal(k_fault_init, (n,))
            k_fault_init = jax.random.fold_in(k_fault_init, 7)
        for i, name in enumerate(faults):  # client_frac 0.25: a prone draw
            init[f"faults/{name}/prone"] = _u(jax.random.fold_in(k_fault_init, i), (n,))
        return init

    def perm(kb):  # fl/client.py: one permutation per slot and epoch
        return jax.vmap(lambda ke: jax.random.permutation(ke, examples))(
            jax.random.split(kb, EPOCHS))

    @jax.jit
    def step_draws(r):
        k_sel, k_local = jax.random.split(jax.random.fold_in(k_run, r))
        k_pop = jax.random.fold_in(jax.random.fold_in(k_sel, 105), 1)
        k_def = jax.random.fold_in(k_sel, 108)
        st = {"select": _u(k_sel, (n,)),
              "local_perm": jax.vmap(perm)(jax.random.split(k_local, width)),
              "defense/probation": _u(jax.random.fold_in(k_def, 0), (n,)),
              "defense/readmit": _u(jax.random.fold_in(k_def, 1), (n,))}
        for i, name in enumerate(faults):
            ki = jax.random.fold_in(k_pop, i)
            if name == "collude":
                st["faults/collude/hit"] = _u(jax.random.fold_in(ki, 0), (width,))
                st["faults/collude/jitter"] = _normal(jax.random.fold_in(ki, 1),
                                                      (width,))
            else:
                st[f"faults/{name}/hit"] = _u(ki, (width,))
        if asyn:
            k_c, k_t = jax.random.split(jax.random.fold_in(k_sel, 101))
            st["latency_compute"] = _normal(k_c, (n,))
            st["latency_comm"] = jax.random.exponential(k_t, (n,), jnp.float32)
            st["dropout"] = _u(jax.random.fold_in(k_sel, 102), (n,))
            st["avail_gap"] = jax.random.exponential(jax.random.fold_in(k_sel, 103),
                                                     (width,), jnp.float32)
        return st

    to_np = lambda tree: {k: np.asarray(v) for k, v in tree.items()}  # noqa: E731
    return to_np(init_draws()), [to_np(step_draws(r)) for r in range(cfg["rounds"])]


def _copy(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _snapshot(state, aux):
    snap = {"send": np.asarray(aux["send"]), "params": state["params"],
            "ages": state["sched"]["ages"], "faults": state["faults"],
            "defense": state["defense"], "load_acc": state["load_acc"]}
    if "ev" in state:
        snap.update(stats=state["stats"], version=state["version"])
    return snap


def _record(mp, module, name, wrap):
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
    steps = cfg["rounds"]
    try:
        task_r, task_p = _tasks()
        ref_rec = _record(mp, module[0], name, _jax_record)
        eng_r = (RefAsyncEngine if asyn else RefSyncEngine)(task_r, RefRunConfig(**cfg))
        state = eng_r.init()
        ref_steps = []
        for r in range(steps):
            state, aux = eng_r.step(state, r)
            ref_steps.append(_copy(_snapshot(state, aux)))
        ref_pops = list(ref_rec[:steps])
        ref_result = eng_r.finalize(state, [], None, 0.0)

        shapes = [(p, tuple(v.shape)) for p, v in
                  tree_paths(jax.tree.map(np.asarray, ref_steps[0]["params"]))]
        init, per_step = reference_draws(cfg, task_p.examples_per_client, shapes)
        pt_rec = _record(mp, module[1], name, _torch_record)
        eng_p = make_engine(task_p, RunConfig(**cfg),
                            draws=ReplayDraws(init, per_step, "cpu"))
        state = eng_p.init()
        pt_steps = []
        for r in range(steps):
            if forced and r:
                state["params"] = params_from_jax(ref_steps[r - 1]["params"], "cpu")
            state, aux = eng_p.step(state, r)
            pt_steps.append(_snapshot(state, aux))
        pt_result = eng_p.finalize(state, [], None, 0.0)
    finally:
        mp.undo()
    return dict(ref_steps=ref_steps, ref_pops=ref_pops, pt_steps=pt_steps,
                pt_pops=list(pt_rec), ref_result=ref_result, pt_result=pt_result,
                defense=eng_p.defense)


@pytest.fixture(scope="module", params=list(RUNS))
def runs(request):
    cfg, forced = RUNS[request.param]
    return {**run_both(cfg, forced), "cfg": cfg}


def _same_bits(got, exp, what):
    got, exp = _np(got), np.asarray(exp)
    assert got.dtype.kind == exp.dtype.kind, what
    np.testing.assert_array_equal(got, exp, err_msg=what)


EXACT_DEFENSE = ("status", "level", "win", "quarantined", "readmitted", "pressure",
                 "win_obs", "clique_hits", "sk_obs", "auc")
CLOSE_DEFENSE = ("rep", "sketch", "lw")


def test_discrete_outputs_equal_exactly(runs):
    asyn = runs["cfg"]["mode"] == "async"
    steps = runs["cfg"]["rounds"]
    assert len(runs["pt_pops"]) == len(runs["ref_pops"]) == steps
    for r, (pt, ref) in enumerate(zip(runs["pt_steps"], runs["ref_steps"])):
        _same_bits(pt["send"], ref["send"], f"send {r}")
        (pi, pv), (ri, rv) = runs["pt_pops"][r], runs["ref_pops"][r]
        np.testing.assert_array_equal(pi, ri, err_msg=f"idx {r}")
        np.testing.assert_array_equal(pv, rv, err_msg=f"valid {r}")
        _same_bits(pt["ages"], ref["ages"], f"ages {r}")
        assert sorted(pt["defense"]) == sorted(ref["defense"])
        for key in EXACT_DEFENSE:
            if key in ref["defense"]:
                _same_bits(pt["defense"][key], ref["defense"][key], f"defense.{key} {r}")
        for name, fst in ref["faults"].items():
            for key in ("prone", "injected", "exposed"):
                _same_bits(pt["faults"][name][key], fst[key], f"{name}.{key} {r}")
        for key, val in ref["load_acc"].items():
            assert _np(pt["load_acc"][key]).tobytes() == val.tobytes(), key
        if asyn:
            assert int(pt["version"]) == int(ref["version"])
            for key in ("updates", "aggs", "stale_max", "stale_cnt", "stale_sum"):
                _same_bits(pt["stats"][key], ref["stats"][key], f"stats.{key} {r}")
    # the run is not degenerate: the reference quarantined someone, and a
    # quarantined client is never dispatched while it is benched
    last = runs["ref_steps"][-1]["defense"]
    assert float(last["quarantined"]) > 0
    for prev, cur in zip(runs["ref_steps"], runs["ref_steps"][1:]):
        assert not (cur["send"] & (np.asarray(prev["defense"]["status"]) == 1)).any()


def test_float_outputs_within_tolerance(runs):
    for r, (pt, ref) in enumerate(zip(runs["pt_steps"], runs["ref_steps"])):
        for key in CLOSE_DEFENSE:
            if key in ref["defense"]:
                np.testing.assert_allclose(_np(pt["defense"][key]), ref["defense"][key],
                                           rtol=1e-5, atol=1e-5 if key == "rep" else 1e-6,
                                           err_msg=f"defense.{key} {r}")
        got = params_to_jax(pt["params"])
        for layer, leaves in ref["params"].items():
            for name, val in leaves.items():
                np.testing.assert_allclose(got[layer][name], val, rtol=1e-4, atol=1e-5,
                                           err_msg=f"step {r} {layer}.{name}")


def test_defense_statistics_match(runs):
    pt, ref = runs["pt_result"], runs["ref_result"]
    keys = sorted(k for k in ref.load_stats if k.startswith("def_"))
    assert keys and keys == sorted(k for k in pt.load_stats if k.startswith("def_"))
    for key in keys:
        exp, got = ref.load_stats[key], pt.load_stats[key]
        assert got == exp or (np.isnan(exp) and np.isnan(got)), key
    np.testing.assert_array_equal(pt.defense["status"], ref.defense["status"])
    np.testing.assert_allclose(pt.defense["reputation"], ref.defense["reputation"],
                               rtol=1e-5, atol=1e-5)


def test_ladder_rungs_were_taken(runs):
    """The mtd runs leave level 0 (so the rungs, not just the base rule,
    are held to the reference) and read the level once a closed window."""
    cfg = runs["cfg"]
    if not cfg["defense_kwargs"].get("mtd"):
        assert runs["defense"].host_reads == 0
        return
    levels = [int(s["defense"]["level"]) for s in runs["ref_steps"]]
    assert max(levels) >= (3 if "mtd_families" in cfg["defense_kwargs"] else 1), levels
    windows = cfg["rounds"] // cfg["defense_kwargs"]["mtd_window"]
    assert runs["defense"].host_reads == windows
    assert runs["defense"].restore_reads == 0


# ---------------------------------------------------------------------------
# the port's own contracts (native draws, CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_task():
    train, test = make_image_dataset(*DATA, seed=0, difficulty=0.8)
    return make_cnn_task(dataclasses.replace(MNIST_CNN, **SMALL), train, test, N,
                         device="cpu")


def _cfg(**kw):
    base = dict(n_clients=N, k=4, m=4, policy="markov", rounds=4, local_epochs=1,
                batch_size=5, eval_every=2, mode="async", buffer_size=3,
                profile="mobile")
    base.update(kw)
    return RunConfig(**base)


def _same_state(a, b):
    assert [p for p, _ in tree_paths(a)] == [p for p, _ in tree_paths(b)]
    for (p, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        assert torch.equal(x, y), p


SYNC_KW = dict(mode="sync", buffer_size=None, profile="lognormal")


def test_defense_off_adds_no_state(small_task):
    engine = make_engine(small_task, _cfg())
    state, _ = engine.step(engine.init(), 0)
    assert "defense" not in state
    assert list(engine.draws.get_state()) == [""]  # no sub-stream was made
    armed = make_engine(small_task, _cfg(defense=True))
    state, _ = armed.step(armed.init(), 0)
    assert set(state["defense"]) == {"rep", "status", "quarantined", "readmitted",
                                     "pressure", "win_obs", "win", "level"}
    assert sorted(armed.draws.get_state()) == ["", "defense"]
    assert state["defense"]["rep"].dtype == torch.float32
    assert state["defense"]["status"].dtype == torch.int32
    assert state["defense"]["level"].shape == ()


def test_collusion_and_learned_state_is_conditional(small_task):
    base_keys = set(make_engine(small_task, _cfg(defense=True)).init()["defense"])
    col = make_engine(small_task, _cfg(
        defense=True, defense_kwargs={"collusion": True})).init()["defense"]
    assert set(col) == base_keys | {"sketch", "sk_obs", "clique_hits"}
    assert col["sketch"].shape == (N, 64)
    lrn = make_engine(small_task, _cfg(
        defense=True, defense_kwargs={"detector": "learned"})).init()["defense"]
    assert set(lrn) == base_keys | {"lw", "auc"}
    assert lrn["lw"].shape == (1, 8) and lrn["auc"].shape == (2, 16)


def test_explicit_zscore_detector_is_bitwise_default(small_task):
    kw = dict(ARMED, defense_kwargs={**ARMED["defense_kwargs"], "detector": "zscore"})
    eng_d = make_engine(small_task, _cfg(rounds=4, **ARMED))
    eng_z = make_engine(small_task, _cfg(rounds=4, **kw))
    s1, _ = eng_d.run_chunk(eng_d.init(), 0, 4, False)
    s2, _ = eng_z.run_chunk(eng_z.init(), 0, 4, False)
    _same_state(s1, s2)


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_threshold_inf_defense_is_bitwise_identity(small_task, mode):
    """The full scoring pipeline armed with an unreachable threshold moves
    no bit: every exclusion is ``x & ~False``, the mtd ladder stays at
    level 0 (the base rule's params), and the coins come from their own
    sub-stream. Per-step and chunked."""
    kw = SYNC_KW if mode == "sync" else {}
    base = make_engine(small_task, _cfg(**kw))
    armed_kw = dict(defense=True, defense_kwargs={"threshold": float("inf"),
                                                  "mtd": True, "mtd_window": 2}, **kw)
    armed = make_engine(small_task, _cfg(**armed_kw))
    sb, sa = base.init(), armed.init()
    for r in range(4):
        sb, auxb = base.step(sb, r)
        sa, auxa = armed.step(sa, r)
        assert torch.equal(auxb["send"], auxa["send"])
        assert torch.equal(auxb["loss"].nan_to_num(-1.0), auxa["loss"].nan_to_num(-1.0))
    _same_state(base.eval_params(sb), armed.eval_params(sa))
    chunk = make_engine(small_task, _cfg(**armed_kw))
    sc, _ = chunk.run_chunk(chunk.init(), 0, 4, False)
    _same_state(sa, sc)


@pytest.mark.parametrize("armed", ["mtd", "collusion_learned", "sync_families"])
def test_armed_chunked_matches_per_step(small_task, armed):
    kw = {"mtd": dict(ARMED), "collusion_learned": dict(ARMED_COLLUSION),
          "sync_families": dict(SYNC_KW, k=12, m=12, **FAMILIES)}[armed]
    per_step = make_engine(small_task, _cfg(rounds=8, **kw))
    sa = per_step.init()
    for r in range(8):
        sa, _ = per_step.step(sa, r)
    chunked = make_engine(small_task, _cfg(rounds=8, **kw))
    sc, _ = chunked.run_chunk(chunked.init(), 0, 8, False)
    _same_state(sa, sc)
    assert float(sa["defense"]["quarantined"]) > 0


def test_quarantined_clients_are_never_dispatched(small_task):
    """The admission seam: a client benched at a step's start is not sent
    the model in that step, and still ages."""
    engine = make_engine(small_task, _cfg(rounds=10, defense=True,
                                          defense_kwargs={"threshold": 0.3}, **ATTACK))
    state = engine.init()
    benched_any = False
    for r in range(10):
        benched = state["defense"]["status"] == 1
        ages = state["sched"]["ages"]
        state, aux = engine.step(state, r)
        assert not (aux["send"] & benched).any()
        assert torch.all(state["sched"]["ages"][benched] == ages[benched] + 1)
        benched_any |= bool(benched.any())
    assert benched_any


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_mtd_reads_the_level_once_per_closed_window(small_task, mode):
    kw = dict(SYNC_KW, k=12, m=12, **FAMILIES) if mode == "sync" else dict(ARMED)
    kw["defense_kwargs"] = {**kw["defense_kwargs"], "mtd_window": 3}
    engine = make_engine(small_task, _cfg(rounds=7, **kw))
    state, _ = engine.run_chunk(engine.init(), 0, 7, False)
    assert (engine.defense.host_reads, engine.defense.restore_reads) == (2, 0)
    # a state the engine did not make (a copy, as after a restore) is read
    # once to start the count, then the rule holds again
    copied = {**state, "defense": {k: v.clone() for k, v in state["defense"].items()}}
    engine.run_chunk(copied, 7, 5, False)
    assert (engine.defense.host_reads, engine.defense.restore_reads) == (4, 1)
    plain = make_engine(small_task, _cfg(rounds=4, defense=True,
                                         defense_kwargs={"collusion": True}, **ATTACK))
    plain.run_chunk(plain.init(), 0, 4, False)
    assert (plain.defense.host_reads, plain.defense.restore_reads) == (0, 0)


def test_learned_detector_runs_with_exposure_labels(small_task):
    res = run_engine(make_engine(small_task, _cfg(rounds=10, **ARMED_COLLUSION)))
    auc = res.load_stats["def_detector_auc"]
    assert not np.isnan(auc) and 0.0 <= auc <= 1.0
    assert res.load_stats["def_clique_hits"] >= 0
    assert res.defense["reputation"].shape == (N,)


def test_sync_engine_runs_learned_collusion(small_task):
    res = run_engine(make_engine(small_task, _cfg(
        k=8, m=8, rounds=6, **SYNC_KW, **ARMED_COLLUSION)))
    assert "def_detector_auc" in res.load_stats
    assert "def_clique_hits" in res.load_stats


def test_tiered_defense_reports_suspects_by_node(small_task):
    """Reputation and quarantine ride a hierarchy (mtd does not: config
    rejects it); the suspects are counted by tier-0 node."""
    res = run_engine(make_engine(small_task, _cfg(
        rounds=6, defense=True, defense_kwargs={"threshold": 0.3},
        topology="hierarchical", topology_kwargs={"tiers": (4,)}, **ATTACK)))
    counts = res.load_stats["tier_suspects"]
    assert len(counts) == 4
    assert sum(counts) == int((res.defense["status"] != 0).sum())


def test_defense_runs_on_the_engine_class(small_task):
    engine = AsyncEngine(small_task, _cfg(defense=True))
    assert engine.defense is not None and engine.defense.n == N
