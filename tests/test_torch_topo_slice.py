"""The port's topology slice (slice D) as a whole against the reference
engines: the same fleet, data, initial params and — through
``ReplayDraws`` — the same random draws, per-hop latencies included, step
by step.

Async (48 clients, 6 steps): ``hierarchical`` (4, 2) with a heartbeat
timeout that fires, under fedbuff, and ``gossip`` over 4 peers under
``norm_clip``. Sync (3 rounds): ``hierarchical`` (4, 2) under fedavg.

Exact: send masks, popped (or selected) indices and valid masks, ages,
versions, every counter (``hb_expired`` included), the per-tier
accumulators and the ``tier_*`` statistics. Within the tolerances of
``test_torch_async_slice.py`` and ``test_torch_sync_slice.py``: the clock
and the clock readings it stores (event times, heartbeat beats; rtol 1e-6)
and params (rtol 1e-4 / atol 1e-5). As in the sync slice test, each port
sync round starts from the reference's params of the round before.

Then the port's own contracts on native draws, bit for bit: a star equals
no topology in both engines (``tests/test_topo.py::
test_star_async_bit_for_bit`` states this contract and is red on the
reference); an armed hierarchy's ``run_chunk`` equals its steps; an
unreachable heartbeat timeout is inert; a timeout below any latency
excludes every update; and the drivers' topology flags.
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
from repro_torch.engine import (  # noqa: E402
    AsyncEngine,
    RunConfig,
    SyncEngine,
    make_engine,
    run_engine,
)
from repro_torch.fl import make_cnn_task  # noqa: E402
from repro_torch.launch import fl_async, fl_train  # noqa: E402
from repro_torch.launch._fl_cli import topology_args  # noqa: E402
from repro_torch.sim import events as pt_events  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

N, K, M, EPOCHS, SEED = 48, 8, 10, 2, 0
SMALL = dict(name="paper-cnn-mnist-topo", image_size=8, conv_channels=(4, 8),
             fc_width=32)
DATA = ("mnist-topo-slice", 10, 8, 1, 480, 120)  # 10 examples a client
BASE = dict(n_clients=N, k=K, m=M, policy="markov", local_epochs=EPOCHS,
            batch_size=5, lr0=0.02, seed=SEED, eval_every=1)
ASYNC_HIER = dict(BASE, mode="async", rounds=6, profile="lognormal",
                  topology="hierarchical",
                  topology_kwargs={"tiers": (4, 2), "heartbeat_timeout": 5.0})
ASYNC_GOSSIP = dict(BASE, mode="async", rounds=6, profile="lognormal",
                    aggregator="norm_clip", aggregator_kwargs={"clip": 1.0},
                    topology="gossip",
                    topology_kwargs={"nodes": 4, "degree": 2, "rounds": 2})
SYNC_HIER = dict(BASE, mode="sync", rounds=3, topology="hierarchical",
                 topology_kwargs={"tiers": (4, 2)})


def _normal(key, shape):
    return jax.random.normal(key, shape, jnp.float32)


def _latency(key, n, prefix=""):
    k_c, k_t = jax.random.split(key)
    return {f"{prefix}latency_compute": _normal(k_c, (n,)),
            f"{prefix}latency_comm": jax.random.exponential(k_t, (n,), jnp.float32)}


def _hop(key, topo):
    """``repro.topo.reduce.make_hop_latency``'s draws under ``key``: hop
    ``i`` from the ``i``-th split, sized by its link."""
    gossip = topo.kind == "gossip"
    sizes = [N] + ([int(topo.tier_sizes[0])] * topo.gossip_rounds if gossip
                   else [int(s) for s in topo.tier_sizes])
    links = max(topo.gossip_rounds, 1) if gossip else 1
    keys = jax.random.split(key, topo.n_tiers + links)
    out = {}
    for i, size in enumerate(sizes):
        out.update(_latency(keys[i], size, f"hop/{i}/"))
    return out


def reference_draws(cfg, examples, shapes):
    """Every primitive draw of the reference's run under its own key
    schedule: engine/async_engine.py (folds 101 and 104) and
    engine/sync.py; init as in ``test_torch_fault_slice.py``."""
    asyn = cfg["mode"] == "async"
    width = K if asyn else default_cohort_width(N, K)
    topo = RefRunConfig(**cfg).resolved_topology()
    k_init, k_policy, k_run = jax.random.split(jax.random.PRNGKey(SEED), 3)

    @jax.jit
    def init_draws():
        init = {f"params/{name}": _normal(kk, dict(shapes)[f"{name}/w"])
                for name, kk in zip(("conv1", "conv2", "fc1", "fc2"),
                                    jax.random.split(k_init, 4))}
        pi = jnp.asarray(ref_lm.steady_state(ref_lm.optimal_probs(N, K, M))
                         .astype(np.float32))
        init["policy_init"] = jax.random.choice(k_policy, M + 1, shape=(N,), p=pi)
        if asyn:
            init["speed"] = _normal(jax.random.fold_in(k_run, 2**31), (N,))
        return init

    def perm(kb):  # fl/client.py: one permutation per slot and epoch
        return jax.vmap(lambda ke: jax.random.permutation(ke, examples))(
            jax.random.split(kb, EPOCHS))

    @jax.jit
    def step_draws(r):
        k_sel, k_local = jax.random.split(jax.random.fold_in(k_run, r))
        st = {"select": jax.random.uniform(k_sel, (N,)),
              "local_perm": jax.vmap(perm)(jax.random.split(k_local, width))}
        if asyn:
            st.update(_latency(jax.random.fold_in(k_sel, 101), N))
            st.update(_hop(jax.random.fold_in(k_sel, 104), topo))
        return st

    to_np = lambda tree: {k: np.asarray(v) for k, v in tree.items()}  # noqa: E731
    return to_np(init_draws()), [to_np(step_draws(r)) for r in range(cfg["rounds"])]


def _copy(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _snapshot(state, aux):
    snap = {"send": np.asarray(aux["send"]), "params": state["params"],
            "ages": state["sched"]["ages"], "load_acc": state["load_acc"],
            "tier_acc": state["tier_acc"]}
    if "ev" in state:
        snap.update(ev=state["ev"], stats=state["stats"], clock=state["clock"],
                    version=state["version"])
        if "hb" in state:
            snap["hb"] = state["hb"]
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
                pt_pops=list(pt_rec), ref_result=ref_result, pt_result=pt_result)


RUNS = {"async_hier_heartbeat": (ASYNC_HIER, False),
        "async_gossip": (ASYNC_GOSSIP, False),
        "sync_hier": (SYNC_HIER, True)}


@pytest.fixture(scope="module", params=list(RUNS))
def runs(request):
    cfg, forced = RUNS[request.param]
    return {**run_both(cfg, forced), "cfg": cfg}


def _same_bits(got, exp, what):
    got, exp = _np(got), np.asarray(exp)
    assert got.dtype.kind == exp.dtype.kind, what
    np.testing.assert_array_equal(got, exp, err_msg=what)


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
        for key, val in ref["load_acc"].items():
            assert _np(pt["load_acc"][key]).tobytes() == val.tobytes(), key
        for key, val in ref["tier_acc"].items():
            assert _np(pt["tier_acc"][key]).tobytes() == val.tobytes(), f"tier {key}"
        if asyn:
            assert int(pt["version"]) == int(ref["version"])
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
            assert ("hb" in pt) == ("hb" in ref)
            if "hb" in ref:
                np.testing.assert_allclose(_np(pt["hb"]["last_beat"]),
                                           ref["hb"]["last_beat"], rtol=1e-6)
    last = runs["ref_steps"][-1]
    if asyn:
        assert int(last["version"]) >= 2
        if "hb" in last:  # the heartbeat fired and left updates through
            assert 0 < float(last["stats"]["hb_expired"])
            assert 0 < float(last["stats"]["updates"])


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
    first, last = runs["ref_steps"][0]["params"], runs["ref_steps"][-1]["params"]
    assert not np.allclose(first["fc2"]["w"], last["fc2"]["w"])


def test_result_statistics_match(runs):
    pt, ref = runs["pt_result"], runs["ref_result"]
    for key in ("tier_num_samples", "tier_mean_X", "tier_var_X"):
        assert len(ref.load_stats[key]) == 4
        np.testing.assert_array_equal(pt.load_stats[key], ref.load_stats[key], key)
    assert sum(pt.load_stats["tier_num_samples"]) == pt.load_stats["num_samples"]
    for key in [k for k in ref.load_stats if k.startswith("agg_")]:
        assert pt.load_stats[key] == ref.load_stats[key], key
    if ref.wall_stats is not None:
        assert pt.wall_stats.get("hb_expired") == ref.wall_stats.get("hb_expired")
        for key in ("updates_applied", "aggregations", "max_staleness"):
            assert pt.wall_stats[key] == ref.wall_stats[key], key


# ---------------------------------------------------------------------------
# the port's own contracts (native draws, CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_task():
    train, test = make_image_dataset("mnist-topo", 10, 8, 1, 120, 60, seed=0,
                                     difficulty=0.8)
    return make_cnn_task(dataclasses.replace(MNIST_CNN, **SMALL), train, test, 16,
                         device="cpu")


def _cfg(**kw):
    base = dict(n_clients=16, k=4, m=4, policy="markov", rounds=5, local_epochs=1,
                batch_size=5, eval_every=2, mode="async", buffer_size=3,
                profile="mobile")
    base.update(kw)
    return RunConfig(**base)


def _same_state(a, b):
    assert [p for p, _ in tree_paths(a)] == [p for p, _ in tree_paths(b)]
    for (p, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        assert torch.equal(x, y), p


def _per_step(engine, rounds):
    state = engine.init()
    sends, losses = [], []
    for r in range(rounds):
        state, aux = engine.step(state, r)
        sends.append(aux["send"])
        losses.append(aux["loss"].nan_to_num(-1.0))
    return state, torch.stack(sends), torch.stack(losses)


@pytest.mark.parametrize("mode,agg", [("async", "fedbuff"), ("async", "fedavg"),
                                      ("sync", "fedavg")])
def test_star_is_no_topology_bit_for_bit(small_task, mode, agg):
    """The contract of the reference's ``test_topo.py::
    test_star_async_bit_for_bit`` (red on the reference) and
    ``test_star_sync_bit_for_bit``: a star adds no state key, no draw and
    no op, per step and chunked."""
    kw = dict(aggregator=agg)
    if mode == "sync":
        kw.update(mode="sync", buffer_size=None, profile="lognormal")
    plain = make_engine(small_task, _cfg(**kw))
    star = make_engine(small_task, _cfg(topology="star", **kw))
    sp, sendp, lossp = _per_step(plain, 5)
    ss, sends, losss = _per_step(star, 5)
    _same_state(sp, ss)
    assert torch.equal(sendp, sends) and torch.equal(lossp, losss)
    assert list(star.draws.get_state()) == [""]  # no sub-stream was made
    a = run_engine(make_engine(small_task, _cfg(steps_per_chunk=5, **kw)))
    b = run_engine(make_engine(small_task, _cfg(steps_per_chunk=5, topology="star",
                                                **kw)))
    np.testing.assert_array_equal(a.selection, b.selection)
    _same_state(a.params, b.params)
    assert a.load_stats == b.load_stats and a.wall_stats == b.wall_stats


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_tiered_chunked_equals_per_step(small_task, mode):
    if mode == "sync":
        kw = dict(mode="sync", buffer_size=None, profile="lognormal",
                  topology="hierarchical", topology_kwargs={"tiers": (4, 2)})
    else:
        kw = dict(topology="hierarchical", redispatch_timeout=6.0,
                  aggregator="norm_clip",
                  topology_kwargs={"tiers": (4, 2), "heartbeat_timeout": 8.0})
    per_step = make_engine(small_task, _cfg(**kw))
    state = per_step.init()
    for r in range(5):
        state, _ = per_step.step(state, r)
    chunked = make_engine(small_task, _cfg(**kw))
    chunk_state, _ = chunked.run_chunk(chunked.init(), 0, 5, False)
    _same_state(state, chunk_state)
    assert "tier_acc" in state
    if mode == "async":
        assert sorted(per_step.draws.get_state()) == [
            "", "hop", "hop/0", "hop/1", "hop/2", "redispatch", "redispatch/hop",
            "redispatch/hop/0", "redispatch/hop/1", "redispatch/hop/2"]


def test_unreachable_heartbeat_is_inert(small_task):
    hier = dict(topology="hierarchical", topology_kwargs={"tiers": (4,)})
    base, sb, lb = _per_step(make_engine(small_task, _cfg(**hier)), 5)
    hb_cfg = _cfg(topology="hierarchical",
                  topology_kwargs={"tiers": (4,), "heartbeat_timeout": 1e9})
    armed, sa, la = _per_step(make_engine(small_task, hb_cfg), 5)
    assert torch.equal(sb, sa) and torch.equal(lb, la)
    _same_state(base["params"], armed["params"])
    assert float(armed["stats"]["hb_expired"]) == 0
    assert float(armed["stats"]["updates"]) == float(base["stats"]["updates"])
    # on a star, a heartbeat arms only itself
    star = run_engine(make_engine(small_task, _cfg(
        rounds=4, topology="star", topology_kwargs={"heartbeat_timeout": 1e9})))
    plain = run_engine(make_engine(small_task, _cfg(rounds=4)))
    np.testing.assert_array_equal(star.selection, plain.selection)
    _same_state(star.params, plain.params)
    assert star.wall_stats["hb_expired"] == 0 and "tier_var_X" not in star.load_stats


def test_heartbeat_below_any_latency_excludes_every_update(small_task):
    cfg = _cfg(topology="hierarchical",
               topology_kwargs={"tiers": (4,), "heartbeat_timeout": 1e-6})
    eng = AsyncEngine(small_task, cfg)
    state, _, _ = _per_step(eng, 5)
    assert float(state["stats"]["updates"]) == 0
    assert float(state["stats"]["hb_expired"]) > 0
    assert int(state["version"]) == 0
    _same_state(state["params"], AsyncEngine(small_task, cfg).init()["params"])


def test_hop_latency_slows_the_clock_and_tiers_report(small_task):
    star = run_engine(make_engine(small_task, _cfg()))
    hier = run_engine(make_engine(small_task, _cfg(
        rounds=8, topology="hierarchical", topology_kwargs={"tiers": (4, 2)})))
    assert hier.wall_stats["sim_time"] > star.wall_stats["sim_time"]
    assert len(hier.load_stats["tier_var_X"]) == 4
    assert sum(hier.load_stats["tier_num_samples"]) == hier.load_stats["num_samples"]


def test_engine_rejections(small_task):
    with pytest.raises(ValueError, match="needs the async"):
        SyncEngine(small_task, _cfg(mode="sync", buffer_size=None, topology="star",
                                    topology_kwargs={"heartbeat_timeout": 1.0}))
    with pytest.raises(ValueError, match="not additive"):
        make_engine(small_task, _cfg(topology="hierarchical", aggregator="trimmed_mean"))
    with pytest.raises(ValueError, match="topology_kwargs given without"):
        _cfg(topology_kwargs={"tiers": (4,)})
    with pytest.raises(ValueError, match="tier-0"):
        _cfg(topology="hierarchical", topology_kwargs={"tiers": (64,)})
    # slice F's options are validated as the reference validates them: a
    # 2-way mesh of 16 clients is accepted, cohort sharding without a mesh
    # raises its message
    base = dict(n_clients=16, k=4, m=4, policy="markov", rounds=5, local_epochs=1,
                batch_size=5, eval_every=2, mode="async", buffer_size=3,
                profile="mobile")
    assert _cfg(mesh_shards=2).mesh_shards == RefRunConfig(**base, mesh_shards=2).mesh_shards
    with pytest.raises(ValueError) as ref:
        RefRunConfig(**base, shard_cohort=True)
    with pytest.raises(ValueError) as got:
        _cfg(shard_cohort=True)
    assert str(got.value) == str(ref.value)
    ref_msg = None
    try:
        RefRunConfig(n_clients=16, k=4, topology="ring")
    except ValueError as exc:
        ref_msg = str(exc)
    with pytest.raises(ValueError) as got:
        _cfg(topology="ring")
    assert str(got.value) == ref_msg
    assert _cfg(topology="hierarchical").topology_name() == "hier[8]"
    assert _cfg().topology_name() == "star"


def test_driver_flags(capsys):
    common = ["--device", "cpu", "--clients", "16", "--k", "4", "--rounds", "2",
              "--data-scale", "0.02", "--local-epochs", "1"]
    args = fl_async.parse_args(common + ["--topology", "hierarchical", "--tiers",
                                         "4,2", "--heartbeat-timeout", "300"])
    assert topology_args(args) == {"topology": "hierarchical", "topology_kwargs": {
        "tiers": (4, 2), "heartbeat_timeout": 300.0}}
    args = fl_async.parse_args(common + ["--topology", "gossip", "--tiers", "4"])
    assert topology_args(args) == {"topology": "gossip",
                                   "topology_kwargs": {"nodes": 4}}
    for extra, msg in ((["--topology", "gossip", "--tiers", "4,2"], "single"),
                       (["--tiers", "4"], "need --topology"),
                       (["--heartbeat-timeout", "3"], "need --topology")):
        with pytest.raises(SystemExit, match=msg):
            topology_args(fl_async.parse_args(common + extra))
    res = fl_async.main(common + ["--topology", "hierarchical", "--tiers", "4",
                                  "--heartbeat-timeout", "300"])
    assert res.config.topology_name() == "hier[4];hb=300.0s"
    out = capsys.readouterr().out
    assert "/hier[4];hb=300.0s]" in out and "heartbeat churn:" in out
    assert "per-tier X (4 tier-0 nodes):" in out
    res = fl_train.main(common + ["--k", "4", "--topology", "hierarchical",
                                  "--tiers", "4,2"])
    assert len(res.load_stats["tier_var_X"]) == 4
    assert "[markov/hier[4x2]]" in capsys.readouterr().out
