"""The port's fleet-sharded async engine against its one-device engine and
against the reference (``tests/test_sharded_engine.py`` mirrored).

``ShardedAsyncEngine`` over a gloo world of D ranks (D = 2 and 4, spawned
once per world by ``repro_torch.launch.ranks``; each rank runs every case)
must equal ``AsyncEngine`` *bit for bit*: the same send masks, per-step
losses, final state (params, ring, event state, ages, stats, selection
accumulators) and eval, per step and chunked, for markov, oldest_age and
round_robin under fedbuff and fedavg. The one-device runs are made inside
the same ranks, so both sides run with the same CPU thread count (a
float reduction's blocking follows it).

A run replayed from the reference's own draws equals the reference's
``AsyncEngine`` — the reference's sharded == single contract, through the
port: discrete outputs exact, floats within the tolerances of
``test_torch_async_slice.py`` (rtol 1e-4 / atol 1e-5 on params and losses,
rtol 1e-6 on the clock).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_cnn import MNIST_CNN as REF_MNIST  # noqa: E402
from repro.core import load_metric as ref_lm  # noqa: E402
from repro.data.synthetic import make_image_dataset as ref_images  # noqa: E402
from repro.engine import AsyncEngine as RefAsyncEngine  # noqa: E402
from repro.engine import RunConfig as RefRunConfig  # noqa: E402
from repro.engine import run_engine as ref_run_engine  # noqa: E402
from repro.fl import make_cnn_task as ref_make_cnn_task  # noqa: E402
from repro_torch.engine import AsyncEngine, RunConfig, make_engine  # noqa: E402
from repro_torch.engine.sharded import FLEET_STATE_KEYS, ShardedAsyncEngine  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

N = 16
SMALL = dict(name="paper-cnn-mnist-sharded", image_size=8, conv_channels=(4, 8),
             fc_width=32)
DATA = ("mnist-sharded", 10, 8, 1, 120, 60)
TASK = {"n": N, "data": DATA, "cnn": SMALL}
CFG = dict(n_clients=N, k=4, m=4, policy="markov", rounds=5, local_epochs=1,
           batch_size=5, eval_every=2, mode="async", buffer_size=3,
           profile="mobile")
POLICIES = ("markov", "oldest_age", "round_robin")
AGGS = ("fedbuff", "fedavg")
WORLDS = (2, 4)
REPLAY = dict(CFG, profile="lognormal", rounds=5, eval_every=1)


def _case(name, drive="per_step", **kw):
    return {"name": name, "task": TASK, "cfg": {**CFG, "mesh_shards": 0, **kw},
            "drive": drive}


def _cases():
    out = [_case(f"{p}-{a}-{d}", d, policy=p, aggregator=a)
           for p in POLICIES for a in AGGS for d in ("per_step", "chunked")]
    out.append(_case("wall", "run_engine", rounds=6, eval_every=3))
    replay = {**_case("replay", "run_engine"), "cfg": {**REPLAY, "mesh_shards": 0},
              "draws": reference_draws()}
    return out + [replay]


# ---------------------------------------------------------------------------
# the reference's draws of the replayed run
# ---------------------------------------------------------------------------


def reference_draws():
    """Every primitive draw of the reference's calm async run (``REPLAY``,
    the small CNN) under its own key schedule, as
    ``test_torch_async_slice.reference_draws`` takes them: init
    ``split(key, 3)``, the CNN's ``split(k_init, 4)``, the markov policy's
    ``choice``, ``client_speed`` at ``fold_in(k_run, 2**31)``; per step
    ``fold_in(k_run, r)``, its split and fold 101, and ``split(k_local,
    B)`` of the local permutations."""
    from repro.models.cnn import init_params

    cnn = dataclasses.replace(REF_MNIST, **SMALL)
    n, k, m, B, epochs = N, REPLAY["k"], REPLAY["m"], REPLAY["buffer_size"], 1
    examples = DATA[4] // N
    k_init, k_policy, k_run = jax.random.split(jax.random.PRNGKey(0), 3)
    params = jax.eval_shape(lambda kk: init_params(kk, cnn), k_init)
    init = {}
    for name, kk in zip(("conv1", "conv2", "fc1", "fc2"), jax.random.split(k_init, 4)):
        init[f"params/{name}"] = np.asarray(jax.random.normal(kk, params[name]["w"].shape))
    p = ref_lm.optimal_probs(n, k, m).astype(np.float32)
    pi = jnp.asarray(ref_lm.steady_state(p).astype(np.float32))
    init["policy_init"] = np.asarray(jax.random.choice(k_policy, m + 1, shape=(n,), p=pi))
    init["speed"] = np.asarray(
        jax.random.normal(jax.random.fold_in(k_run, 2**31), (n,), jnp.float32))
    steps = []
    for r in range(REPLAY["rounds"]):
        k_sel, k_local = jax.random.split(jax.random.fold_in(k_run, r))
        k_c, k_t = jax.random.split(jax.random.fold_in(k_sel, 101))
        perms = np.stack([
            np.stack([np.asarray(jax.random.permutation(ke, examples))
                      for ke in jax.random.split(kb, epochs)])
            for kb in jax.random.split(k_local, B)])
        steps.append({
            "select": np.asarray(jax.random.uniform(k_sel, (n,))),
            "latency_compute": np.asarray(jax.random.normal(k_c, (n,), jnp.float32)),
            "latency_comm": np.asarray(jax.random.exponential(k_t, (n,), jnp.float32)),
            "local_perm": perms,
        })
    return {"init": init, "steps": steps}


@pytest.fixture(scope="module")
def reference_run():
    train, test = ref_images(*DATA, seed=0, difficulty=0.8)
    task = ref_make_cnn_task(dataclasses.replace(REF_MNIST, **SMALL), train, test, N)
    return ref_run_engine(RefAsyncEngine(task, RefRunConfig(**REPLAY)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{D: {case name: (sharded result, one-device result)}}: one spawned
    group per world runs every case both ways."""
    cases = _cases()
    out = {}
    for world in WORLDS:
        res = ranks.run_cases_on_ranks(
            cases + [ranks.single_case(c) for c in cases], world,
            str(tmp_path_factory.mktemp(f"world{world}")), timeout=600)
        out[world] = {c["name"]: (s, o) for c, s, o in
                      zip(cases, res[:len(cases)], res[len(cases):])}
    return out


def _assert_same_bits(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            _assert_same_bits(a[key], b[key], f"{path}/{key}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_async_bit_for_bit(worlds, world, policy, agg):
    for drive in ("per_step", "chunked"):
        sharded, single = worlds[world][f"{policy}-{agg}-{drive}"]
        for key in ("send", "loss", "state", "eval"):
            _assert_same_bits(sharded[key], single[key], f"{drive}/{key}")
    # the run is not degenerate: clients were selected, versions advanced
    assert sharded["send"].sum() > 0 and int(sharded["state"]["version"]) >= 2


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_wall_stats_match_async(worlds, world):
    sharded, single = worlds[world]["wall"]
    assert sharded["wall_stats"].keys() == single["wall_stats"].keys()
    for key, val in single["wall_stats"].items():
        np.testing.assert_array_equal(sharded["wall_stats"][key], val, err_msg=key)
    assert sharded["load_stats"].keys() == single["load_stats"].keys()
    for key, val in single["load_stats"].items():
        np.testing.assert_array_equal(sharded["load_stats"][key], val, err_msg=key)
    np.testing.assert_array_equal(sharded["selection"], single["selection"])
    _assert_same_bits(sharded["params"], single["params"])


@pytest.mark.parametrize("world", WORLDS)
def test_replayed_sharded_run_matches_reference(worlds, world, reference_run):
    from repro_torch.convert import params_to_jax
    from repro_torch.core.tree import tree_map

    got, single = worlds[world]["replay"]
    _assert_same_bits(got["params"], single["params"])
    ref = reference_run
    np.testing.assert_array_equal(got["selection"], ref.selection)
    got_params = params_to_jax(tree_map(torch.as_tensor, got["params"]))
    for layer, leaves in ref.params.items():
        for name, val in leaves.items():
            np.testing.assert_allclose(got_params[layer][name], np.asarray(val),
                                       rtol=1e-4, atol=1e-5, err_msg=f"{layer}.{name}")
    for key in ("updates_applied", "aggregations", "max_staleness",
                "num_samples_epoch", "num_samples_wall"):
        assert got["wall_stats"][key] == ref.wall_stats[key], key
    for key in ("sim_time", "mean_X_epoch", "mean_staleness"):
        np.testing.assert_allclose(got["wall_stats"][key], ref.wall_stats[key],
                                   rtol=1e-5, err_msg=key)
    for a, b in zip(got["records"], ref.records):
        assert (a["round"], a["version"], a["buffer_fill"]) == (
            b.round, b.version, b.buffer_fill)
        np.testing.assert_allclose(a["clock"], b.clock, rtol=1e-6)
        np.testing.assert_allclose(a["train_loss"], b.train_loss, rtol=1e-4,
                                   equal_nan=True)
    assert ref.wall_stats["aggregations"] >= 3


@pytest.mark.parametrize("world", WORLDS)
def test_fleet_state_is_actually_sharded(worlds, world):
    sharded, single = worlds[world]["markov-fedbuff-per_step"]

    def fleet_bytes(state):
        return sum(np.asarray(leaf).nbytes for key in FLEET_STATE_KEYS
                   if key in state for leaf in _leaves(state[key])
                   if np.ndim(leaf) >= 1 and np.shape(leaf)[0] == N)

    whole = fleet_bytes(single["state"])
    assert whole > 0
    # every fleet leaf is a block: exactly 1/D of the one-device bytes
    assert sharded["fleet_bytes"] * world == whole
    # params and the ring stay whole on every rank
    assert sharded["state_bytes"] - sharded["fleet_bytes"] == (
        sum(np.asarray(x).nbytes for x in _leaves(single["state"])) - whole)
    # the engine's task keeps this rank's block of the client data
    assert sharded["client_rows"] == {"x": N // world, "y": N // world}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.fixture(scope="module")
def small_task():
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.configs.paper_cnn import MNIST_CNN
    from repro_torch.fl import make_cnn_task

    train, test = make_image_dataset(*DATA, seed=0, difficulty=0.8)
    return make_cnn_task(dataclasses.replace(MNIST_CNN, **SMALL), train, test, N,
                         device="cpu")


@pytest.fixture
def world_of_one():
    """A test that makes a sharded engine in this process gets a world of
    one; it is taken down after, so no later test finds a process group."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_make_engine_routes_mesh_shards(small_task, world_of_one):
    # no process group with one device: make_engine makes a world of one
    eng = make_engine(small_task, RunConfig(**CFG, mesh_shards=0))
    assert isinstance(eng, ShardedAsyncEngine)
    assert eng.mesh_shards == 1 and torch.distributed.get_world_size() == 1
    assert isinstance(make_engine(small_task, RunConfig(**CFG, mesh_shards=1)),
                      ShardedAsyncEngine)
    plain = make_engine(small_task, RunConfig(**CFG))
    assert type(plain) is AsyncEngine
    # a world of one is the one-device engine bit for bit
    s1, a1 = eng.run_chunk(eng.init(), 0, 3, True)
    s2, a2 = plain.run_chunk(plain.init(), 0, 3, True)
    assert torch.equal(a1["send"], a2["send"])
    for key in ("conv1", "fc2"):
        assert torch.equal(s1["params"][key]["w"], s2["params"][key]["w"])
    assert "/x1] step" in eng.progress_line(
        eng.record(0, {k: v[-1] for k, v in a1.items()}, eng.evaluate(s1)), 0.0)
    # more shards than ranks: the reference's first clause, then the port's
    # way to get D ranks
    with pytest.raises(ValueError, match="^requested 2 fleet shards but only 1 "
                                         "devices are available"):
        make_engine(small_task, RunConfig(**CFG, mesh_shards=2))


@pytest.mark.parametrize("kw", [
    dict(mode="sync", mesh_shards=2),  # needs async or shard_cohort
    dict(mesh_shards=3),  # 16 % 3 != 0
    dict(mesh_shards=-1),
    dict(shard_cohort=True),  # a cohort mesh needs mesh_shards
])
def test_mesh_shards_config_validation(kw):
    base = {k: v for k, v in CFG.items() if not (kw.get("mode") == "sync"
                                                  and k in ("buffer_size",))}
    with pytest.raises(ValueError) as ref:
        RefRunConfig(**{**base, **kw})
    with pytest.raises(ValueError) as got:
        RunConfig(**{**base, **kw})
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("driver", ["fl_async", "fl_train"])
def test_drivers_spawn_ranks_on_cpu(driver):
    """``--mesh-shards 2`` with no process group: the driver starts two gloo
    ranks and returns rank 0's result. The async fleet run selects as the
    one-device run does and trains to the same params (allclose: the
    ranks run fewer CPU threads, and a float reduction's blocking follows
    the thread count); the sync run is cohort-parallel (allclose)."""
    import importlib

    mod = importlib.import_module(f"repro_torch.launch.{driver}")
    argv = ["--device", "cpu", "--clients", "16", "--k", "4", "--rounds", "2",
            "--data-scale", "0.02", "--local-epochs", "1"]
    extra = ["--mesh-shards", "2"] + (["--shard-cohort"] if driver == "fl_train" else [])
    sharded = mod.main(argv + extra)
    assert not torch.distributed.is_initialized()  # the ranks were separate
    assert sharded.config.mesh_shards == 2
    plain = mod.main(argv)
    np.testing.assert_array_equal(sharded.selection, plain.selection)
    for layer, leaves in plain.params.items():
        for name, val in leaves.items():
            np.testing.assert_allclose(sharded.params[layer][name].numpy(), val.numpy(),
                                       rtol=5e-4, atol=1e-5, err_msg=f"{layer}.{name}")


def test_driver_rejects_more_shards_than_gpus(monkeypatch):
    from repro_torch.launch import fl_async

    # a card with one GPU: two shards would need two
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 GPU"):
        fl_async.main(["--device", "cuda", "--clients", "16", "--k", "4",
                       "--rounds", "1", "--mesh-shards", "2"])
