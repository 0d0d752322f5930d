"""Cohort-parallel execution (``RunConfig.shard_cohort``) in the port
(``tests/test_cohort_engine.py`` mirrored).

Flag-on splits the cohort over the ranks of a gloo world (2 ranks, and 4
for the async policies; spawned once per world): each rank trains and
accumulates its slice, the accumulators merge by the rank-order psum. So
results are **allclose**, not bitwise, to the replicated run: the only
permitted difference is the float order of the cohort sum (D partial sums
instead of one). The tolerance is the reference's documented contract,
``RTOL``/``ATOL``. Selections are exact (every ``(n,)`` draw keeps its
shape and stream), and two runs of one configuration repeat bitwise: no
float reduction across ranks goes through ``all_reduce``.

In one process: ``cohort_sharded_apply``'s rejection of non-additive
aggregators (the reference's message), ``cohort_padding``, the validation
of ``shard_cohort`` (the reference's messages), the sharded eval's
fallbacks, and the zero-dropout case.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import distributed as ref_dist  # noqa: E402
from repro.engine import RunConfig as RefRunConfig  # noqa: E402
from repro.engine import aggregators as ref_aggs  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.engine import AsyncEngine, RunConfig, make_engine, run_engine  # noqa: E402
from repro_torch.engine.aggregators import cohort_sharded_apply, make_fedavg  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.sim import latency as lat_mod  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

N = 16
SMALL = dict(name="paper-cnn-mnist-cohort", image_size=8, conv_channels=(4, 8),
             fc_width=32)
DATA = ("mnist-cohort", 10, 8, 1, 120, 64)
TASK = {"n": N, "data": DATA, "cnn": SMALL}
CFG = dict(n_clients=N, k=4, m=4, policy="markov", rounds=5, local_epochs=1,
           batch_size=5, eval_every=2, mode="async", buffer_size=3,
           profile="mobile")
SYNC = dict(CFG, mode="sync", buffer_size=None, profile="lognormal")
POLICIES = ("markov", "oldest_age", "round_robin")
AGGS = ("fedbuff", "fedavg")
# the documented tolerance contract of shard_cohort=True: reduction order
# across cohort shards differs, nothing else does
RTOL, ATOL = 5e-4, 1e-5


def _case(name, drive="run_engine", base=CFG, **kw):
    return {"name": name, "task": TASK, "drive": drive,
            "cfg": {**base, "mesh_shards": 0, "shard_cohort": True, **kw}}


def _apply_case():
    rng = np.random.default_rng(0)
    g = {"w": rng.normal(size=(3, 4)).astype(np.float32),
         "b": np.zeros((4,), np.float32)}
    B = 8
    stack = lambda: {k: rng.normal(size=(B,) + v.shape).astype(np.float32)  # noqa: E731
                     for k, v in g.items()}
    return {"name": "apply", "op": "cohort_apply", "agg": "fedavg", "g": g,
            "updates": stack(), "bases": stack(),
            "w": np.asarray([1.0, 0.0] * (B // 2), np.float32)}


def _cases(world):
    out = [_case(f"{p}-{a}", policy=p, aggregator=a)
           for p in POLICIES for a in AGGS]
    if world == 2:
        out += [_case(f"sync-{a}", base=SYNC, aggregator=a) for a in AGGS]
        out += [_case("repeat-a", "per_step"), _case("repeat-b", "per_step")]
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{D: {name: (cohort-parallel result, replicated result)}} and the
    ``cohort_apply`` results."""
    out = {}
    for world in (2, 4):
        cases = _cases(world)
        res = ranks.run_cases_on_ranks(
            cases + [ranks.single_case(c) for c in cases] + [_apply_case()],
            world, str(tmp_path_factory.mktemp(f"w{world}")))
        k = len(cases)
        out[world] = {c["name"]: (a, b) for c, a, b in zip(cases, res[:k], res[k:2 * k])}
        out[world]["apply"] = res[-1]
    return out


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            _close(a[key], b[key], f"{path}/{key}")
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=RTOL, atol=ATOL, err_msg=path)


def _check_run(coh, ref):
    np.testing.assert_array_equal(coh["selection"], ref["selection"])
    _close(coh["params"], ref["params"], "params")
    for cr, rr in zip(coh["records"], ref["records"]):
        for key in ("train_loss", "eval_loss", "accuracy"):
            np.testing.assert_allclose(cr[key], rr[key], rtol=RTOL, atol=ATOL,
                                       equal_nan=True, err_msg=key)
    for key, val in ref["load_stats"].items():
        np.testing.assert_allclose(coh["load_stats"][key], val, rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    for key, val in (ref["wall_stats"] or {}).items():
        np.testing.assert_allclose(coh["wall_stats"][key], val, rtol=RTOL, atol=ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("world", (2, 4))
def test_cohort_matches_replicated_async(worlds, world, policy, agg):
    # buffer_size=3 divides neither mesh: the padded slots must never leak
    coh, ref = worlds[world][f"{policy}-{agg}"]
    _check_run(coh, ref)
    assert ref["wall_stats"]["updates_applied"] > 0


@pytest.mark.parametrize("agg", AGGS)
def test_cohort_matches_plain_sync(worlds, agg):
    coh, ref = worlds[2][f"sync-{agg}"]
    _check_run(coh, ref)


def test_cohort_runs_repeat_bitwise(worlds):
    a, _ = worlds[2]["repeat-a"]
    b, _ = worlds[2]["repeat-b"]
    for key in ("send", "loss"):
        assert a[key].tobytes() == b[key].tobytes(), key
    for layer, leaves in a["state"]["params"].items():
        for name, val in leaves.items():
            assert val.tobytes() == b["state"]["params"][layer][name].tobytes()


def test_cohort_eval_is_sharded(worlds):
    coh, ref = worlds[2]["repeat-a"]
    # the 64-example eval prefix divides the mesh: the sharded eval must
    # engage (no silent fallback to the replicated eval)
    assert coh["sharded_eval"] and not ref["sharded_eval"]
    _close(coh["eval"], ref["eval"], "eval")


def test_sharded_eval_fallbacks():
    from repro_torch.configs.paper_cnn import MNIST_CNN
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.engine.sharded import make_sharded_eval
    from repro_torch.fl import make_cnn_task

    train, test = make_image_dataset(*DATA, seed=0, difficulty=0.8)
    task = make_cnn_task(dataclasses.replace(MNIST_CNN, **SMALL), train, test, N,
                         device="cpu")
    mesh = dist.FleetMesh(size=2, rank=0)
    assert make_sharded_eval(task, mesh) is not None
    # no batched-eval interface -> replicated fallback
    assert make_sharded_eval(dataclasses.replace(task, eval_batch_fn=None), mesh) is None
    # eval prefix not divisible by the mesh -> replicated fallback
    ragged = dataclasses.replace(
        task, eval_data={k: v[:3] for k, v in task.eval_data.items()})
    assert make_sharded_eval(ragged, mesh) is None


@pytest.mark.parametrize("world", (2, 4))
def test_cohort_sharded_apply_matches_inline(worlds, world):
    case = _apply_case()
    agg = make_fedavg()
    t = lambda tree: {k: torch.as_tensor(v) for k, v in tree.items()}  # noqa: E731
    inline = agg.finalize(t(case["g"]), agg.accumulate(
        agg.init(t(case["g"])), t(case["updates"]), t(case["bases"]),
        torch.as_tensor(case["w"])))
    _close(worlds[world]["apply"], {k: v.numpy() for k, v in inline.items()})


def test_cohort_sharded_apply_rejects_non_additive():
    with pytest.raises(ValueError) as ref:
        ref_aggs.cohort_sharded_apply(
            dataclasses.replace(ref_aggs.make_fedavg(), additive=False), None, "fleet")
    with pytest.raises(ValueError) as got:
        cohort_sharded_apply(dataclasses.replace(make_fedavg(), additive=False),
                             dist.FleetMesh(size=1, rank=0))
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("kw", [
    dict(shard_cohort=True),  # no mesh at all would be a silent no-op
    dict(mode="sync", buffer_size=None, mesh_shards=2),  # sync needs shard_cohort
    dict(shard_cohort=True, mesh_shards=0, defense=True,
         defense_kwargs={"collusion": True}),
    dict(shard_cohort=True, mesh_shards=0, defense=True,
         defense_kwargs={"detector": "learned"}),
    dict(shard_cohort=True, mesh_shards=0, defense=True,
         defense_kwargs={"mtd": True}),
])
def test_shard_cohort_validation(kw):
    with pytest.raises(ValueError) as ref:
        RefRunConfig(**{**CFG, **kw})
    with pytest.raises(ValueError) as got:
        RunConfig(**{**CFG, **kw})
    assert str(got.value) == str(ref.value)


@pytest.fixture
def world_of_one():
    """A world of one for tests that make an engine with a mesh in this
    process, ended after, so no later test finds a process group."""
    with dist.world_of_one():
        yield


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_cohort_mesh_needs_two_devices(world_of_one, mode):
    from repro_torch.launch.ranks import case_task

    task = case_task(TASK)
    base = CFG if mode == "async" else SYNC
    # engine level: a 1-device mesh is not a cohort mesh
    with pytest.raises(ValueError, match=">= 2 devices"):
        make_engine(task, RunConfig(**{**base, "mesh_shards": 1, "shard_cohort": True}))


def test_cohort_padding():
    for b, d in ((3, 8), (8, 8), (9, 8), (5, 1), (3, 2), (3, 4)):
        assert dist.cohort_padding(b, d) == ref_dist.cohort_padding(b, d)
    assert dist.cohort_padding(3, 8) == 5 and dist.cohort_padding(9, 8) == 7
    with pytest.raises(ValueError, match=">= 1"):
        dist.cohort_padding(3, 0)


@pytest.mark.parametrize("profile_name", ["lognormal", "uniform"])
def test_zero_dropout_skips_draw_unchanged(profile_name):
    """Zero-dropout profiles draw no dropout coin: on fed draws, a run
    whose profile draws a coin that never fires is bitwise the run that
    draws none (the reference holds this on its fold-102 key; here the
    replayed table simply has one more site)."""
    from repro_torch.core.draws import GeneratorDraws, ReplayDraws
    from repro_torch.launch.ranks import case_task

    task = case_task(TASK)
    base = lat_mod.get_profile(profile_name)
    assert base.dropout == 0.0
    never = dataclasses.replace(base, dropout=1e-30)
    rng = np.random.default_rng(1)
    cfg = {**CFG, "rounds": 4, "policy": "round_robin"}
    del cfg["profile"]
    params = task.init(GeneratorDraws(0, "cpu"))
    init = {f"params/{k}": rng.normal(size=tuple(v["w"].shape)).astype(np.float32)
            for k, v in params.items()}
    init["speed"] = rng.normal(size=N).astype(np.float32)
    steps = [{"latency_compute": rng.normal(size=N).astype(np.float32),
              "latency_comm": rng.exponential(size=N).astype(np.float32),
              "local_perm": np.stack([np.stack([rng.permutation(task.examples_per_client)])
                                      for _ in range(3)]),
              "dropout": rng.uniform(0.5, 1.0, size=N).astype(np.float32)}
             for _ in range(4)]
    res = [run_engine(AsyncEngine(task, RunConfig(**cfg, profile=prof),
                                  draws=ReplayDraws(init, steps, "cpu")))
           for prof in (base, never)]
    np.testing.assert_array_equal(res[0].selection, res[1].selection)
    for layer, leaves in res[0].params.items():
        for name, val in leaves.items():
            assert torch.equal(val, res[1].params[layer][name])
    for a, b in zip(res[0].records, res[1].records):
        np.testing.assert_array_equal(a.train_loss, b.train_loss)
