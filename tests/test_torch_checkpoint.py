"""``repro_torch.checkpoint`` against ``repro.checkpoint``: the same format,
so checkpoints cross between the packages; the port's leaves of every
dtype (bf16 and ``torch.Generator`` states included) round-trip bit for
bit; corruption and truncation raise ``ValueError``; and a mid-run armed
engine (faults, re-dispatch, a hierarchical topology and, async, a
heartbeat; or the defense with mtd and collusion) resumes bitwise from its
checkpoint, random streams included. On the card (``cuda`` marker), the
defense's sketch route repeats bitwise (the reference is imported inside
the tests that use it, so the file also runs where JAX is absent):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_checkpoint.py
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs.paper_cnn import MNIST_CNN  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.draws import GeneratorDraws  # noqa: E402
from repro_torch.core.tree import tree_paths  # noqa: E402
from repro_torch.data.synthetic import make_image_dataset  # noqa: E402
from repro_torch.engine import RunConfig, make_engine  # noqa: E402
from repro_torch.engine.registry import make_policy  # noqa: E402
from repro_torch.fl import make_cnn_task  # noqa: E402
from repro_torch.models.cnn import init_params  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

SMALL = dict(name="paper-cnn-mnist-ckpt", image_size=8, conv_channels=(4, 8),
             fc_width=32)
DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int8,
          torch.int16, torch.int32, torch.int64, torch.uint8, torch.bool]


def _same(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), p
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, p
            assert torch.equal(x, y), p


@pytest.mark.parametrize("dtype", DTYPES)
def test_roundtrip_every_dtype(tmp_path, dtype):
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn((3, 5), generator=gen) * 50).to(dtype)
    tree = {"x": x, "nested": {"scalar": x[0, 0].clone(), "list": [x[1], x[2]]},
            "tuple": (x.T.contiguous(),)}
    save_checkpoint(str(tmp_path / "c"), tree, step=7)
    like = {"x": torch.zeros_like(x), "nested": {"scalar": torch.zeros_like(x[0, 0]),
                                                 "list": [x[1], x[2]]},
            "tuple": (torch.zeros_like(x.T),)}
    restored, step = load_checkpoint(str(tmp_path / "c"), like)
    assert step == 7
    assert isinstance(restored["tuple"], tuple) and isinstance(restored["nested"]["list"], list)
    _same(restored, tree)
    with open(tmp_path / "c" / "manifest.json") as f:
        entry = json.load(f)["leaves"][0]
    if dtype == torch.bfloat16:
        assert entry["stored_as"] == "uint16_bf16" and entry["dtype"] == "bfloat16"


def test_generator_states_roundtrip(tmp_path):
    """Every stream of a ``GeneratorDraws`` (sub-streams too) restores, and
    the restored source draws what the original draws next."""
    draws = GeneratorDraws(11, "cpu")
    draws.normal("a", (4,))
    draws.sub("faults").sub("dropout").uniform("hit", (5,))
    draws.sub("redispatch").normal("latency_compute", (3,))
    tree = {"draws": draws.get_state(), "w": torch.arange(4.0)}
    save_checkpoint(str(tmp_path / "g"), tree, step=1)
    with open(tmp_path / "g" / "manifest.json") as f:
        leaves = {e["name"]: e for e in json.load(f)["leaves"]}
    assert leaves["draws/faults/dropout"]["generator"] == "cpu"
    assert leaves["draws/faults/dropout"]["dtype"] == "uint8"
    fresh = GeneratorDraws(0, "cpu")
    restored, _ = load_checkpoint(str(tmp_path / "g"), tree)
    fresh.set_state(restored["draws"])
    for src in (draws, fresh):
        src.out = (src.normal("a", (6,)),
                   src.sub("faults").sub("dropout").uniform("hit", (6,)),
                   src.sub("redispatch").normal("latency_compute", (6,)))
    for a, b in zip(draws.out, fresh.out):
        assert torch.equal(a, b)
    assert sorted(fresh.get_state()) == sorted(draws.get_state())
    with pytest.raises(ValueError, match="generator"):
        load_checkpoint(str(tmp_path / "g"), {"draws": {"": torch.Generator()},
                                              "w": torch.Generator()})


def test_detects_corruption_and_truncation(tmp_path):
    tree = {"w": torch.arange(100.0)}
    d = str(tmp_path / "c")
    save_checkpoint(d, tree, step=1)
    with open(tmp_path / "c" / "manifest.json") as f:
        fname = json.load(f)["shards"][0]["file"]
    shard = tmp_path / "c" / fname
    blob = bytearray(shard.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    shard.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="corrupted"):
        load_checkpoint(d, tree)
    save_checkpoint(d, tree, step=1)
    shard.write_bytes(shard.read_bytes()[: len(blob) // 3])
    with pytest.raises(ValueError, match="corrupt"):
        load_checkpoint(d, tree)
    # a shard rewritten after the manifest (the hash no longer checks):
    # truncated with its manifest entry rehashed is unreadable, not garbage
    from repro_torch.checkpoint.store import _sha256

    with open(tmp_path / "c" / "manifest.json") as f:
        manifest = json.load(f)
    manifest["shards"][0]["sha256"] = _sha256(str(shard))
    with open(tmp_path / "c" / "manifest.json", "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="unreadable"):
        load_checkpoint(d, tree)


def _reference():
    """``(jax, jax.numpy, repro.checkpoint)``, imported inside the tests that
    use them, so the file's ``cuda`` tests also run where JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import checkpoint

    return jax, jnp, checkpoint


def _ref_params():
    jax, _, _ = _reference()
    from repro.configs.paper_cnn import MNIST_CNN as REF_MNIST
    from repro.models.cnn import init_params as ref_init_params

    return jax.tree.map(np.asarray, ref_init_params(
        jax.random.PRNGKey(0), dataclasses.replace(REF_MNIST, **SMALL)))


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    jax, jnp, ref = _reference()
    params = params_from_jax(_ref_params(), "cpu")
    tree = {"params": params, "half": params["fc2"]["w"].to(torch.bfloat16),
            "ages": torch.arange(6, dtype=torch.int32)}
    save_checkpoint(str(tmp_path / "p"), tree, step=4)
    like = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), {torch.bfloat16: jnp.bfloat16}.get(t.dtype, np.dtype(
            str(t.dtype).removeprefix("torch.")))), tree)
    restored, step = ref.load_checkpoint(str(tmp_path / "p"), like)
    assert step == 4
    for (p, got), (_, exp) in zip(tree_paths(jax.tree.map(np.asarray, restored)),
                                  tree_paths(params_to_jax(tree))):
        assert got.dtype == exp.dtype and got.tobytes() == exp.tobytes(), p


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    jax, jnp, ref = _reference()
    params = _ref_params()
    tree = {"params": params, "half": jnp.asarray(params["fc2"]["w"], jnp.bfloat16),
            "ages": jnp.arange(6, dtype=jnp.int32)}
    ref.save_checkpoint(str(tmp_path / "r"), tree, step=9)
    like = {"params": params_from_jax(params, "cpu"),
            "half": torch.zeros(params["fc2"]["w"].shape, dtype=torch.bfloat16),
            "ages": torch.zeros(6, dtype=torch.int32)}
    restored, step = load_checkpoint(str(tmp_path / "r"), like)
    assert step == 9
    for (p, got), (_, exp) in zip(tree_paths(params_to_jax(restored)),
                                  tree_paths(jax.tree.map(np.asarray, tree))):
        assert got.dtype == exp.dtype and got.tobytes() == exp.tobytes(), p


def test_server_state_checkpoint_roundtrip(tmp_path):
    """The port's ``test_fl_system.py::test_server_state_checkpoint_roundtrip``:
    params and the markov scheduler's state."""
    draws = GeneratorDraws(0, "cpu")
    pol = make_policy("markov", 20, 4, 6)
    state = {"params": init_params(draws, dataclasses.replace(MNIST_CNN, **SMALL)),
             "sched": pol.init(draws, 20)}
    save_checkpoint(str(tmp_path / "ckpt"), state, step=17)
    like = {"params": {k: {kk: torch.empty_like(v) for kk, v in layer.items()}
                       for k, layer in state["params"].items()},
            "sched": {k: torch.empty_like(v) for k, v in state["sched"].items()}}
    restored, step = load_checkpoint(str(tmp_path / "ckpt"), like)
    assert step == 17
    _same(restored, state)


@pytest.fixture(scope="module")
def small_task():
    train, test = make_image_dataset("mnist-ckpt", 10, 8, 1, 120, 60, seed=0,
                                     difficulty=0.8)
    return make_cnn_task(dataclasses.replace(MNIST_CNN, **SMALL), train, test, 16,
                         device="cpu")


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_crash_restart_resumes_bitwise(small_task, tmp_path, mode):
    """Kill a run mid-flight and restart a fresh engine from the
    checkpointed state and random streams: the continuation is bit for bit
    the uninterrupted run, with faults armed and a hierarchical reduction
    (and, async, heartbeat liveness, the re-dispatch timers, the AoI ages,
    the load and per-tier accumulators), as the reference's
    ``tests/test_faults.py::test_crash_restart_resumes_bitwise`` arms it."""
    kw = dict(n_clients=16, k=4, m=4, policy="markov", rounds=6, local_epochs=1,
              batch_size=5, mode=mode, faults=("dropout", "corrupt"), fault_rate=0.5,
              topology="hierarchical", topology_kwargs={"tiers": (4,)})
    if mode == "async":
        kw.update(buffer_size=3, profile="mobile", redispatch_timeout=20.0,
                  topology_kwargs={"tiers": (4,), "heartbeat_timeout": 50.0})
    cfg = RunConfig(**kw)
    engine = make_engine(small_task, cfg)
    full, _ = engine.run_chunk(engine.init(), 0, 6, False)

    crashed = make_engine(small_task, cfg)
    half, _ = crashed.run_chunk(crashed.init(), 0, 3, False)
    tree = {"state": half, "draws": crashed.draws.get_state()}
    save_checkpoint(str(tmp_path / "crash"), tree, step=3)
    restarted = make_engine(small_task, cfg)
    restored, step = load_checkpoint(str(tmp_path / "crash"), tree)
    assert step == 3
    restarted.draws.set_state(restored["draws"])
    resumed, _ = restarted.run_chunk(restored["state"], 3, 3, False)
    _same(full, resumed)
    assert sum(float(f["injected"]) for f in full["faults"].values()) > 0
    assert "tier_acc" in full and ("hb" in full) == (mode == "async")


DEFENSE = dict(defense=True, defense_kwargs={"threshold": 0.3, "mtd": True,
                                             "mtd_window": 2, "mtd_up": 0.05,
                                             "mtd_down": 0.01, "collusion": True,
                                             "clique_min_obs": 2},
               faults=("scale_attack",), fault_rate=1.0,
               fault_kwargs={"scale_attack": {"factor": -3.0, "client_frac": 0.25}})


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_crash_restart_resumes_bitwise_with_defense(small_task, tmp_path, mode):
    """The same crash and restart with the defense armed (mtd and
    collusion): reputations, statuses, sketches, the mtd window counters
    and the ``defense`` sub-stream resume bit for bit. The crash falls
    inside an mtd window, so the restarted engine reads the restored
    window counter once and then reads the level once per closed window."""
    kw = dict(n_clients=16, k=4, m=4, policy="markov", rounds=6, local_epochs=1,
              batch_size=5, mode=mode, **DEFENSE)
    if mode == "async":
        kw.update(buffer_size=3, profile="mobile")
    cfg = RunConfig(**kw)
    engine = make_engine(small_task, cfg)
    full, _ = engine.run_chunk(engine.init(), 0, 6, False)

    crashed = make_engine(small_task, cfg)
    half, _ = crashed.run_chunk(crashed.init(), 0, 3, False)
    tree = {"state": half, "draws": crashed.draws.get_state()}
    assert "defense" in tree["draws"]
    save_checkpoint(str(tmp_path / "crash"), tree, step=3)
    restarted = make_engine(small_task, cfg)
    restored, step = load_checkpoint(str(tmp_path / "crash"), tree)
    restarted.draws.set_state(restored["draws"])
    resumed, _ = restarted.run_chunk(restored["state"], step, 3, False)
    _same(full, resumed)
    assert float(full["defense"]["quarantined"]) > 0
    assert {"sketch", "sk_obs", "level", "win"} <= set(full["defense"])
    # windows close after steps 4 and 6; the restored state is read once
    assert (restarted.defense.restore_reads, restarted.defense.host_reads) == (1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
@pytest.mark.parametrize("b,d_sketch", [(8, 16), (256, 64)])
def test_sketch_route_repeats_bitwise_on_the_card(stacked, b, d_sketch):
    """The collusion sketch's fixed-order bucket sum on the card: two calls
    are bitwise equal (no atomics), and the rows are within f32 rounding
    of the CPU route on the same deltas, at the paper CNN's leaf shapes."""
    from repro_torch.defense.collusion import project_deltas

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    draws = GeneratorDraws(4, "cpu")
    g = init_params(draws, MNIST_CNN)
    gen = torch.Generator().manual_seed(b)
    updated = {k: {n: v[None] + 0.01 * torch.randn((b,) + v.shape, generator=gen)
                   for n, v in layer.items()} for k, layer in g.items()}
    bases = ({k: {n: v[None].expand((b,) + v.shape).contiguous()
                  for n, v in layer.items()} for k, layer in g.items()}
             if stacked else g)

    def to(tree, dev):
        return {k: {n: v.to(dev) for n, v in layer.items()} for k, layer in tree.items()}

    first = project_deltas(to(updated, "cuda"), to(bases, "cuda"), d_sketch)
    again = project_deltas(to(updated, "cuda"), to(bases, "cuda"), d_sketch)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    cpu = project_deltas(updated, bases, d_sketch)
    np.testing.assert_allclose(first.cpu().numpy(), cpu.numpy(), rtol=1e-5, atol=1e-6)
