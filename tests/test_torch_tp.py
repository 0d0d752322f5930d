"""The sharded LM step (``repro_torch.models.pshard``, ``sharding.py``) on
gloo worlds of CPU ranks, against the port's one-device model and the
reference's single-device functions, in f32.

Reduced configs of tinyllama (kv heads repeated to MHA: one kv head),
gemma3 (heads sharded at model 2, repeated at model 4), deepseek-v2 (MLA,
MoE with a shared expert), jamba (mamba heads, MoE), mamba2 and whisper,
and a six-head variant of tinyllama (context-parallel queries at model 4);
params from the port's ``init`` (``convert`` takes them to the reference),
inputs drawn with numpy. Each world is spawned once (``launch.tp_cases.run_cases_on_ranks``,
one CPU thread a rank): 2 ranks (model 2), 4 ranks (model 4, and data 2 x
model 2). Per case: loss and ``moe_aux``, every gradient leaf (gathered),
the params after one ``sgd_train_step``, prefill logits and every cache
leaf, 8 decode steps' logits and the caches after them.

Tolerance: 1e-5 of each leaf's max magnitude. whisper's decoder gradients
are held at 5e-5: the one-device port's own f32 gradient of the cross
attention's ``w_k`` is 1.2e-5 of its max away from the same step in f64
(the sum over 64 frames cancels), so a reordered sum cannot hold 1e-5.

Also: a world of one is the unsharded model bit for bit; two runs of a
sharded case repeat bit for bit; decode on weights gathered whole over
data once matches; ``explicit_tp`` halves the MLP's counted
collective bytes in bf16; ``shard_tree`` then ``unshard_tree`` is the
identity on live ranks; six heads at model 4 over positions that do not
split (the context route pads its rows) match. K4 and K5 at ``tp_main``'s
rank-local shapes on the card: ``tests/test_torch_tp_kernels.py`` (no JAX
there).

The dry-run (``launch.dryrun``, slice I2): each sharded case run again on
the meta device under a dry mesh of its shape (``launch.mesh.make_dry_mesh``,
no ranks, no process groups) counts the collectives, by kind, calls and
bytes, that the live rank 0 counted, exactly; other coordinates count the
same. It spawns no world of its own: it reads the live runs' counts.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as ref_configs  # noqa: E402
from repro.models import factory as ref_factory  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core.tree import tree_paths  # noqa: E402
from repro_torch.launch import tp_cases  # noqa: E402
from repro_torch.models import attention, factory  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401


FAMILIES = ["tinyllama-1.1b", "gemma3-27b", "deepseek-v2-236b", "jamba-v0.1-52b",
            "mamba2-370m", "whisper-tiny", "six-heads"]
MESHES = {"model2": (2, {"data": 1, "model": 2}), "model4": (4, {"data": 1, "model": 4}),
          "data2xmodel2": (4, {"data": 2, "model": 2})}
B, S_LOSS, S_PREFILL, DECODE_STEPS, LR = 2, 128, 32, 8, 0.1
TOL = 1e-5
LOOSE = {"whisper-tiny": {"grads": 5e-5, "new_params": 5e-5}}
# build flags on model 2, each against the one-device port (whose values the
# flags do not change): the residual split over the sequence, the split
# checkpoint, the MLP's explicit bf16 sum (f32 here)
FLAG_CASES = [("tinyllama-1.1b", "seq_parallel"), ("deepseek-v2-236b", "seq_parallel"),
              ("jamba-v0.1-52b", "remat_save_outputs"), ("gemma3-27b", "explicit_tp")]
KEYS = ("loss", "moe_aux", "grads", "new_params", "prefill_logits", "caches",
        "decode_logits", "decode_caches")


def _six(pkg):
    """tinyllama reduced with 6 query heads over 2 kv heads: heads sharded at
    model 2, context-parallel queries at model 4."""
    base = pkg.get_arch("tinyllama-1.1b").reduced()
    a = dataclasses.replace(base.pattern[0].attn, num_heads=6, num_kv_heads=2)
    return dataclasses.replace(base, name="six-heads", pattern=tuple(
        dataclasses.replace(layer, attn=a) for layer in base.pattern))


def _cfg(pkg, name):
    return _six(pkg) if name == "six-heads" else pkg.get_arch(name).reduced()


def _inputs(cfg, S, seed):
    rng = np.random.default_rng(seed)
    ft = cfg.frontend_tokens if cfg.frontend != "none" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S - ft)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder.source_len, cfg.d_model)).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _case(name):
    """Family ``name``'s case: the port's params from seed 0 and numpy inputs."""
    cfg_r, cfg = _cfg(ref_configs, name), _cfg(configs, name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_r)
    params = factory.build(cfg).init(torch.Generator().manual_seed(0))
    pre = _inputs(cfg, S_PREFILL, 2)
    pre.pop("labels")
    dec = np.random.default_rng(3).integers(0, cfg.vocab_size, (DECODE_STEPS, B, 1))
    case = {"name": name, "cfg": cfg, "params": params, "batch": _t(_inputs(cfg, S_LOSS, 1)),
            "prefill": _t(pre), "decode": torch.from_numpy(dec.astype(np.int32)), "lr": LR}
    if cfg.encoder is not None:
        case["prefill"]["seq_len"] = S_PREFILL + DECODE_STEPS
    return case


def _reference(name, case):
    """The reference's loss, ``moe_aux``, gradients, prefill logits and decode
    logits on the case's params (converted) and inputs."""
    mr = ref_factory.build(_cfg(ref_configs, name))
    pr = jax.tree.map(jnp.asarray, convert.lm_params_to_jax(case["params"]))
    batch = {k: jnp.asarray(v.numpy()) for k, v in case["batch"].items()}
    (_, met), g = jax.jit(jax.value_and_grad(mr.loss, has_aux=True))(pr, batch)
    ref = {"loss": torch.tensor(float(met["loss"])),
           "moe_aux": torch.tensor(float(met["moe_aux"])),
           "grads": convert.lm_params_from_jax(jax.tree.map(np.asarray, g), "cpu")}
    rb = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
          for k, v in case["prefill"].items()}
    if "seq_len" in rb:
        lg, c = mr.prefill(pr, rb)
    else:
        lg, c = jax.jit(mr.prefill)(pr, rb)
    ref["prefill_logits"] = torch.from_numpy(np.array(lg))
    step = jax.jit(mr.decode_step)
    ref["decode_logits"] = []
    for tok in case["decode"]:
        lg, c = step(pr, c, jnp.asarray(tok.numpy()))
        ref["decode_logits"].append(torch.from_numpy(np.array(lg)))
    return ref


@contextlib.contextmanager
def _one_thread():
    """One CPU thread, as the ranks run: the CPU's embedding backward adds a
    repeated token's rows in an order that follows the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds spawned at once, in threads, while this process runs the
    reference and the one-device port."""
    import threading

    cases = {name: _case(name) for name in FAMILIES}
    cases["softcap"] = dict(cases["gemma3-27b"], name="softcap", cfg=dataclasses.replace(
        cases["gemma3-27b"]["cfg"], logits_softcap=30.0))
    six = cases["six-heads"]  # 126 and 30 positions: the context route's rows padded
    pre = _inputs(six["cfg"], S_PREFILL - 2, 2)
    pre.pop("labels")
    cases["six-odd"] = dict(six, name="six-odd", batch=_t(_inputs(six["cfg"], S_LOSS - 2, 1)),
                            prefill=_t(pre))
    one_row = cases["tinyllama-1.1b"]  # batch 1: the cache's L over data, gathered at use
    cases["batch1"] = dict(one_row, name="batch1", train=False,
                           prefill={"tokens": one_row["prefill"]["tokens"][:1],
                                    "global_batch": 1},
                           decode=one_row["decode"][:, :1])
    tmp = str(tmp_path_factory.mktemp("tp"))
    mlp_case = {"op": "mlp_counts", "d_model": 256, "d_ff": 512, "B": 2, "S": 64,
                "dtype": torch.bfloat16}
    todo, got, errors = {}, {}, []
    for world in (2, 4):
        meshes = [m for m, (w, _) in MESHES.items() if w == world]
        todo[world] = [dict(cases[n], mesh=MESHES[m][1], name=f"{m}/{n}")
                       for m in meshes for n in FAMILIES]
        if world == 4:  # the same case again: two runs repeat bitwise
            todo[world].append(dict(cases["deepseek-v2-236b"],
                                    mesh=MESHES["data2xmodel2"][1], name="repeat"))
            todo[world].append(dict(cases["jamba-v0.1-52b"], mesh=MESHES["data2xmodel2"][1],
                                    name="whole_decode", whole_decode=True))
            todo[world].append(dict(cases["batch1"], mesh=MESHES["data2xmodel2"][1],
                                    name="batch1"))
            todo[world].append(dict(cases["six-heads"], mesh=MESHES["model4"][1],
                                    name="flags/six-heads-seq", build={"seq_parallel": True}))
            todo[world].append(dict(cases["six-odd"], mesh=MESHES["model4"][1],
                                    name="six-odd"))
        else:
            todo[world].append(mlp_case)
            todo[world] += [dict(cases[n], mesh=MESHES["model2"][1], name=f"flags/{n}-{k}",
                                 build={k: True}) for n, k in FLAG_CASES]
            todo[world].append(dict(cases["softcap"], mesh=MESHES["model2"][1],
                                    name="flags/softcap"))

    def spawn(world):
        try:
            got[world] = tp_cases.run_cases_on_ranks(todo[world], world, tmp, timeout=600)
        except BaseException as e:  # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=spawn, args=(w,)) for w in (2, 4)]
    for t in threads:
        t.start()
    try:
        refs = {name: _reference(name, cases[name]) for name in FAMILIES}
        with _one_thread():
            one = {name: tp_cases.run_case(cases[name], sharded=False)
                   for name in FAMILIES + ["softcap", "batch1", "six-odd"]}
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    sharded = {c.get("name", "mlp_counts"): r
               for w in (2, 4) for c, r in zip(todo[w], got[w])}
    live = {c["name"]: c for w in (2, 4) for c in todo[w] if "name" in c}
    return {"cases": cases, "refs": refs, "one": one, "sharded": sharded, "live": live}


def _check(got, want, name, what):
    for key in ("loss", "moe_aux", "grads", "new_params", "prefill_logits", "caches",
                "decode_logits", "decode_caches"):
        if key not in want:
            continue
        tol = LOOSE.get(name, {}).get(key, TOL)
        gaps = tp_cases.leaf_gaps(got[key], want[key])
        bad = {k: v for k, v in gaps.items() if not v <= tol}
        assert not bad, (what, key, tol, bad)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_step_matches_the_one_device_port(runs, name, mesh):
    got = runs["sharded"][f"{mesh}/{name}"]
    _check(got, runs["one"][name], name, "port")
    assert got["roundtrip"]
    assert got["counts_train"], "a sharded step with no collective"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_step_matches_the_reference(runs, name, mesh):
    _check(runs["sharded"][f"{mesh}/{name}"], runs["refs"][name], name, "reference")


@pytest.mark.parametrize("name", FAMILIES)
def test_a_world_of_one_is_the_unsharded_model_bitwise(runs, name):
    from repro_torch.core.distributed import world_of_one

    with world_of_one("cpu"), _one_thread():
        got = tp_cases.run_case(dict(runs["cases"][name], mesh={"data": 1, "model": 1}),
                                sharded=True)
    want = runs["one"][name]
    for key in KEYS:
        for (path, a), (_, b) in zip(tree_paths(got[key]), tree_paths(want[key])):
            assert torch.equal(a, b), (key, path)
    assert got["counts"] == {}


@pytest.mark.parametrize("name", [f"{n}-{k}" for n, k in FLAG_CASES]
                         + ["six-heads-seq", "softcap"])
def test_build_flags_and_soft_cap_match_the_one_device_port(runs, name):
    """``seq_parallel`` (the six-head case: context-parallel queries on the
    rank's rows at model 4), ``remat_save_outputs``, ``explicit_tp``, and
    gemma3 with a logit soft cap of 30 (the vocab-parallel cross entropy's
    tanh), each on its one-device counterpart."""
    fam = next(n for n in FAMILIES + ["softcap"] if name.startswith(n))
    got = runs["sharded"][f"flags/{name}"]
    _check(got, runs["one"][fam], fam, "port")
    assert got["counts_train"]


def test_decode_on_weights_whole_over_data_matches(runs):
    """jamba's decode steps on weights gathered whole over the data axis once
    (``pshard.whole_over``, a serving replica's layout) against the one-
    device port."""
    _check(runs["sharded"]["whole_decode"], runs["one"]["jamba-v0.1-52b"], "jamba", "port")


def test_a_batch_the_data_axis_does_not_split_decodes_from_l_sharded_caches(runs):
    """tinyllama at batch 1 on data 2 x model 2: ``cache_pspecs`` puts each
    ring's L over ``data`` (a rank holds half of each row's keys); the
    prefill's caches in that layout and 8 decode steps, which gather the L
    blocks at use, against the one-device port."""
    from repro_torch import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer

    abstract = transformer.init_decode_caches(runs["cases"]["batch1"]["cfg"], 1, S_PREFILL,
                                              "meta")
    spec = sharding.cache_pspecs(abstract, Mesh(MESHES["data2xmodel2"][1]))
    assert tuple(spec["blocks"][0]["k"]) == (None, None, "data", None, None)
    _check(runs["sharded"]["batch1"], runs["one"]["batch1"], "batch1", "port")


def test_two_sharded_runs_repeat_bitwise(runs):
    a = runs["sharded"]["repeat"]
    b = runs["sharded"]["data2xmodel2/deepseek-v2-236b"]
    for key in KEYS:
        for (path, x), (_, y) in zip(tree_paths(a[key]), tree_paths(b[key])):
            assert torch.equal(x, y), (key, path)
    assert a["counts"] == b["counts"]


def test_explicit_tp_halves_the_mlps_collective_bytes_in_bf16(runs):
    r = runs["sharded"]["mlp_counts"]
    gspmd, explicit = r["gspmd"]["counts"]["psum"], r["explicit_tp"]["counts"]["psum"]
    payload = 2 * 64 * 256 * 2  # one (B, S, d) bf16 block
    assert explicit == {"calls": 2, "bytes": 2 * 2 * payload}  # forward and backward, D = 2
    assert gspmd == {"calls": 2, "bytes": 2 * explicit["bytes"]}
    for k in ("y", "dx"):  # both paths compute the MLP: bf16 apart
        a, b = r["gspmd"][k].float(), r["explicit_tp"][k].float()
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())


def test_attention_routes_follow_the_reference_strategy():
    six, tiny = _six(configs).pattern[0].attn, configs.get_arch("tinyllama-1.1b")
    assert attention.tp_route(six, 2) == "heads" and attention.tp_route(six, 4) == "context"
    red = configs.get_arch("tinyllama-1.1b").reduced().pattern[0].attn
    assert attention.tp_route(red, 2) == "repeat"
    assert attention.tp_route(tiny.pattern[0].attn, 4) == "heads"
    assert attention.tp_route(tiny.pattern[0].attn, 1) is None
    llama4 = configs.get_arch("llama4-maverick-400b-a17b").pattern[0].attn
    assert attention.tp_route(llama4, 16) == "context"


def test_unsplit_layers_raise_under_a_model_axis():
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe, pshard

    spec = next(layer.mlp.moe for layer in configs.get_arch("deepseek-v2-236b").reduced()
                .all_layers() if layer.mlp.kind == "moe")
    with pshard.mesh_context(Mesh({"data": 1, "model": 8})):
        with pytest.raises(NotImplementedError, match="MoE layer"):
            moe.sharded_dims(spec)
        mla = configs.get_arch("deepseek-v2-236b").reduced().pattern[0].attn
        with pytest.raises(NotImplementedError, match="MLA attention"):
            attention.tp_route(mla, 8)


def test_context_rows_that_do_not_split_over_the_model_axis_are_padded(runs):
    """Six query heads over two kv heads at model 4 take the context route;
    at 126 loss and 30 prefill positions (not multiples of 4) each rank's
    rows are padded to 32 and 8, and the padding is cut after the gather."""
    from repro_torch.models import attention

    six = runs["cases"]["six-odd"]["cfg"].pattern[0].attn
    assert attention.tp_route(six, 4) == "context"
    _check(runs["sharded"]["six-odd"], runs["one"]["six-odd"], "six-heads", "port")


DRY = sorted(f"{m}/{n}" for m in MESHES for n in FAMILIES) + [
    "whole_decode", "batch1", "six-odd", "flags/softcap"] + [
    f"flags/{n}-{k}" for n, k in FLAG_CASES] + ["flags/six-heads-seq"]


@pytest.mark.parametrize("name", DRY)
def test_the_dry_run_counts_the_collectives_the_live_rank_counts(runs, name):
    """The case's calls on the meta device under a dry mesh of its shape, at
    rank 0's coordinates: every collective, by kind, calls and bytes,
    equal to the live rank 0's (its training step with the gathered
    gradients; then the prefill, the decode steps and the gathered
    results)."""
    from repro_torch.launch.mesh import make_dry_mesh

    case = runs["live"][name]
    dry = tp_cases.run_case(case, sharded=True, mesh=make_dry_mesh(case["mesh"], 0))
    live = runs["sharded"][name]
    assert dry.get("counts_train") == live.get("counts_train")
    assert dry["counts"] == live["counts"] and dry["counts"]
    assert all(t.is_meta for t in dry["decode_logits"])


def test_other_coordinates_of_a_dry_mesh_count_the_same():
    """jamba (mamba heads, MoE, FSDP gathers) on data 2 x model 2 from ranks
    1 and 3: the counts of rank 0."""
    from repro_torch.launch.mesh import make_dry_mesh

    case = dict(_case("jamba-v0.1-52b"), mesh=MESHES["data2xmodel2"][1])
    got = [tp_cases.run_case(case, sharded=True, mesh=make_dry_mesh(case["mesh"], r))
           for r in (0, 1, 3)]
    assert [g["counts"] for g in got[1:]] == [got[0]["counts"]] * 2
    assert [g["counts_train"] for g in got[1:]] == [got[0]["counts_train"]] * 2
