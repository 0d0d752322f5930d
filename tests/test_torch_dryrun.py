"""The port's dry-run (``repro_torch.launch.dryrun``): one rank's step on the
meta device under a dry mesh (``launch.mesh.make_dry_mesh``), counted by
``roofline.op_cost``.

The dry-run half of ``tests/test_sharding_dryrun.py``: that file's
``test_sharded_train_step_16_devices`` is red on the reference (it fails in
every run of the suite: ROADMAP.md's queue 3), and its sharded-step contract is
held live by ``tests/test_torch_tp.py``; here a reduced jamba's train step
on an abstract 4 x 4 mesh runs on meta and moves bytes in all three
collective kinds, and a reduced dense model's FLOPs equal a count of its
GEMMs written from its shapes. Then full-size pairs at the production
meshes: tinyllama-1.1b's train step (K4 2 x 22 forward, 22 backward),
decode (K5 once a layer), mamba2-370m's prefill (K6 48), a multi-pod pair,
and the CLI. The collectives of the reduced families' live runs on gloo
ranks against their dry runs are in ``tests/test_torch_tp.py``.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import INPUT_SHAPES, get_arch  # noqa: E402
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.kernels import flash_decode as k5  # noqa: E402
from repro_torch.kernels import ssd_scan as k6  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_dry_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import factory, pshard  # noqa: E402
from repro_torch.roofline import collective_bytes  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401


def _small(shape_name, seq_len, batch):
    return dataclasses.replace(INPUT_SHAPES[shape_name], seq_len=seq_len, global_batch=batch)


def test_reduced_jamba_train_step_moves_every_collective_kind():
    """``test_sharding_dryrun.py::test_sharded_train_step_16_devices``'s
    configuration (red on the reference): jamba reduced to d_model 256 and
    vocab 512, ``train_4k`` cut to seq 128 and batch 8, a 4 x 4 mesh."""
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b").reduced(), d_model=256,
                              vocab_size=512)
    mesh = make_dry_mesh({"data": 4, "model": 4}, 0)
    fn, args = dryrun.step_fn(factory.build(cfg), cfg, _small("train_4k", 128, 8), mesh)
    cost = dryrun.analyze_step(fn, args, mesh)
    coll = collective_bytes(cost["collectives"])
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0 and coll["all-reduce"] > 0
    new_params, metrics = cost["out"]
    assert metrics["total_loss"].is_meta and metrics["total_loss"].shape == ()
    assert cost["kernels"]["ssd_scan_bwd"]["launches"] >= 1  # its mamba layer's scan


def test_flops_equal_a_hand_count_of_a_reduced_dense_models_gemms():
    """A 2-layer dense model (d 256, 8 query heads over 4 kv heads of 64,
    d_ff 512, vocab 512, untied) trained without remat on data 4 x model 4:
    each rank's 2 rows of 128 tokens through its 2 of 8 query heads, 1 of 4
    kv heads, 128 of 512 ffn units and 128 of 512 vocab rows; a training
    step is three times the forward's GEMMs (forward, the input's and the
    weights' gradients). Attention is K4's (counted as the kernel's)."""
    base = get_arch("llama3-8b").reduced()
    attn = dataclasses.replace(base.pattern[0].attn, num_heads=8, num_kv_heads=4)
    cfg = dataclasses.replace(base, pattern=tuple(dataclasses.replace(lay, attn=attn)
                                                  for lay in base.pattern))
    d, D, ff, V, L = cfg.d_model, attn.head_dim, cfg.pattern[0].mlp.d_ff, cfg.vocab_size, 2
    assert (d, D, ff, V, cfg.num_layers, cfg.tie_embeddings) == (256, 64, 512, 512, L, False)
    tp, dp, B, S = 4, 4, 8, 128
    T = B // dp * S  # the rank's tokens
    layer = (2 * T * d * (8 // tp * D)  # q
             + 2 * 2 * T * d * (4 // tp * D)  # k, v
             + 2 * T * (8 // tp * D) * d  # o
             + 3 * 2 * T * d * (ff // tp))  # gate, up, down
    head = 2 * T * d * (V // tp)  # the rank's vocab rows of the logits
    mesh = make_dry_mesh({"data": dp, "model": tp}, 0)
    fn, args = dryrun.step_fn(factory.build(cfg, remat=False), cfg, _small("train_4k", S, B),
                              mesh)
    cost = dryrun.analyze_step(fn, args, mesh)
    assert cost["flops"] == 3 * (L * layer + head)
    fwd, bwd = (k4.cost(B // dp, 4 // tp, 2, S, D, torch.float32, backward=b) for b in (0, 1))
    fwd_lse = k4.cost(B // dp, 1, 2, S, D, torch.float32, with_lse=True)
    assert cost["kernels"] == {
        "flash_attention": {"launches": L, "flops": L * fwd[0], "bytes": L * fwd_lse[2],
                            "read_bytes": L * fwd_lse[1]},
        "flash_attention_bwd": {"launches": L, "flops": L * bwd[0], "bytes": L * bwd[2],
                                "read_bytes": L * bwd[1]}}


def test_tinyllama_train_4k_at_16x16_runs_k4_both_ways_on_meta():
    f0, b0, m0, mb0 = k4.launches, k4.bwd_launches, k4.meta_launches, k4.meta_bwd_launches
    r = dryrun.lower_pair("tinyllama-1.1b", "train_4k", multi_pod=False)
    assert r["status"] == "ok" and r["mesh"] == "16x16"
    kern = r["kernels"]["by_name"]
    assert kern["flash_attention"]["launches"] == 2 * 22  # remat: the recompute's too
    assert kern["flash_attention_bwd"]["launches"] == 22
    assert (k4.meta_launches - m0, k4.meta_bwd_launches - mb0) == (44, 22)
    assert (k4.launches, k4.bwd_launches) == (f0, b0)  # nothing launched
    assert r["kernels"]["plain_routes"] == {}
    # bytes written, the kernels' and the ops' alike; the kernels' reads beside
    assert r["bytes_convention"] == dryrun.BYTES_CONVENTION
    assert r["kernel_read_bytes"] == sum(k["read_bytes"] for k in kern.values()) > 0
    rf = r["roofline"]
    assert rf["collective_bytes_total"] == sum(r["collectives"].values()) > 0
    assert rf["compute_s"] > 0 and rf["memory_s"] > 0 and rf["dominant"] in rf
    assert 0 < r["useful_flops_ratio"] < 1
    assert 0 < r["memory"]["peak_share_of_hbm"] < 1
    assert r["params_total"] == get_arch("tinyllama-1.1b").param_count()


def test_decode_runs_k5_once_an_attention_layer_whatever_the_cache_layout():
    """tinyllama's 4 kv heads do not split over model 16: ``cache_pspecs``
    lays the ring's L over ``model``, and the decode step gathers each
    layer's blocks at use; K5 runs once a layer on the whole ring."""
    from repro_torch import sharding
    from repro_torch.models import transformer

    cfg, shape = get_arch("tinyllama-1.1b"), INPUT_SHAPES["decode_32k"]
    caches = transformer.init_decode_caches(cfg, shape.global_batch, shape.seq_len, "meta")
    spec = sharding.cache_pspecs(caches, make_production_mesh())
    assert "model" in tuple(spec["blocks"][0]["k"])
    m0 = k5.meta_launches
    r = dryrun.lower_pair("tinyllama-1.1b", "decode_32k", multi_pod=False)
    assert r["status"] == "ok"
    assert r["kernels"]["by_name"]["flash_decode"]["launches"] == 22 == k5.meta_launches - m0
    assert r["collectives"]["all-gather"] > 0


def test_mamba2_prefill_32k_runs_k6_48_times():
    r = dryrun.lower_pair("mamba2-370m", "prefill_32k", multi_pod=False)
    assert r["status"] == "ok"
    assert r["kernels"]["by_name"]["ssd_scan"]["launches"] == 48
    assert "ssd_scan_bwd" not in r["kernels"]["by_name"]


def test_a_multi_pod_pair_takes_the_pod_and_data_axes_by_their_product():
    mesh = make_production_mesh(multi_pod=True, rank=0)
    assert mesh.dry and mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.axis_size(("pod", "data")) == 32 and mesh.index(("pod", "data")) == 0
    with pytest.raises(ValueError, match="a dry mesh has no process groups"):
        mesh.group("model")
    sp = dryrun.lower_pair("tinyllama-1.1b", "prefill_32k", multi_pod=False)
    mp = dryrun.lower_pair("tinyllama-1.1b", "prefill_32k", multi_pod=True)
    assert mp["status"] == "ok" and mp["mesh"] == "2x16x16"
    # 32 sequences over 32 data ranks: one a rank, half the single pod's work
    assert mp["flops_per_device"] < sp["flops_per_device"]
    assert mp["kernels"]["by_name"]["flash_attention"]["launches"] == 22


def test_a_dry_mesh_never_turns_a_collective_into_a_no_op():
    mesh = make_dry_mesh({"data": 2, "model": 4}, 5)
    assert mesh.coords == {"data": 1, "model": 1}
    with pshard.mesh_context(mesh):
        before = pshard.counts()
        parts = pshard.gather_parts(torch.empty((3, 8), device="meta"), "model")
        assert len(parts) == 4 and all(p.is_meta and p.shape == (3, 8) for p in parts)
        assert pshard.index("model") == 1 and pshard.index("data") == 1
        with pytest.raises(ValueError, match="a dry mesh runs on meta tensors"):
            pshard.psum(torch.ones(4), "model")
    got = pshard.counts()["all_gather"]["calls"] - before.get("all_gather", {}).get("calls", 0)
    assert got == 1
    # an abstract mesh is not a dry one: it has no ranks
    with pytest.raises(ValueError, match="an abstract mesh has no ranks"):
        Mesh({"data": 2, "model": 4}).index("model")
    with pytest.raises(ValueError, match="rank 8 is not on a mesh of 8"):
        make_dry_mesh({"data": 2, "model": 4}, 8)


def test_the_cli_writes_a_json_a_pair_and_the_done_line(tmp_path, capsys):
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--both-meshes",
                 "--tags", "t", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "=== tinyllama-1.1b.decode_32k.sp.t ===" in out
    assert out.strip().splitlines()[-1] == "DONE ok=2 skipped=0 errors=0"
    for mesh, tag in (("16x16", "sp"), ("2x16x16", "mp")):
        r = json.loads((tmp_path / f"dryrun_tinyllama-1.1b.decode_32k.{tag}.t.json").read_text())
        assert r["mesh"] == mesh and r["tags"] == "t" and r["status"] == "ok"
        for key in ("arch", "shape", "flops_per_device", "bytes_per_device", "collectives",
                    "roofline", "model_flops_global", "useful_flops_ratio", "params_total",
                    "params_active", "trace_s", "memory", "kernels"):
            assert key in r, key
        assert set(r["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter",
                                         "all-to-all", "collective-permute"}
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "long_500k", "--out", str(tmp_path)])
    assert capsys.readouterr().out.strip().splitlines()[-1] == "DONE ok=0 skipped=1 errors=0"
    with pytest.raises(SystemExit) as err:
        dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k", "--out", str(tmp_path)])
    assert err.value.code == 1
    assert capsys.readouterr().out.strip().splitlines()[-1] == "DONE ok=0 skipped=0 errors=1"
    r = json.loads((tmp_path / "dryrun_no-such-arch.train_4k.sp.json").read_text())
    assert r["status"] == "error" and r["error"].startswith("KeyError")
