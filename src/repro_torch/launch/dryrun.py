"""Dry-run: one rank's step of every (arch x shape x mesh) pair, on the meta
device.

Port of ``repro.launch.dryrun``, with its CLI, tags and artifact keys. The
reference lowers and compiles each pair's step for 512 placeholder host
devices and reads XLA's compiled HLO. The port has no compiler: it builds
the production mesh as one rank's dry view (``launch.mesh.make_production_mesh``
with a rank: coordinates, no process groups), cuts that rank's blocks of the
params, the batch and the caches out of ``factory.abstract_params`` and
``factory.input_specs`` by the sharding rules (``sharding.params_pspecs``,
``batch_pspecs``, ``cache_pspecs``, ``local_shape``), and runs the real
step, the same model code as a live run, on meta tensors under
``pshard.mesh_context``: ``sgd_train_step`` for train, ``prefill`` for
prefill (whisper with its ``seq_len``), ``decode_step`` for decode. Nothing
is allocated and no rank exists. ``roofline.op_cost.analyze`` counts the
step: the FLOPs and bytes of its aten ops, each hand-written kernel's
launches and own work (K4 forward and backward, K5, K6 forward and
backward take their meta routes, which check the shapes the card would
and compute nothing), the collectives as ``models.pshard`` counts them,
and the live bytes. ``roofline.analysis`` turns them into the three-term
roofline over the H100's data-sheet peaks (``roofline.hw``).

One JSON a pair goes to ``artifacts/torch_dryrun/dryrun_<tag>.json`` with
the reference's keys where they mean the same (``arch``, ``shape``,
``mesh``, ``tags``, ``status``, ``flops_per_device``, ``bytes_per_device``,
``collectives``, ``roofline``, ``model_flops_global``,
``useful_flops_ratio``, ``params_total``, ``params_active``).
``bytes_per_device`` is bytes written, as the reference counts HLO's: each
aten op's outputs and each kernel's, so a layer costs the same bytes
whether a kernel or aten ops run it, up to the intermediates the aten ops
write; the kernels' reads stand beside it as ``kernel_read_bytes`` and
``bytes_convention`` says so in the JSON. ``trace_s``
replaces ``lower_s``/``compile_s``, ``memory`` (argument, output and peak
bytes, the peak's share of ``hw.HBM_BYTES``) replaces ``memory_analysis``,
and ``kernels`` (launches, FLOPs and bytes by kernel, and the attention
calls that took a plain route: the masked ``Sq != Sk`` route of a
context-parallel layer, a decode ring whose valid slots are not a prefix,
MLA, the encoder) replaces ``raw_cost_analysis``.

Usage (CPU only, no card, no jax):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch import sharding
from repro_torch.configs import INPUT_SHAPES, all_archs, get_arch, shape_applicable
from repro_torch.core.tree import tree_map
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention, factory, pshard
from repro_torch.roofline import collective_bytes, hw, model_flops, roofline_terms
from repro_torch.roofline import op_cost

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                            "torch_dryrun")
BYTES_CONVENTION = ("written: each aten op's outputs and each kernel's outputs; "
                    "the kernels' inputs are kernel_read_bytes, in no roofline term")
# attention calls that take no kernel: (module function, the route's name)
PLAIN_ROUTES = (("_attend_direct", "direct"), ("_attend_flash_jnp", "blocked"),
                ("_slot_valid", "masked_decode"), ("_attend_unmasked", "unmasked"))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _blocks(tree, specs, mesh):
    """The rank's blocks of a tree of (meta) tensors laid out by ``specs``."""
    return tree_map(lambda t, sp: _meta(sharding.local_shape(t.shape, sp, mesh), t.dtype),
                    tree, specs)


def rank_params(cfg, mesh) -> Dict:
    """The rank's blocks of ``cfg``'s params on the meta device."""
    return _blocks(factory.abstract_params(cfg), factory.param_specs(cfg, mesh), mesh)


def rank_batch(specs: Dict, mesh) -> Dict:
    """The rank's rows of a batch of global meta tensors, as ``batch_pspecs``
    lays them; a batch that the data axes do not split is whole on every
    rank and names its ``global_batch``."""
    tensors = {k: v for k, v in specs.items() if isinstance(v, torch.Tensor)}
    bspecs = sharding.batch_pspecs(tensors, mesh)
    out = {**specs, **_blocks(tensors, bspecs, mesh)}
    rows = next(iter(tensors.values())).shape[0]
    if (bspecs[next(iter(tensors))][0] is None
            and sharding.mesh_axis_size(mesh, sharding.dp_axes(mesh)) > 1):
        out["global_batch"] = rows
    return out


@contextlib.contextmanager
def _plain_route_calls(calls: Dict[str, int]):
    """Count the calls of each attention function that takes no kernel."""
    saved = {}
    for fn, route in PLAIN_ROUTES:
        orig = saved[fn] = getattr(attention, fn)

        def wrapped(*a, _orig=orig, _route=route, **kw):
            calls[_route] = calls.get(_route, 0) + 1
            return _orig(*a, **kw)

        setattr(attention, fn, wrapped)
    try:
        yield
    finally:
        for fn, orig in saved.items():
            setattr(attention, fn, orig)


def step_fn(model, cfg, shape, mesh):
    """(fn, args): one rank's step of ``shape`` on meta blocks, to run under
    ``pshard.mesh_context(mesh)``."""
    specs = factory.input_specs(cfg, shape)
    params = rank_params(cfg, mesh)
    if shape.mode == "train":
        lr = _meta((), torch.float32)
        return model.sgd_train_step, (params, rank_batch(specs, mesh), lr)
    if shape.mode == "prefill":
        batch = rank_batch(specs, mesh)
        if cfg.encoder is not None:
            batch["seq_len"] = shape.seq_len
        return _no_grad(model.prefill), (params, batch)
    with pshard.mesh_context(mesh):
        caches = model.init_decode_caches(shape.global_batch, shape.seq_len, "meta")
    token = rank_batch({"token": specs["token"]}, mesh)["token"]
    return _no_grad(model.decode_step), (params, caches, token)


def _no_grad(fn):
    def run(*args):
        with torch.no_grad():
            return fn(*args)

    return run


def analyze_step(fn, args, mesh) -> Dict:
    """``op_cost.analyze`` of ``fn(*args)`` under the dry mesh, with the
    attention calls that took a plain route."""
    routes: Dict[str, int] = {}
    with pshard.mesh_context(mesh), _plain_route_calls(routes):
        cost = op_cost.analyze(fn, *args)
    cost["plain_routes"] = routes
    return cost


def _collectives(fn, mesh):
    """(fn's result, the collectives it counted) under the dry mesh."""
    before = pshard.counts()
    with pshard.mesh_context(mesh):
        out = fn()
    return out, op_cost.counts_since(before)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def lower_pair(
    arch_name: str,
    shape_name: str,
    multi_pod: bool,
    mla_absorb: bool = True,
    seq_parallel: bool = False,
    explicit_tp: bool = False,
    remat_save_outputs: bool = False,
    extra_tags: str = "",
) -> Dict:
    """One rank's step of (arch, shape) on the production mesh, on meta: the
    counterpart of the reference's ``lower_pair`` (module docstring)."""
    cfg = get_arch(arch_name)
    shape = INPUT_SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "mesh": _mesh_name(multi_pod),
                "status": "skipped", "reason": why}
    mesh = make_production_mesh(multi_pod=multi_pod, rank=0)
    model = factory.build(cfg, mla_absorb=mla_absorb, seq_parallel=seq_parallel,
                          explicit_tp=explicit_tp, remat_save_outputs=remat_save_outputs)
    t0 = time.time()
    fn, args = step_fn(model, cfg, shape, mesh)
    cost = analyze_step(fn, args, mesh)
    trace_s = time.time() - t0
    kernels = cost["kernels"].values()  # the kernels' own work, beside the ops'
    flops = cost["flops"] + sum(k["flops"] for k in kernels)
    bytes_acc = cost["bytes"] + sum(k["bytes"] for k in kernels)
    coll = collective_bytes(cost["collectives"])
    chips = mesh.size
    terms = roofline_terms(flops, bytes_acc, coll)
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode" else 1)
    n_params = cfg.active_param_count()
    mf = model_flops(n_params, tokens, "train" if shape.mode == "train" else "serve")
    mem = cost["memory"]
    return {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": _mesh_name(multi_pod),
        "tags": extra_tags,
        "status": "ok",
        "trace_s": round(trace_s, 2),
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "bytes_convention": BYTES_CONVENTION,
        "kernel_read_bytes": sum(k["read_bytes"] for k in kernels),
        "memory": {**mem, "peak_share_of_hbm": mem["peak_bytes"] / hw.HBM_BYTES},
        "kernels": {"by_name": cost["kernels"], "plain_routes": cost["plain_routes"]},
        "collectives": coll,
        "collective_counts": cost["collectives"],
        "roofline": terms,
        "model_flops_global": mf,
        "useful_flops_ratio": mf / (flops * chips) if flops else 0.0,
        "params_total": cfg.param_count(),
        "params_active": n_params,
        "top": op_cost.top_contributors(cost, 10),
    }


def phase_counts(cfg, mesh, train=None, prefill=None, decode: Optional[int] = None,
                 build: Optional[Dict] = None) -> Dict:
    """The collectives a rank of ``mesh`` (a dry mesh) counts in each phase
    of a sharded main path (``launch.tp_cases.main_path``): ``train`` (B, S)
    one ``sgd_train_step``; ``prefill`` (B, S) one ``prefill``; ``decode``
    steps from caches of the prefill's length, on weights gathered whole
    over the data axes once (``decode_gather``) as a serving replica holds
    them. {phase: pshard's {kind: {"calls", "bytes"}}}."""
    from repro_torch.configs.base import ShapeConfig

    model = factory.build(cfg, **(build or {}))
    out = {}
    for phase, dims in (("train", train), ("prefill", prefill)):
        if dims is None:
            continue
        shape = ShapeConfig(phase, dims[1], dims[0], phase)
        fn, args = step_fn(model, cfg, shape, mesh)
        out[phase] = _collectives(lambda: fn(*args), mesh)[1]
    if decode:
        shape = ShapeConfig("decode", prefill[1], prefill[0], "decode")
        fn, (params, caches, token) = step_fn(model, cfg, shape, mesh)
        specs, dpax = factory.param_specs(cfg, mesh), sharding.dp_axes(mesh)
        params, out["decode_gather"] = _collectives(
            lambda: sharding.gather_axes(params, specs, mesh, dpax), mesh)

        def steps():
            for _ in range(decode):
                fn(params, caches, token)

        with pshard.whole_over(dpax):
            out["decode"] = _collectives(steps, mesh)[1]
    return out


def _print(r: Dict) -> None:
    if r["status"] == "ok":
        rf = r["roofline"]
        ms = {k: rf[k] * 1e3 for k in ("compute_s", "memory_s", "collective_s")}
        print(f"  ok: trace {r['trace_s']}s | flops/dev {r['flops_per_device']:.3e} "
              f"bytes/dev {r['bytes_per_device']:.3e} coll/dev "
              f"{rf['collective_bytes_total']:.3e} | compute {ms['compute_s']:.2f}ms "
              f"memory {ms['memory_s']:.2f}ms collective {ms['collective_s']:.2f}ms "
              f"-> {rf['dominant']} {max(ms.values()):.2f}ms | peak "
              f"{r['memory']['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    else:
        print(f"  {r['status']}: {r.get('reason', r.get('error', ''))[:300]}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-mla-absorb", action="store_true",
                    help="naive MLA decode (roofline baseline)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="sequence-parallel residual (Megatron SP)")
    ap.add_argument("--explicit-tp", action="store_true",
                    help="the MLP's explicit bf16 sum")
    ap.add_argument("--remat-save-outputs", action="store_true",
                    help="remat policy: save each branch's output, so the backward's "
                         "recompute stops before the branch's closing sum")
    ap.add_argument("--tags", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    outdir = args.out or ARTIFACT_DIR
    os.makedirs(outdir, exist_ok=True)

    pairs = []
    if args.all:
        for a in sorted(all_archs()):
            for s in INPUT_SHAPES:
                pairs.append((a, s))
    else:
        pairs.append((args.arch, args.shape))
    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    results = []
    for a, s in pairs:
        for mp in meshes:
            tag = f"{a}.{s}.{'mp' if mp else 'sp'}"
            if args.no_mla_absorb:
                tag += ".noabsorb"
            if args.seq_parallel:
                tag += ".seqpar"
            if args.explicit_tp:
                tag += ".exptp"
            if args.remat_save_outputs:
                tag += ".rematout"
            if args.tags:
                tag += f".{args.tags}"  # keep tagged runs from clobbering baselines
            print(f"=== {tag} ===", flush=True)
            try:
                r = lower_pair(a, s, mp, mla_absorb=not args.no_mla_absorb,
                               seq_parallel=args.seq_parallel,
                               explicit_tp=args.explicit_tp,
                               remat_save_outputs=args.remat_save_outputs,
                               extra_tags=args.tags or
                               ("rematout" if args.remat_save_outputs else "") or
                               ("seqpar" if args.seq_parallel else "") or
                               ("exptp" if args.explicit_tp else "") or
                               ("noabsorb" if args.no_mla_absorb else ""))
            except Exception as e:
                traceback.print_exc()
                r = {"arch": a, "shape": s, "mesh": _mesh_name(mp),
                     "status": "error", "error": f"{type(e).__name__}: {e}"}
            results.append(r)
            with open(os.path.join(outdir, f"dryrun_{tag}.json"), "w") as f:
                json.dump(r, f, indent=1)
            _print(r)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"DONE ok={n_ok} skipped={n_skip} errors={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
