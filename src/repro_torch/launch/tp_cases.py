"""Sharded LM cases: one model step on a (data, model) mesh of ranks, and the
same step on one device, for the contracts of the sharded path.

A case names a config, a mesh, full params (host tensors) and inputs:

    case = {"name": ..., "cfg": ArchConfig, "mesh": {"data": d, "model": m},
            "params": full tree, "batch": {...}, "lr": float,
            "prefill": {...} | None, "decode": (steps, B, 1) tokens | None,
            "build": {"explicit_tp": ..., "seq_parallel": ..., ...},
            "device": "cpu" | "cuda", "train": bool, "deterministic": bool,
            "whole_decode": bool}

(``train``: the loss's gradients and an SGD step, default on; the batch
must split over the data axes. A prefill batch that does not split names
its ``global_batch``.)

``run_case`` runs it where it is called: on the world's mesh
(``launch.mesh.make_host_mesh``) when ``sharded``, with the rank's blocks
of the params (``sharding.shard_tree``) and its rows of the batch, every
result gathered whole (``sharding.unshard_tree``); else on one device with
no mesh (``whole_decode``: the sharded decode steps run on weights
gathered whole over the data axes, ``pshard.whole_over``). Given a dry
``mesh`` (``launch.mesh.make_dry_mesh``) it runs the same calls on the meta
device as that rank, for the collectives' counts (the dry-run). Results
are host tensors (meta ones on a dry mesh): ``loss``, ``moe_aux``, ``grads``,
``new_params`` (after one ``sgd_train_step``), ``prefill_logits``,
``caches`` (every leaf), ``decode_logits`` and ``counts`` (the
collectives, by kind). ``run_cases`` is the rank entry point of
``launch.ranks.spawn``: rank 0 saves the list of results.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List

import torch


def _to(tree, device):
    from repro_torch.core.tree import tree_map

    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


def _host(tree):
    from repro_torch.core.tree import tree_map

    def host(t):
        if not isinstance(t, torch.Tensor):
            return t
        return t.detach() if t.is_meta else t.detach().cpu().clone()

    return tree_map(host, tree)


def _rows(tree, mesh):
    """The rank's rows (dim 0) of each batch leaf, as ``batch_pspecs`` lays
    them."""
    from repro_torch import sharding
    from repro_torch.core.tree import tree_map

    specs = sharding.batch_pspecs(tree, mesh)
    return tree_map(lambda t, sp: sharding.local_block(t, sp, mesh), tree, specs), specs


_MESHES: Dict = {}


def _host_mesh(model_axis: int, device):
    """``make_host_mesh(model_axis)``, made once per process group (each new
    subgroup is a rendezvous of every rank)."""
    from repro_torch.launch.mesh import make_host_mesh

    if not torch.distributed.is_initialized():
        return make_host_mesh(model_axis, device)
    key = (id(torch.distributed.group.WORLD), model_axis)
    if key not in _MESHES:
        _MESHES[key] = make_host_mesh(model_axis, device)
    return _MESHES[key]


def _grads(model, params, batch):
    from repro_torch.core.tree import tree_leaves, tree_map

    with torch.enable_grad():
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        total, metrics = model.loss(tracked, batch)
        leaves = tree_leaves(tracked)
        got = torch.autograd.grad(total, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p) for p, g in zip(leaves, got))
    return tree_map(lambda _: next(it), params), total, metrics


def run_case(case: Dict, sharded: bool, mesh=None) -> Dict:
    """The case on the world's mesh (``sharded``), on the dry ``mesh`` given
    (on meta), or on one device; with ``case["deterministic"]``, under
    deterministic algorithms (the card's embedding backward otherwise adds a
    repeated token's rows with atomics)."""
    saved = torch.are_deterministic_algorithms_enabled()
    if case.get("deterministic"):
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _run_case(case, sharded or mesh is not None, mesh)
    finally:
        torch.use_deterministic_algorithms(saved)


def _run_case(case: Dict, sharded: bool, dry=None) -> Dict:
    from repro_torch import sharding
    from repro_torch.core.tree import tree_paths
    from repro_torch.models import factory, pshard

    dev = "meta" if dry is not None else case.get("device", "cpu")
    cfg = case["cfg"]
    model = factory.build(cfg, **case.get("build", {}))
    params = _to(case["params"], dev)
    batch = _to(case["batch"], dev)
    out: Dict = {}
    mesh = dry if dry is not None else (_host_mesh(case["mesh"]["model"], dev) if sharded
                                        else None)
    if sharded and dict(mesh.shape) != {"data": case["mesh"]["data"],
                                        "model": case["mesh"]["model"]}:
        raise ValueError(f"{case['name']}: the world is not the case's mesh")
    pspecs = None
    with pshard.mesh_context(mesh):
        if sharded:
            pspecs = factory.param_specs(cfg)
            params = sharding.shard_tree(params, pspecs, mesh)
            batch, _ = _rows(batch, mesh)

        def whole(tree, specs):
            return tree if mesh is None else sharding.unshard_tree(tree, specs, mesh)

        pshard.reset_counts()
        if case.get("train", True):  # the batch splits over the data axes
            grads, total, metrics = _grads(model, params, batch)
            out["grads"] = _host(whole(grads, pspecs))
            out["total_loss"] = _host(total)
            new_params, metrics = model.sgd_train_step(params, batch, case.get("lr", 0.1))
            out["counts_train"] = pshard.counts()
            out["loss"], out["moe_aux"] = _host(metrics["loss"]), _host(metrics["moe_aux"])
            out["new_params"] = _host(whole(new_params, pspecs))
        if case.get("prefill") is not None:
            pb = _to(case["prefill"], dev)
            rows = None
            if sharded:  # the tensors' rows; ``seq_len``, ``global_batch`` as given
                tensors = {k: v for k, v in pb.items() if isinstance(v, torch.Tensor)}
                local, bspecs = _rows(tensors, mesh)
                pb = {**pb, **local}
                rows = bspecs["tokens"]
            with torch.no_grad():
                logits, caches = model.prefill(params, pb)
                row3 = None if rows is None else sharding.P(rows[0], None, None)
                out["prefill_logits"] = _host(whole(logits, row3))
                out["caches"] = _host(whole(caches, caches.layout[0] if sharded else None))
                dec = []
                toks = case.get("decode")
                weights, held = params, contextlib.nullcontext()
                if sharded and case.get("whole_decode"):  # weights whole over data
                    weights = sharding.gather_axes(params, pspecs, mesh, pshard.dp())
                    held = pshard.whole_over(pshard.dp())
                with held:
                    for tok in (toks if toks is not None else []):
                        tok = tok.to(dev)
                        if sharded:
                            tok = sharding.local_block(tok, sharding.P(rows[0], None), mesh)
                        logits, caches = model.decode_step(weights, caches, tok)
                        dec.append(_host(whole(logits, row3)))
                out["decode_logits"] = dec
                out["decode_caches"] = _host(whole(caches, caches.layout[0] if sharded
                                                   else None))
        out["counts"] = pshard.counts()
        if sharded and dry is None:  # the blocks of every rank gathered give the tree back
            full = _to(case["params"], dev)
            back = sharding.unshard_tree(sharding.shard_tree(full, pspecs, mesh), pspecs, mesh)
            out["roundtrip"] = all(torch.equal(a, b) for (_, a), (_, b)
                                   in zip(tree_paths(back), tree_paths(full)))
    return out


def mlp_counts(case: Dict) -> Dict:
    """One dense MLP forward and backward on the world's mesh (``model`` =
    the world), the GSPMD path and ``explicit_tp``: each path's collective
    counts. ``case``: d_model, d_ff, rows B x S, dtype, seed."""
    from repro_torch import sharding
    from repro_torch.configs.base import MLPSpec
    from repro_torch.models import mlp, pshard

    dev = case.get("device", "cpu")
    spec = MLPSpec(kind="dense", d_ff=case["d_ff"], activation="silu")
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    full = mlp.init_mlp(gen, case["d_model"], spec, case["dtype"])
    x = torch.randn((case["B"], case["S"], case["d_model"]), generator=gen).to(case["dtype"])
    mesh = _host_mesh(torch.distributed.get_world_size(), dev)
    out = {}
    with pshard.mesh_context(mesh):
        specs = sharding.params_pspecs({"mlp": full}, mesh)["mlp"]
        local = _to(sharding.shard_tree(full, specs, mesh), dev)
        for name, explicit in (("gspmd", False), ("explicit_tp", True)):
            p = {k: v.detach().requires_grad_() for k, v in local.items()}
            xi = x.detach().to(dev).requires_grad_()
            pshard.reset_counts()
            mp = pshard.materialize_tree(p, specs, mlp.sharded_dims(spec))
            y = mlp.mlp_fwd(mp, xi, spec, explicit_tp=explicit)
            y.float().sum().backward()
            out[name] = {"counts": pshard.counts(), "y": _host(y), "dx": _host(xi.grad)}
    return out


def _recorded(module, name, log, key):
    """Wrap ``module.<name>`` so each call appends its first argument's
    shape to ``log[key]``; returns the restore function."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        log.setdefault(key, []).append(tuple(args[0].shape))
        return fn(*args, **kw)

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, fn)


def _timed(fn):
    """(fn's result, its ms on the host clock, the device synchronized)."""
    import time

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main_path(case: Dict) -> Dict:
    """One rank of a full-size sharded run: the config ``case["arch"]`` (or
    ``case["cfg"]``) built with weights from ``case["seed"]`` on every rank
    and cut to the rank's blocks, on the world's mesh (``case["mesh"]``).
    ``train`` (B, S): one ``sgd_train_step``; ``prefill`` (B, S): one
    ``model.prefill``; ``decode`` (steps): that many decode steps from the
    prefill's caches, on weights gathered whole over the data axes once
    (``pshard.whole_over``), as a serving replica holds them. ``f32``: the
    seed's weights (in the config's dtype) cast to f32 and run in f32, a
    witness of the bf16 runs' rounding. Each phase draws its tokens from
    its own seed (``seed + 1``, ``+ 2``, ``+ 3``) on the device, whole, and
    each rank takes its rows. Returns, for this rank: its mesh
    coordinates, each phase's ms (host clock, collectives staged through
    host memory where the world runs gloo on the card), the kernels'
    launches and the shapes they were launched at, the loss, the logits
    gathered whole (f32 on the host), the collectives' counts and the peak
    device memory."""
    from repro_torch import configs, sharding
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import flash_decode as k5
    from repro_torch.kernels import ssd_scan as k6
    from repro_torch.models import factory, pshard

    dev = case.get("device", "cuda")
    if case.get("decode") is not None and case.get("prefill") is None:
        raise ValueError("main_path decodes from its prefill's caches: give both")
    cfg = case.get("cfg") or configs.get_arch(case["arch"])
    mesh = _host_mesh(case["mesh"]["model"], dev)
    seed = case.get("seed", 0)
    full = factory.build(cfg).init(torch.Generator(device=dev).manual_seed(seed))
    if case.get("f32"):
        cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        full = tree_map(lambda t: t.float() if t.is_floating_point() else t, full)
    model = factory.build(cfg, **case.get("build", {}))
    shapes: Dict = {}
    restore = [_recorded(k4, "_forward", shapes, "k4"), _recorded(k4, "_backward", shapes, "k4_bwd"),
               _recorded(k5, "flash_decode", shapes, "k5"), _recorded(k6, "_forward", shapes, "k6")]
    out: Dict = {"rank": torch.distributed.get_rank(), "coords": dict(mesh.coords),
                 "backend": str(torch.distributed.get_backend()), "ms": {}, "launches": {},
                 "shapes": shapes, "counts": {}}

    def counters():
        return {"k4": k4.launches, "k4_bwd": k4.bwd_launches, "k5": k5.launches,
                "k6": k6.launches}

    def rows(t):
        specs = sharding.batch_pspecs(t, mesh)
        return sharding.local_block(t, specs, mesh), specs

    try:
        with pshard.mesh_context(mesh):
            specs = factory.param_specs(cfg)
            params = sharding.shard_tree(full, specs, mesh)
            del full
            if dev != "cpu":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            for i, phase in enumerate(("train", "prefill", "decode")):
                if case.get(phase) is None:
                    continue
                gen = torch.Generator(device=dev).manual_seed(seed + 1 + i)
                before = counters()
                pshard.reset_counts()
                shapes.clear()
                if phase == "train":
                    B, S = case["train"]
                    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                                         device=dev, dtype=torch.int32)
                    batch = {"tokens": rows(toks[:, :-1])[0], "labels": rows(toks[:, 1:])[0]}
                    (new, met), ms = _timed(
                        lambda: model.sgd_train_step(params, batch, case.get("lr", 3e-3)))
                    out["loss"] = float(met["loss"])
                    del new
                elif phase == "prefill":
                    B, S = case["prefill"]
                    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                         device=dev, dtype=torch.int32)
                    local, bspec = rows(toks)
                    with torch.no_grad():
                        (logits, caches), ms = _timed(
                            lambda: model.prefill(params, {"tokens": local}))
                        with pshard.uncounted():  # the report's gather, not the step's
                            out["prefill_logits"] = sharding.unshard_tree(
                                logits, sharding.P(bspec[0], None, None), mesh).float().cpu()
                else:  # from the prefill's caches
                    steps = case["decode"]
                    toks = torch.randint(0, cfg.vocab_size, (steps, B, 1), generator=gen,
                                         device=dev, dtype=torch.int32)
                    dpax = pshard.dp()
                    # a serving replica holds its weights whole over data: gathered once
                    (whole, out["ms"]["decode_gather"]) = _timed(
                        lambda: sharding.gather_axes(params, specs, mesh, dpax))
                    out["counts"]["decode_gather"] = pshard.counts()
                    pshard.reset_counts()
                    got = []
                    with torch.no_grad(), pshard.whole_over(dpax):
                        def run():
                            nonlocal caches
                            for t in range(steps):
                                local, bspec = rows(toks[t])
                                lg, caches = model.decode_step(whole, caches, local)
                                with pshard.uncounted():
                                    got.append(sharding.unshard_tree(
                                        lg, sharding.P(bspec[0], None, None), mesh))
                        _, ms = _timed(run)
                    del whole
                    out["decode_logits"] = torch.stack(got).float().cpu()
                    del caches
                after = counters()
                out["ms"][phase] = ms
                out["launches"][phase] = {k: after[k] - before[k] for k in after}
                out["counts"][phase] = pshard.counts()
                out.setdefault("shapes_by_phase", {})[phase] = {
                    k: sorted(set(v)) for k, v in shapes.items()}
            if dev != "cpu":
                out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        for r in restore:
            r()
    return out


def run_cases(rank: int, world: int, cases_path: str, out_path: str) -> None:
    """Rank entry point: every case of ``torch.load(cases_path)`` on this
    world (``"op"``: ``mlp_counts`` or ``main_path``; else ``run_case``,
    sharded); rank 0 saves the results to ``out_path``, and, where a case
    runs ``main_path``, every rank saves its own to ``out_path.<rank>``."""
    cases: List[Dict] = torch.load(cases_path, weights_only=False)
    ops = {"mlp_counts": mlp_counts, "main_path": main_path}
    results = [ops[c["op"]](c) if "op" in c else run_case(c, sharded=True) for c in cases]
    if rank == 0:
        torch.save(results, out_path)
    if any(c.get("op") == "main_path" for c in cases):
        torch.save(results, f"{out_path}.{rank}")


def run_cases_on_ranks(cases: List[Dict], world: int, tmp_dir: str, backend=None,
                       devices=None, timeout: float = 600.0, threads: int = 1,
                       per_rank: bool = False) -> List:
    """``run_cases`` over ``world`` spawned ranks (``launch.ranks.spawn``;
    ``devices=["cuda:0"] * world`` puts them all on one card, over gloo;
    the backend defaults to ``ranks.backend_for(devices)``); rank 0's
    results, one dict per case (``per_rank``: every rank's list, for
    ``main_path`` cases)."""
    from repro_torch.launch.ranks import backend_for, spawn

    backend = backend or backend_for(devices)
    cases_path = os.path.join(tmp_dir, f"tp_cases_{world}.pt")
    out_path = os.path.join(tmp_dir, f"tp_results_{world}.pt")
    torch.save(cases, cases_path)
    spawn(run_cases, world, (cases_path, out_path), backend=backend, devices=devices,
          timeout=timeout, threads=threads)
    if per_rank:
        return [torch.load(f"{out_path}.{r}", weights_only=False) for r in range(world)]
    return torch.load(out_path, weights_only=False)


def leaf_gaps(got, want) -> Dict[str, float]:
    """Per leaf (by path) the max abs gap over the leaf's max magnitude (0
    for two all-zero leaves; exact compare of integer leaves: 0 or inf)."""
    from repro_torch.core.tree import tree_paths

    a, b = dict(tree_paths(got)), dict(tree_paths(want))
    if a.keys() != b.keys():
        raise AssertionError(f"trees differ: {sorted(a.keys() ^ b.keys())[:5]}")
    out = {}
    for k, w in b.items():
        g = a[k]
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
            raise AssertionError(f"{k}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        if not w.is_floating_point():
            out[k] = 0.0 if torch.equal(g, w) else float("inf")
            continue
        gap = float((g.double() - w.double()).abs().max()) if w.numel() else 0.0
        scale = float(w.double().abs().max()) if w.numel() else 0.0
        out[k] = gap / scale if scale > 0 else (0.0 if gap == 0 else float("inf"))
    return out
