"""Start D ranks of one program over ``torch.distributed``, and run engine
cases inside them.

``spawn(fn, world, args)`` runs ``fn(rank, world, *args)`` in ``world``
fresh processes joined into one process group. The rendezvous is a
``FileStore`` in a fresh temporary directory, so parallel callers (test
workers, several drivers on one host) never share a port. The group has a
deadline: a rank that raises, dies or outlives it fails the call, and every
rank is stopped; nothing falls back to fewer ranks.

Ranks on one card: NCCL refuses two ranks on one GPU, and gloo moves host
tensors only, so a world of D ranks on one card (``devices=["cuda:0"] * D``)
runs gloo, and the collectives of ``models/pshard.py`` and
``core/distributed.py`` stage each CUDA tensor through host memory; the
compute and every kernel stay on the card. Ranks with a card each run
NCCL. ``backend_for(devices)`` picks between them.

``run_cases`` is a rank entry point (``spawn`` imports it by name): it
builds each case's small task, drives the sharded engine as the case says,
and rank 0 writes the results with ``torch.save``. ``case_task`` and
``run_case`` are shared with the one-process side of a comparison, so both
sides build the same task and read the same outputs:

    case = {"name": "markov-fedbuff", "task": {...}, "cfg": {...},
            "drive": "per_step" | "chunked" | "run_engine",
            "draws": None | {"init": {...}, "steps": [...]},
            "deterministic": bool, "tf32": bool}  # cuDNN/TF32 on the card

A case with an ``"op"`` instead runs one of ``core.distributed``'s
scheduler functions on the whole world's mesh (``run_op``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def _entry(rank: int, fn: Callable, world: int, store_path: str, backend: str,
           devices: Optional[Sequence[str]], threads: int, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    if devices:
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    store = torch.distributed.FileStore(store_path, world)
    torch.distributed.init_process_group(backend, store=store, rank=rank,
                                         world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        torch.distributed.destroy_process_group()


def backend_for(devices: Optional[Sequence[str]]) -> str:
    """NCCL where every rank has a card of its own, else gloo (CPU ranks, or
    several ranks sharing a card: the collectives go through host memory)."""
    if devices and all(torch.device(d).type == "cuda" for d in devices) \
            and len({torch.device(d) for d in devices}) == len(devices):
        return "nccl"
    return "gloo"


def spawn(fn: Callable, world: int, args: tuple = (), backend: str = "gloo",
          devices: Optional[Sequence[str]] = None, timeout: float = 900.0,
          threads: Optional[int] = None) -> None:
    """``fn(rank, world, *args)`` on ``world`` new ranks over ``backend``;
    ``devices[rank]`` (e.g. ``"cuda:1"``) becomes rank ``rank``'s current
    CUDA device. Each rank runs ``threads`` CPU threads (default: the
    host's threads shared out, at least one), so D ranks do not
    oversubscribe the cores. Returns when every rank has returned; raises
    if one raised or died, or after ``timeout`` seconds (all ranks are
    killed)."""
    import torch.multiprocessing as mp

    if threads is None:
        threads = max(torch.get_num_threads() // world, 1)
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        ctx = mp.start_processes(
            _entry, args=(fn, world, os.path.join(tmp, "store"), backend,
                          devices, threads, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"a group of {world} ranks did not finish within "
                        f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()


# ---------------------------------------------------------------------------
# Engine cases run inside the ranks
# ---------------------------------------------------------------------------

_TASKS: Dict[tuple, object] = {}


def case_task(spec: Dict):
    """The case's CNN task: the paper CNN (``cnn`` overrides its widths) on
    ``make_image_dataset(*data, seed, difficulty)`` or, with ``scale``, the
    MNIST stand-in at that scale; built once per process and spec."""
    key = tuple(sorted((k, repr(v)) for k, v in spec.items()))
    task = _TASKS.get(key)
    if task is None:
        from repro_torch.configs.paper_cnn import MNIST_CNN
        from repro_torch.data.synthetic import load_dataset, make_image_dataset
        from repro_torch.fl import make_cnn_task

        if "scale" in spec:
            train, test = load_dataset("mnist", seed=spec.get("seed", 0),
                                       scale=spec["scale"])
        else:
            train, test = make_image_dataset(*spec["data"], seed=0,
                                             difficulty=spec.get("difficulty", 0.8))
        cnn = dataclasses.replace(MNIST_CNN, **spec.get("cnn", {}))
        task = _TASKS[key] = make_cnn_task(cnn, train, test, spec["n"],
                                           seed=spec.get("seed", 0),
                                           device=spec.get("device", "cpu"))
    return task


def _host(tree):
    """A tree of tensors copied to host numpy arrays."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def run_case(case: Dict, engine) -> Dict:
    """Drive ``engine`` as ``case["drive"]`` says and return host results:
    ``per_step`` — the send masks, per-step losses and the final state
    (whole: a sharded engine's blocks are gathered); ``chunked`` — one
    ``run_chunk`` over the run, the final state; ``run_engine`` — the
    ``RunResult``'s selection, records, stats and params."""
    from repro_torch.engine import run_engine

    cfg = engine.cfg
    drive = case.get("drive", "per_step")
    unshard = getattr(engine, "unshard", lambda s: s)
    if drive == "run_engine":
        res = run_engine(engine)
        return {"selection": res.selection, "params": _host(res.params),
                "records": [dataclasses.asdict(r) for r in res.records],
                "load_stats": res.load_stats, "wall_stats": res.wall_stats,
                "defense": res.defense, "fault_exposure": res.fault_exposure}
    state = engine.init()
    out: Dict = {}
    if drive == "chunked":
        state, aux = engine.run_chunk(state, 0, cfg.rounds, True)
        out["send"] = _host(aux["send"])
        out["loss"] = _host(aux["loss"])
    else:
        sends, losses = [], []
        for r in range(cfg.rounds):
            state, aux = engine.step(state, r)
            sends.append(_host(aux["send"]))
            losses.append(_host(aux["loss"]))
        out["send"], out["loss"] = np.stack(sends), np.stack(losses)
    out["state"] = _host(unshard(state))
    if hasattr(engine, "fleet_state_bytes"):
        out["state_bytes"] = engine.per_device_state_bytes(state)
        out["fleet_bytes"] = engine.fleet_state_bytes(state)
        out["client_rows"] = {k: int(v.shape[0])
                              for k, v in engine.task.client_data.items()}
    out["eval"] = _host(engine.evaluate(state))
    out["sharded_eval"] = getattr(engine, "_sharded_eval", None) is not None
    return out


def single_case(case: Dict) -> Dict:
    """``case`` on one device: its config without ``mesh_shards`` and
    ``shard_cohort`` (the replicated run a sharded case is held to)."""
    cfg = {k: v for k, v in case["cfg"].items()
           if k not in ("mesh_shards", "shard_cohort")}
    return {**case, "name": case["name"] + "/single", "cfg": cfg}


def case_engine(case: Dict, **overrides):
    """The engine of ``case`` (its config with ``overrides``), its draws
    replayed when the case carries them."""
    from repro_torch.core.draws import ReplayDraws
    from repro_torch.engine import RunConfig, make_engine

    task = case_task(case["task"])
    cfg = RunConfig(**{**case["cfg"], **overrides})
    draws = None
    if case.get("draws") is not None:
        draws = ReplayDraws(case["draws"]["init"], case["draws"]["steps"],
                            task.device)
    return make_engine(task, cfg, draws=draws)


def run_op(case: Dict) -> Dict:
    """One of ``core.distributed``'s functions on the world's mesh, each
    rank holding its block of the case's full-width input; the outputs
    are the same on every rank (per-rank blocks all-gathered):

      * ``pop`` — ``sharded_next_k_events`` of ``times`` (any ``n``; the
        ragged last blocks are short or empty): ``t``, ``idx``;
      * ``oldest`` — ``oldest_age_step_sharded`` of ``ages`` (``n`` a
        multiple of D), ``reps`` times: ``sel``, ``new_ages``, ``chosen``;
      * ``markov`` — ``markov_step_sharded`` over ``rounds`` rounds from
        ``ages`` with ``probs``/``m``, its draws replayed from
        ``draws`` when given (else a generator seeded ``seed``): the
        ``(rounds, n)`` selections and the counts;
      * ``cohort_apply`` — ``aggregators.cohort_sharded_apply`` of the
        aggregator ``agg`` over ``g``/``updates``/``bases``/``w`` (the
        cohort axis split over the ranks): the new params."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.draws import GeneratorDraws, ReplayDraws

    mesh = dist.fleet_mesh(0)
    op = case["op"]
    if op == "pop":
        times = torch.as_tensor(case["times"], dtype=torch.float32)
        n = times.shape[0]
        shard = -(-n // mesh.size)
        block = times[mesh.rank * shard:(mesh.rank + 1) * shard]
        t, idx = dist.sharded_next_k_events(mesh, n, case["k"])(block)
        return {"t": _host(t), "idx": _host(idx)}
    if op == "oldest":
        ages = torch.as_tensor(case["ages"])
        per = ages.shape[0] // mesh.size
        step = dist.oldest_age_step_sharded(mesh, case["k"])
        outs = [step(ages[mesh.rank * per:(mesh.rank + 1) * per])
                for _ in range(case.get("reps", 1))]
        return [{"sel": _host(dist.all_gather(s, mesh).reshape(-1)),
                 "new_ages": _host(dist.all_gather(a, mesh).reshape(-1)),
                 "chosen": _host(c)} for s, a, c in outs]
    if op == "markov":
        ages = torch.as_tensor(case["ages"], dtype=torch.int32)
        per = ages.shape[0] // mesh.size
        ages = ages[mesh.rank * per:(mesh.rank + 1) * per]
        if case.get("draws") is not None:
            draws = ReplayDraws({}, case["draws"], "cpu")
        else:
            draws = GeneratorDraws(case.get("seed", 0), "cpu")
        step = dist.markov_step_sharded(mesh, case["probs"], case["m"])
        sels, counts = [], []
        for r in range(case["rounds"]):
            sel, ages, count = step(ages, draws.step(r))
            sels.append(_host(dist.all_gather(sel, mesh).reshape(-1)))
            counts.append(int(count))
        return {"sel": np.stack(sels), "count": np.asarray(counts)}
    if op == "cohort_apply":
        from repro_torch.engine import make_aggregator
        from repro_torch.engine.aggregators import cohort_sharded_apply

        t = lambda tree: {k: torch.as_tensor(v) for k, v in tree.items()}  # noqa: E731
        w = torch.as_tensor(case["w"])
        per = w.shape[0] // mesh.size
        sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
        apply = cohort_sharded_apply(make_aggregator(case["agg"]), mesh)
        params, _ = apply(t(case["g"]), {k: v[sl] for k, v in t(case["updates"]).items()},
                          {k: v[sl] for k, v in t(case["bases"]).items()}, w[sl])
        return _host(params)
    raise ValueError(f"unknown op {op!r}")


def run_cases(rank: int, world: int, cases_path: str, out_path: str) -> None:
    """Rank entry point: every case of ``torch.load(cases_path)`` on this
    rank's engine (the case config's ``mesh_shards``); rank 0 saves the
    list of results to ``out_path``."""
    cases: List[Dict] = torch.load(cases_path, weights_only=False)
    results = []
    for case in cases:
        if "op" in case:
            results.append(run_op(case))
            continue
        if case.get("deterministic"):
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        if "tf32" in case:
            torch.backends.cudnn.allow_tf32 = case["tf32"]
            torch.backends.cuda.matmul.allow_tf32 = case["tf32"]
        results.append(run_case(case, case_engine(case)))
    if rank == 0:
        torch.save(results, out_path)


def run_cases_on_ranks(cases: List[Dict], world: int, tmp_dir: str,
                       backend: str = "gloo", devices=None,
                       timeout: float = 600.0, threads: int = 1) -> List[Dict]:
    """``run_cases`` over ``world`` spawned ranks of ``threads`` CPU threads
    each (the cases are small: one thread keeps D ranks off each other's
    cores); returns rank 0's results (one dict per case)."""
    cases_path = os.path.join(tmp_dir, f"cases_{world}.pt")
    out_path = os.path.join(tmp_dir, f"results_{world}.pt")
    torch.save(cases, cases_path)
    spawn(run_cases, world, (cases_path, out_path), backend=backend,
          devices=devices, timeout=timeout, threads=threads)
    return torch.load(out_path, weights_only=False)
