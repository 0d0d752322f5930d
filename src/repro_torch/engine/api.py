"""The ``Engine`` protocol and the run loop.

An engine is anything with ``init/step/run_chunk/finalize`` (plus the small
``eval_params/evaluate/record/progress_line`` hooks the loop uses);
``run_engine`` drives it for ``cfg.rounds`` steps in chunks of
``cfg.resolved_steps_per_chunk()`` steps, collects the selection history
(when kept) and eval records on the configured cadence, and returns a
typed ``RunResult``.

The loop makes **one host transfer per chunk**: the per-step aux scalars
(and, when history is kept, the chunk's stacked selection rows) come back
together. Load statistics never need the history — the engine folds
device-resident sufficient statistics (``core.load_metric``) every step.

    cfg = RunConfig(mode="sync", policy="markov")  # or mode="async"
    result = run_engine(make_engine(task, cfg), progress=True)
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from repro_torch.engine.config import RoundRecord, RunConfig, RunResult, chunk_plan

# collect the full (steps, n) selection matrix only below this cell count
HISTORY_CELL_CAP = 4_000_000


@runtime_checkable
class Engine(Protocol):
    """The contract ``run_engine`` drives."""

    task: object
    cfg: RunConfig

    def init(self) -> Dict: ...

    def step(self, state: Dict, r: int) -> Tuple[Dict, Dict]: ...

    def run_chunk(
        self, state: Dict, r0: int, length: int, with_history: bool
    ) -> Tuple[Dict, Dict]: ...

    def eval_params(self, state: Dict): ...

    def evaluate(self, state: Dict) -> Dict: ...

    def record(self, r: int, aux: Dict, ev: Dict) -> RoundRecord: ...

    def progress_line(self, rec: RoundRecord, elapsed: float) -> str: ...

    def finalize(self, state, records, sel_hist, wall_time_s) -> RunResult: ...


def make_engine(task, cfg: RunConfig, policy=None, aggregator=None,
                draws=None) -> Engine:
    """Instantiate the engine matching ``cfg`` on the task's device:
    ``SyncEngine``, ``AsyncEngine``, or — for async runs with
    ``mesh_shards`` set — the fleet-sharded ``ShardedAsyncEngine`` (a
    world of one is made when no process group exists and the shard count
    resolves to 1)."""
    if cfg.mode == "sync":
        from repro_torch.engine.sync import SyncEngine as engine_cls
    elif cfg.mesh_shards is not None:
        from repro_torch.engine.sharded import ShardedAsyncEngine as engine_cls
    else:
        from repro_torch.engine.async_engine import AsyncEngine as engine_cls
    return engine_cls(task, cfg, policy=policy, aggregator=aggregator,
                      draws=draws)


def keep_history(cfg: RunConfig) -> bool:
    """Whether a run materializes the (rounds, n) selection matrix:
    ``cfg.collect_history`` when set, else below ``HISTORY_CELL_CAP``."""
    if cfg.collect_history is not None:
        return cfg.collect_history
    return cfg.rounds * cfg.n_clients <= HISTORY_CELL_CAP


def _to_host(tree):
    return {k: v.cpu().numpy() for k, v in tree.items()}


def run_engine(engine: Engine, progress: bool = False) -> RunResult:
    """Drive an engine for ``cfg.rounds`` steps and package the result."""
    cfg = engine.cfg
    steps = cfg.rounds
    state = engine.init()
    keep_hist = keep_history(cfg)
    sel_hist: Optional[np.ndarray] = (
        np.zeros((steps, cfg.n_clients), dtype=bool) if keep_hist else None
    )
    records = []
    t0 = time.time()
    for r0, length, do_eval in chunk_plan(
        steps, cfg.eval_every, cfg.resolved_steps_per_chunk()
    ):
        state, aux = engine.run_chunk(state, r0, length, keep_hist)
        aux = _to_host(aux)  # the chunk's one device -> host transfer
        if keep_hist:
            sel_hist[r0:r0 + length] = aux.pop("send")
        if do_eval:
            r = r0 + length - 1
            ev = engine.evaluate(state)
            rec = engine.record(r, {k: v[-1] for k, v in aux.items()}, ev)
            records.append(rec)
            if progress:
                print(engine.progress_line(rec, time.time() - t0), flush=True)
    return engine.finalize(state, records, sel_hist, time.time() - t0)
