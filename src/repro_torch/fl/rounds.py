"""Back-compat wrappers over the unified engine (``repro_torch.engine``),
as ``repro.fl.rounds`` keeps them.

The FedAvg round loop is ``SyncEngine`` in ``repro_torch.engine.sync``;
``run_training`` keeps the legacy signature (plus ``draws``, the run's
random source) and returns the legacy history dict.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.selection import Policy
from repro_torch.fl.config import FLConfig
from repro_torch.fl.task import FLTask


def make_round_fn(task: FLTask, fl: FLConfig, policy: Policy):
    """One FedAvg round (legacy helper): ``round_fn(params, sched_state,
    draws) -> (params, sched_state, selected, mean_loss)`` — policy step ->
    cohort gather -> local training -> fedavg aggregation."""
    from repro_torch.engine.config import run_config_from_legacy
    from repro_torch.engine.registry import make_aggregator
    from repro_torch.engine.sync import _make_round_core

    cfg = run_config_from_legacy(fl)
    core = _make_round_core(task, cfg, policy, make_aggregator("fedavg"))

    def round_fn(params, sched_state, draws):
        # the fault- and telemetry-free 4-tuple view of the round core
        return core(params, sched_state, draws)[:4]

    return round_fn


def run_training(
    task: FLTask,
    fl: FLConfig,
    policy: Optional[Policy] = None,
    progress: bool = False,
    draws=None,
) -> Dict:
    """Full FL run. Returns history dict with per-round eval metrics and
    the load-metric statistics of the realized selection history."""
    from repro_torch.engine.api import run_engine
    from repro_torch.engine.config import run_config_from_legacy
    from repro_torch.engine.sync import SyncEngine

    cfg = run_config_from_legacy(fl)
    res = run_engine(SyncEngine(task, cfg, policy=policy, draws=draws),
                     progress=progress)
    return {
        "history": res.history(),
        "selection": res.selection,
        "load_stats": res.load_stats,
        "params": res.params,
        "wall_time_s": res.wall_time_s,
    }


def rounds_to_target(history: Dict, target_acc: float) -> Optional[int]:
    """First round at which eval accuracy reaches the target (paper's
    convergence-speed metric)."""
    for r, a in zip(history["round"], history["accuracy"]):
        if a >= target_acc:
            return r
    return None
