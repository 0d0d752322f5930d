"""Back-compat wrappers over the unified engine (``repro_torch.engine``),
as ``repro.sim.async_rounds`` keeps them.

The FedBuff-style buffered asynchronous loop is ``AsyncEngine`` in
``repro_torch.engine.async_engine``; ``run_async_training`` keeps the
legacy signature (plus ``draws``, the run's random source) and returns the
legacy history dict.

With the degenerate ``uniform`` latency profile (zero spread, always
available, no dropout) and ``buffer_size = k`` every dispatch completes
inside its own step with staleness 0, and the loop reproduces the
synchronous FedAvg round exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

from repro_torch.core.selection import Policy
from repro_torch.engine.api import HISTORY_CELL_CAP  # noqa: F401  (back-compat)
from repro_torch.fl.config import FLConfig
from repro_torch.fl.task import FLTask
from repro_torch.sim import latency as lat_mod


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    buffer_size: Optional[int] = None  # aggregation buffer; default fl.k
    staleness_mode: str = "poly"  # poly | const
    staleness_exp: float = 0.5  # weight = (1+s)^(-exp) for mode=poly
    max_versions: int = 8  # ring of retained global models
    profile: Union[str, lat_mod.LatencyProfile] = "lognormal"
    use_kernel: Optional[bool] = None  # None: kernel when fleet is large

    def resolved_profile(self) -> lat_mod.LatencyProfile:
        if isinstance(self.profile, lat_mod.LatencyProfile):
            return self.profile
        return lat_mod.get_profile(self.profile)


def run_async_training(
    task: FLTask,
    fl: FLConfig,
    acfg: Optional[AsyncConfig] = None,
    policy: Optional[Policy] = None,
    progress: bool = False,
    draws=None,
) -> Dict:
    """Full asynchronous FL run. ``fl.rounds`` counts *server steps* (one
    buffer flush each). Returns history + load stats on both clocks."""
    from repro_torch.engine.api import run_engine
    from repro_torch.engine.async_engine import AsyncEngine
    from repro_torch.engine.config import run_config_from_legacy

    acfg = acfg or AsyncConfig()
    cfg = run_config_from_legacy(fl, acfg)
    res = run_engine(AsyncEngine(task, cfg, policy=policy, draws=draws),
                     progress=progress)
    return {
        "history": res.history(),
        "selection": res.selection,
        "wall_stats": res.wall_stats,
        "params": res.params,
        "wall_time_s": res.wall_time_s,
    }
