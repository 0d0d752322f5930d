"""Legacy federated-learning run configuration (paper Sec. IV defaults),
copied from ``repro.fl.config``.

Kept as a thin convenience facade: the unified contract is
``repro_torch.engine.RunConfig`` (which absorbs this plus ``AsyncConfig``);
``run_config_from_legacy`` converts. New code should build a ``RunConfig``
directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FLConfig:
    n_clients: int = 100
    k: int = 15  # paper: 15% participation
    m: int = 10  # max permissible age (Markov policy)
    policy: str = "markov"  # any name in repro_torch.engine.policy_names()
    rounds: int = 100
    local_epochs: int = 5
    batch_size: int = 50
    lr0: float = 0.1
    lr_decay: float = 0.998
    seed: int = 0
    # cohort padding for variable-size policies (markov): vmap width
    max_cohort: Optional[int] = None
    eval_every: int = 1

    def __post_init__(self) -> None:
        if self.max_cohort is not None and self.max_cohort < self.k:
            raise ValueError(
                f"max_cohort={self.max_cohort} < k={self.k}: the cohort "
                "buffer could not hold even an exact-k selection; raise "
                "max_cohort (or leave it None for the binomial-tail default)"
            )

    def cohort_width(self) -> int:
        """Padded cohort buffer width for variable-size policies: the
        Markov cohort is ~Binomial(n, k/n), padded to k + 4*sigma."""
        from repro_torch.engine.config import default_cohort_width

        if self.max_cohort is not None:
            return self.max_cohort
        return default_cohort_width(self.n_clients, self.k)
