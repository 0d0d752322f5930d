"""Adaptive defense tier: per-client reputation, quarantine with a
probation Markov chain, and moving-target aggregation — all riding the
engines' state (see :mod:`repro_torch.defense.reputation`).

The package import is lazy so ``RunConfig``'s eager defense validation
(``repro_torch.defense.config`` is a plain dataclass module) stays
torch-free; the runtime loads only when an engine builds it.
"""
from repro_torch.defense.config import DETECTORS, MTD_FAMILIES, DefenseConfig

__all__ = [
    "DETECTORS",
    "Defense",
    "DefenseConfig",
    "MTD_FAMILIES",
    "adaptive_aggregate",
    "auc_from_hist",
    "clique_scores",
    "make_defense",
]


def __getattr__(name):
    if name in ("Defense", "make_defense"):
        from repro_torch.defense import reputation

        return getattr(reputation, name)
    if name == "adaptive_aggregate":
        from repro_torch.defense.adaptive import adaptive_aggregate

        return adaptive_aggregate
    if name == "clique_scores":
        from repro_torch.defense.collusion import clique_scores

        return clique_scores
    if name == "auc_from_hist":
        from repro_torch.defense.learned import auc_from_hist

        return auc_from_hist
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
