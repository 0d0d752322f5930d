"""Fault injection + graceful degradation (``repro_torch.faults``).

    from repro_torch.faults import make_fault, FaultSet

    fs = FaultSet([make_fault("dropout", n, 0.1),
                   make_fault("corrupt", n, 0.05, sigma=2.0)])

Engines take the set through ``RunConfig(faults=("dropout", "corrupt"),
fault_rate=...)``; serve-scope faults (``replica_crash``) are for the
serving loop, which arrives with ROADMAP queue 1, slice H.
"""
from repro_torch.faults.inject import (  # noqa: F401
    Effects,
    Fault,
    FaultSet,
    collude_updates,
    corrupt_updates,
    effects_hit,
    identity_effects,
    merge_effects,
)
from repro_torch.faults.registry import (  # noqa: F401
    BUILTIN_FAULTS,
    fault_names,
    known_fault_names,
    make_fault,
    register_fault,
)

__all__ = [
    "BUILTIN_FAULTS",
    "Effects",
    "Fault",
    "FaultSet",
    "collude_updates",
    "corrupt_updates",
    "effects_hit",
    "fault_names",
    "identity_effects",
    "known_fault_names",
    "make_fault",
    "merge_effects",
    "register_fault",
]
