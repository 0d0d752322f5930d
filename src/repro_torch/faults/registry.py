"""The fault registry: names -> fault factories, torch-free.

Copied from ``repro.faults.registry``. A fault is a registry entry
(``@register_fault``), not a fork of an engine loop. This module is
deliberately import-light (no torch) so ``RunConfig`` can validate fault
names at construction time without touching the simulator — the actual
``Fault`` objects (tensor state + hooks) live in
``repro_torch.faults.inject`` and are built lazily by ``make_fault``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

_FAULTS: Dict[str, Callable] = {}

# names ``repro_torch.faults.inject`` registers on import — listed
# statically so config validation can reject typos without importing torch
BUILTIN_FAULTS = (
    "collude",
    "corrupt",
    "dropout",
    "replica_crash",
    "scale_attack",
    "sign_flip",
    "stale_replay",
    "straggler",
)


def register_fault(name: str) -> Callable:
    """Decorator: register ``factory(n, rate, **kw) -> Fault``."""

    def deco(factory: Callable) -> Callable:
        if name in _FAULTS:
            raise ValueError(f"fault {name!r} already registered")
        _FAULTS[name] = factory
        return factory

    return deco


def _ensure_builtins() -> None:
    # the built-in faults self-register on import (like policies and
    # aggregators); lazy so make_fault works regardless of import order
    from repro_torch.faults import inject  # noqa: F401


def known_fault_names() -> Tuple[str, ...]:
    """Every resolvable fault name, *without* importing torch: the static
    built-in list plus whatever plugins have registered so far."""
    return tuple(sorted(set(BUILTIN_FAULTS) | set(_FAULTS)))


def fault_names() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_FAULTS))


def make_fault(name: str, n: int, rate: float, **kw):
    """Construct a registered fault by name for an ``n``-client fleet at
    per-event injection probability ``rate``."""
    _ensure_builtins()
    try:
        factory = _FAULTS[name]
    except KeyError:
        raise ValueError(
            f"unknown fault {name!r}; registered: {', '.join(fault_names())}"
        ) from None
    return factory(n, rate, **kw)
