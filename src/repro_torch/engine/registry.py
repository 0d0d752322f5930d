"""Name-based registries for selection policies and aggregators.

A scenario is a *registry entry*, not a fork of a round loop: register a
factory under a name and every driver, benchmark, and engine can construct
it from a config string. Factories are normalized so dispatch needs no
per-policy special cases:

    policy factory      (n, k, m, **kwargs) -> Policy
    aggregator factory  (**kwargs)          -> Aggregator

Built-ins register themselves at import time (`repro_torch.core.selection` for
the paper's policies, `repro_torch.engine.aggregators` for fedavg / fedbuff /
fedprox); user code registers the same way:

    from repro_torch.engine import register_policy

    @register_policy("my_sched")
    def _make(n, k, m, **kw):
        return Policy("my_sched", init, step, exact_k=True)

and ``RunConfig(policy="my_sched")`` just works — no engine edits.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

_POLICIES: Dict[str, Callable] = {}
_AGGREGATORS: Dict[str, Callable] = {}


def register_policy(name: str) -> Callable:
    """Decorator: register ``factory(n, k, m, **kw) -> Policy`` under ``name``."""

    def deco(factory: Callable) -> Callable:
        if name in _POLICIES:
            raise ValueError(f"policy {name!r} already registered")
        _POLICIES[name] = factory
        return factory

    return deco


def register_aggregator(name: str) -> Callable:
    """Decorator: register ``factory(**kw) -> Aggregator`` under ``name``."""

    def deco(factory: Callable) -> Callable:
        if name in _AGGREGATORS:
            raise ValueError(f"aggregator {name!r} already registered")
        _AGGREGATORS[name] = factory
        return factory

    return deco


def make_policy(name: str, n: int, k: int, m: int = 10, **kw):
    """Construct a registered policy by name."""
    try:
        factory = _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; registered: {', '.join(policy_names())}"
        ) from None
    return factory(n, k, m, **kw)


def make_aggregator(name: str, **kw):
    """Construct a registered aggregator by name."""
    try:
        factory = _AGGREGATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregator {name!r}; registered: "
            f"{', '.join(aggregator_names())}"
        ) from None
    return factory(**kw)


def policy_names() -> Tuple[str, ...]:
    return tuple(_POLICIES)


def aggregator_names() -> Tuple[str, ...]:
    return tuple(_AGGREGATORS)
