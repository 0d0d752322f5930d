"""Request routers: which replica admits the next request.

Port of ``repro.serve.router``. A router is the serving-tier analogue of a
selection policy, a pair of functions wrapped in a ``Router`` record:

    state = router.init(draws, n_replicas)
    replica, state = router.step(state, load, draws)   # replica: () int32

``draws`` is a ``core.draws`` source (the reference takes a key): the
serving loop hands decision ``d`` the source ``draws.sub("router").step(d)``.
``load`` is the (R,) float32 in-flight load per replica; ``replica`` is the
chosen replica index, or ``-1`` when the router rejects the admission this
decision (the request stays queued). Every ``step`` call is one decision
epoch: the paper's load metric X counts decisions between subsequent
assignments of a replica, so the Markov router's closed-form Var[X]
(``load_metric.optimal_var(R, 1, m)``) applies with n := R, k := 1.

Router state and the load vector are R-wide (R of 2 to 8) and every
decision is read by the host at once, so the serving loop keeps them on
the CPU; the routers run on whatever device their inputs are on.

Routers are registry entries, not loop forks:

    from repro_torch.serve import register_router

    @register_router("my_router")
    def _make(n_replicas, **kw):
        return Router("my_router", init, step)

Built-ins:
  * ``round_robin``  — cursor over replicas, ignores load (Var[X] = 0).
  * ``least_loaded`` — argmin of the load vector, lowest index on ties.
  * ``markov``       — the paper's decentralized age-dependent admission
                       rule: each replica independently draws willingness
                       ~ Bernoulli(p_{min(age, m)}) from the same chain as
                       ``core.selection.make_markov`` (on a 1-replica pool
                       the admission sequence is the policy's selection
                       sequence); the request goes to the least-loaded
                       willing replica, or is rejected when none is willing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import load_metric, selection


@dataclasses.dataclass(frozen=True)
class Router:
    name: str
    init: Callable  # (draws, n_replicas) -> state
    step: Callable  # (state, load, draws) -> (replica () int32; -1 = reject, state)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_ROUTERS: Dict[str, Callable] = {}


def register_router(name: str) -> Callable:
    """Decorator: register ``factory(n_replicas, **kw) -> Router``."""

    def deco(factory: Callable) -> Callable:
        if name in _ROUTERS:
            raise ValueError(f"router {name!r} already registered")
        _ROUTERS[name] = factory
        return factory

    return deco


def make_router(name: str, n_replicas: int, **kw) -> Router:
    """Construct a registered router by name."""
    try:
        factory = _ROUTERS[name]
    except KeyError:
        raise ValueError(
            f"unknown router {name!r}; registered: {sorted(_ROUTERS)}"
        ) from None
    return factory(n_replicas, **kw)


def router_names() -> Tuple[str, ...]:
    return tuple(sorted(_ROUTERS))


def penalized_load(load, penalty) -> torch.Tensor:
    """Reputation-adjusted load vector: add a per-replica penalty (the
    serving loop's decayed crash count x weight) onto the finite entries
    so flaky-but-alive replicas lose routing ties, while the pool's +inf
    dead markers pass through untouched."""
    load = torch.as_tensor(load, dtype=torch.float32)
    pen = torch.as_tensor(penalty, dtype=torch.float32, device=load.device)
    return torch.where(torch.isfinite(load), load + pen, load)


def _decision(idx: torch.Tensor, any_ok: torch.Tensor) -> torch.Tensor:
    """``idx`` as a () int32 decision, or -1 where ``any_ok`` is false."""
    return torch.where(any_ok, idx, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# Built-ins
# ---------------------------------------------------------------------------


def make_round_robin(n_replicas: int) -> Router:
    """Deterministic cursor: decision d goes to replica d % R. Every
    replica's assignment gap is exactly R: Var[X] = 0.

    Dead replicas (load = +inf, the pool's crash marker) are skipped: the
    pick is the first alive replica at or after the cursor, and the
    decision is -1 when the whole pool is dead."""

    def init(draws, r=n_replicas):
        return {"cursor": torch.zeros((), dtype=torch.int32)}

    def step(state, load, draws):
        order = torch.remainder(torch.arange(n_replicas, device=load.device)
                                - state["cursor"], n_replicas)
        alive = torch.isfinite(load)
        score = (-order.to(torch.float32)).masked_fill(~alive, float("-inf"))
        idx = torch.argmax(score)  # first maximum: the lowest order
        return _decision(idx, alive.any()), {"cursor": state["cursor"] + 1}

    return Router("round_robin", init, step)


def make_least_loaded(n_replicas: int) -> Router:
    """Greedy: the replica with the least in-flight load (lowest index on
    ties). Centralized, the admission analogue of the ``oldest_age`` top-k
    policy. Dead replicas carry load = +inf and lose every argmin; a fully
    dead pool rejects (-1)."""

    def init(draws, r=n_replicas):
        return {}

    def step(state, load, draws):
        return _decision(torch.argmin(load), torch.isfinite(load).any()), state

    return Router("least_loaded", init, step)


def make_markov_admission(
    n_replicas: int,
    m: int = 10,
    probs=None,
    steady_start: bool = True,
    target_gap: Optional[float] = None,
) -> Router:
    """The paper's age-dependent Markov rule as an admission policy.

    Each replica runs its own age chain (age = decisions since it last
    took a request) and draws willingness ~ Bernoulli(p_{min(age, m)}):
    ``core.selection.make_markov``'s draw over n := R replicas, k := 1
    admission per decision (or ``probs`` / ``target_gap`` for explicit
    chains; ``target_gap`` is the desired E[X] in decisions, Theorem 2's
    n/k). The request goes to the least-loaded willing replica; when none
    is willing the decision is -1 and the request waits. The draws are the
    policy's own sites (``policy_init``, ``select``), so on a 1-replica pool
    the admit/reject sequence is the policy's selection sequence.
    """
    if probs is None and target_gap is not None:
        probs = np.asarray(load_metric.optimal_probs_for_mean(float(target_gap), m))
    policy = selection.make_markov(n_replicas, 1, m, probs=probs,
                                   steady_start=steady_start)

    def init(draws, r=n_replicas):
        return policy.init(draws, r)

    def step(state, load, draws):
        willing, state = policy.step(state, draws)
        # dead replicas (load = +inf) may be willing but can't serve
        usable = willing & torch.isfinite(load)
        score = load.masked_fill(~usable, float("inf"))
        return _decision(torch.argmin(score), usable.any()), state

    return Router("markov", init, step)


register_router("round_robin")(make_round_robin)
register_router("least_loaded")(make_least_loaded)
register_router("markov")(make_markov_admission)

ROUTER_NAMES = router_names()
