"""Client-selection policies on torch tensors.

Every policy is a pair of functions wrapped in a ``Policy`` record — the
policy protocol of the engine API:

    state  = policy.init(draws, n)
    sel, state = policy.step(state, draws)     # sel: (n,) bool

Under fleet sharding the engines call ``policy.step(state, draws,
layout=...)`` with a sharded ``core.fleet`` layout: the state's ``ages``
are this rank's block, every ``(n,)`` draw is made at its full shape and
the rank keeps its block, a top-k runs through the layout's sharded merge,
and ``sel`` is this rank's block of the selection.

``draws`` is a ``repro_torch.core.draws`` source (a ``torch.Generator`` in
real runs, replayed reference draws in parity tests); policies draw at the
sites ``policy_init`` and ``select``. State is an explicit dict of tensors
on the draws' device. No step syncs with the host.

Each policy registers a ``(n, k, m, **kwargs) -> Policy`` factory in the
``repro_torch.engine`` registry (see the module bottom), under the same
names as the reference:

  * ``random``       — paper's baseline [2]: exactly k uniform at random.
  * ``markov``       — the paper's decentralized age-dependent Markov policy
                       with the optimal probabilities of Theorem 2.
  * ``markov_probs`` — same mechanism, arbitrary user-supplied p_0..p_m.
  * ``markov_hetero``— per-client participation rates, each client on its
                       own Theorem-2-optimal chain.
  * ``oldest_age``   — centralized equivalent (Remark 1): top-k by age.
  * ``round_robin``  — deterministic staggered blocks (Var[X] = 0 when k | n).
  * ``gumbel_age``   — age-weighted sampling without replacement (Gumbel
                       top-k on beta*age).

``oldest_age`` and ``gumbel_age`` take a top-k with lower-index-first ties,
as the reference's ``lax.top_k`` does: the K3 kernel at fleet scale on the
GPU, a stable sort otherwise (``_topk_idx``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import load_metric
from repro_torch.core.aoi import age_update
from repro_torch.core.fleet import whole
from repro_torch.kernels import aoi_topk, ops


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    init: Callable  # (draws, n) -> state
    step: Callable  # (state, draws) -> (selected bool (n,), state)
    exact_k: bool  # cohort size deterministic?


def _base_state(n: int, device) -> Dict:
    return {
        "ages": torch.zeros((n,), dtype=torch.int32, device=device),
        "round": torch.zeros((), dtype=torch.int32, device=device),
    }


def _on_device(arr: np.ndarray) -> Callable:
    """A host constant, copied to each device once and then reused (no
    per-step host-to-device copy)."""
    cache: Dict[torch.device, torch.Tensor] = {}

    def get(device) -> torch.Tensor:
        t = cache.get(device)
        if t is None:
            t = cache[device] = torch.as_tensor(arr, device=device)
        return t

    return get


def _topk_idx(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, ties to the lower index, as the
    reference's ``lax.top_k``, in ascending index order (``_mask`` discards
    the order, so no sort is paid for).

    A score on CUDA with n >= ``sim.events.KERNEL_THRESHOLD`` (the
    reference's fleet scale) goes through the K3 kernel
    (``ops.oldest_age_topk``) for any k; any other shape or device takes the
    stable descending sort, which keeps equal scores in index order. This is
    a rule on the shape, not a fallback: a kernel that fails raises."""
    from repro_torch.sim.events import KERNEL_THRESHOLD  # sim imports this module

    if score.is_cuda and score.shape[0] >= KERNEL_THRESHOLD:
        return ops.oldest_age_topk(score, k, sorted=False)[1]
    return aoi_topk.topk_plain(score, k, sorted=False)[1]


def _mask(n: int, idx: torch.Tensor) -> torch.Tensor:
    sel = torch.zeros((n,), dtype=torch.bool, device=idx.device)
    return sel.index_fill(0, idx, True)


# ---------------------------------------------------------------------------
# Random selection (paper's baseline)
# ---------------------------------------------------------------------------


def make_random(n: int, k: int) -> Policy:
    def init(draws, n_=n):
        return _base_state(n_, draws.device)

    def step(state, draws, layout=None):
        perm = draws.permutation("select", n)
        sel = whole(layout, n).mask(perm[:k])
        return sel, _advance(state, sel)

    return Policy("random", init, step, exact_k=True)


# ---------------------------------------------------------------------------
# Decentralized Markov policy (the paper's contribution)
# ---------------------------------------------------------------------------


def make_markov(
    n: int,
    k: int,
    m: int,
    probs: Optional[np.ndarray] = None,
    steady_start: bool = True,
) -> Policy:
    """Age-dependent Bernoulli policy. Each client *independently* draws
    send ~ Bernoulli(p_{min(age, m)}) — no coordination (paper Sec. III).

    ``steady_start=True`` samples initial ages from the stationary
    distribution (the paper analyses the chain at steady state).
    """
    p = np.asarray(
        load_metric.optimal_probs(n, k, m) if probs is None else probs,
        dtype=np.float32,
    )
    if len(p) != m + 1:
        raise ValueError(f"probs must have length m+1={m + 1}")
    pi = load_metric.steady_state(p)
    p_dev = _on_device(p)

    def init(draws, n_=n):
        state = _base_state(n_, draws.device)
        if steady_start:
            ages = draws.categorical("policy_init", pi.astype(np.float32), (n_,))
            state["ages"] = ages.to(torch.int32)
        return state

    def step(state, draws, layout=None):
        ages = state["ages"]
        chain = torch.clamp(ages, max=m).long()
        send_p = p_dev(ages.device)[chain]
        sel = whole(layout, n).block(draws.uniform("select", (n,))) < send_p
        return sel, _advance(state, sel)

    return Policy("markov", init, step, exact_k=False)


def make_markov_hetero(
    rates: np.ndarray, m: int, steady_start: bool = True
) -> Policy:
    """Heterogeneous decentralized Markov policy: client i is selected at
    its own rate ``rates[i]`` (mean gap 1/rates[i]), each with its own
    Theorem-2-optimal chain."""
    rates = np.asarray(rates, dtype=np.float64)
    if np.any(rates <= 0) or np.any(rates > 1):
        raise ValueError("rates in (0, 1]")
    n = len(rates)
    table = np.stack(
        [load_metric.optimal_probs_for_mean(max(1.0 / r, 1.0), m) for r in rates]
    )  # (n, m+1)
    table_dev = _on_device(table.astype(np.float32))
    pis = np.stack([load_metric.steady_state(p) for p in table])
    cdf_dev = _on_device(np.cumsum(pis, axis=1).astype(np.float32))

    def init(draws, n_=n):
        state = _base_state(n_, draws.device)
        if steady_start:
            u = draws.uniform("policy_init", (n_,))
            ages = torch.sum(u[:, None] > cdf_dev(u.device), dim=1)
            state["ages"] = ages.to(torch.int32)
        return state

    def step(state, draws, layout=None):
        lay = whole(layout, n)
        ages = state["ages"]
        chain = torch.clamp(ages, max=m).long()
        send_p = torch.gather(lay.block(table_dev(ages.device)), 1,
                              chain[:, None])[:, 0]
        sel = lay.block(draws.uniform("select", (n,))) < send_p
        return sel, _advance(state, sel)

    return Policy("markov_hetero", init, step, exact_k=False)


# ---------------------------------------------------------------------------
# Oldest-age top-k (Remark 1's centralized equivalent)
# ---------------------------------------------------------------------------


def make_oldest_age(n: int, k: int) -> Policy:
    def init(draws, n_=n):
        state = _base_state(n_, draws.device)
        # stagger initial ages so the first rounds aren't degenerate ties
        perm = draws.permutation("policy_init", n_)
        state["ages"] = (perm % max(2 * (n_ // max(k, 1)), 2)).to(torch.int32)
        return state

    def step(state, draws, layout=None):
        lay = whole(layout, n)
        # random tie-break: add sub-integer uniform noise to ages
        noise = lay.block(draws.uniform("select", (n,), 0.0, 0.5))
        score = state["ages"].to(torch.float32) + noise
        sel = lay.mask(lay.topk_idx(score, k))
        return sel, _advance(state, sel)

    return Policy("oldest_age", init, step, exact_k=True)


# ---------------------------------------------------------------------------
# Round robin (deterministic; Var[X]=0 when k divides n)
# ---------------------------------------------------------------------------


def make_round_robin(n: int, k: int) -> Policy:
    def init(draws, n_=n):
        return _base_state(n_, draws.device)

    def step(state, draws, layout=None):
        start = (state["round"] * k) % n
        idx = (start + torch.arange(k, device=start.device)) % n
        sel = whole(layout, n).mask(idx.long())
        return sel, _advance(state, sel)

    return Policy("round_robin", init, step, exact_k=True)


# ---------------------------------------------------------------------------
# Gumbel age-weighted top-k (beyond paper)
# ---------------------------------------------------------------------------


def make_gumbel_age(n: int, k: int, beta: float = 1.0) -> Policy:
    def init(draws, n_=n):
        return _base_state(n_, draws.device)

    def step(state, draws, layout=None):
        lay = whole(layout, n)
        g = lay.block(draws.gumbel("select", (n,)))
        score = beta * state["ages"].to(torch.float32) + g
        sel = lay.mask(lay.topk_idx(score, k))
        return sel, _advance(state, sel)

    return Policy(f"gumbel_age(beta={beta})", init, step, exact_k=True)


# ---------------------------------------------------------------------------


def _advance(state: Dict, sel: torch.Tensor) -> Dict:
    return {
        **state,
        "ages": age_update(state["ages"], sel),
        "round": state["round"] + 1,
    }


def make_policy(name: str, n: int, k: int, m: int = 10, **kw) -> Policy:
    """Construct any registered policy by name (dispatches through the
    ``repro_torch.engine`` registry)."""
    from repro_torch.engine.registry import make_policy as _dispatch

    return _dispatch(name, n, k, m, **kw)


def default_hetero_rates(n: int, k: int, rate_spread: float = 0.0) -> np.ndarray:
    """Per-client participation rates with mean ~k/n. ``rate_spread`` is the
    log-range of the spread (0 = uniform k/n)."""
    base = k / n
    if rate_spread == 0.0:
        return np.full(n, base)
    factors = np.exp(np.linspace(-rate_spread / 2, rate_spread / 2, n))
    return np.clip(base * factors, 1e-4, 1.0)


def simulate(policy: Policy, draws, n: int, rounds: int) -> np.ndarray:
    """Run a policy for ``rounds`` rounds; returns (rounds, n) bool history
    (step ``r`` draws from ``draws.step(r)``)."""
    state = policy.init(draws, n)
    hist = []
    for r in range(rounds):
        sel, state = policy.step(state, draws.step(r))
        hist.append(sel)
    return torch.stack(hist).cpu().numpy()


def simulate_stats(policy: Policy, draws, n: int, rounds: int,
                   expected_cohort: int = 0) -> dict:
    """Load statistics of a ``rounds``-round policy run through the
    device-resident selection accumulators, without materializing the
    (rounds, n) history; the same dict as
    ``empirical_load_stats(simulate(...))``."""
    state = policy.init(draws, n)
    acc = load_metric.init_selection_accum(n, expected_cohort, draws.device)
    for r in range(rounds):
        sel, state = policy.step(state, draws.step(r))
        acc = load_metric.update_selection_accum(acc, sel)
    return load_metric.selection_stats_from_accum(acc)


# ---------------------------------------------------------------------------
# Registry wiring: every policy is a named (n, k, m, **kw) -> Policy factory.
# ---------------------------------------------------------------------------

from repro_torch.engine import registry as _registry  # noqa: E402

_registry.register_policy("random")(lambda n, k, m=10: make_random(n, k))
_registry.register_policy("markov")(make_markov)
_registry.register_policy("markov_probs")(
    lambda n, k, m=10, probs=None, steady_start=True: make_markov(
        n, k, m, probs=probs, steady_start=steady_start
    )
)


@_registry.register_policy("markov_hetero")
def _make_markov_hetero_by_name(
    n: int, k: int, m: int = 10, rates=None, rate_spread: float = 0.0,
    steady_start: bool = True,
) -> Policy:
    if rates is None:
        rates = default_hetero_rates(n, k, rate_spread)
    return make_markov_hetero(rates, m, steady_start=steady_start)


_registry.register_policy("oldest_age")(lambda n, k, m=10: make_oldest_age(n, k))
_registry.register_policy("round_robin")(lambda n, k, m=10: make_round_robin(n, k))
_registry.register_policy("gumbel_age")(
    lambda n, k, m=10, beta=1.0: make_gumbel_age(n, k, beta=beta)
)

POLICY_NAMES = _registry.policy_names()
