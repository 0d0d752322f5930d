"""Adaptive / dropout-robust Markov policies (paper Remark 1 + Conclusion).

Copied from ``repro.core.adaptive`` (plain numpy), so the port keeps its
own copy; ``tests/test_torch_adaptive.py`` holds it to the reference.

The optimal chain of Theorem 2 sets p_i = 0 below the threshold age: a
client is *never* selected early. Remark 1 observes that with client
dropout one may want p_i > 0 everywhere, trading a little Var[X] for a
chance to collect an update before the client leaves. This module builds
the blended family

    p(eps, c) = clip((1 - eps) * p_opt + eps * c, 0, 1),   p_m kept > 0,

solving the scalar c by bisection so the steady-state selection rate stays
exactly k/n (constraint (8) — the same fairness constraint as the paper),
and quantifies the trade-off: Var[X] (load balance) vs the probability
that a client is selected at least once before dropping out.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from repro_torch.core import load_metric as lm


def floored_probs(n: int, k: int, m: int, eps: float) -> np.ndarray:
    """Blend of the optimal policy with a uniform floor, rate-corrected.

    eps = 0 -> Theorem 2 optimum; eps = 1 -> age-independent Bernoulli
    (geometric X, random-selection statistics).
    """
    if not 0.0 <= eps <= 1.0:
        raise ValueError("eps in [0,1]")
    p_opt = lm.optimal_probs(n, k, m)
    target = k / n
    lo, hi = 0.0, 1.0

    def rate(c: float) -> float:
        p = np.clip((1 - eps) * p_opt + eps * c, 0.0, 1.0)
        p[m] = max(p[m], 1e-6)
        return lm.selection_rate(p)

    # rate(c) is monotone increasing in c
    if rate(lo) > target:
        c = lo
    elif rate(hi) < target:
        c = hi
    else:
        for _ in range(80):
            mid = (lo + hi) / 2
            if rate(mid) < target:
                lo = mid
            else:
                hi = mid
        c = (lo + hi) / 2
    p = np.clip((1 - eps) * p_opt + eps * c, 0.0, 1.0)
    p[m] = max(p[m], 1e-6)
    return p


def dropout_update_probability(probs: np.ndarray, d: float) -> float:
    """P(a fresh client is selected at least once before dropping out),
    with i.i.d. per-round dropout probability d.

    Closed form over the age chain: starting at state 0, each round the
    client survives w.p. (1-d) and is then selected w.p. p_state.
    """
    m = len(probs) - 1
    # f_i = P(eventually selected before dropout | current state i)
    # f_i = (1-d) * (p_i + (1-p_i) f_{i+1}), f at state m self-loops:
    # f_m = (1-d) p_m / (1 - (1-d)(1-p_m))
    p = np.asarray(probs, dtype=np.float64)
    fm = (1 - d) * p[m] / (1 - (1 - d) * (1 - p[m]))
    f = fm
    for i in range(m - 1, -1, -1):
        f = (1 - d) * (p[i] + (1 - p[i]) * f)
    return float(f)


def tradeoff_curve(
    n: int, k: int, m: int, d: float, eps_grid=None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(eps, Var[X], P(update before dropout)) along the blend family."""
    if eps_grid is None:
        eps_grid = np.linspace(0.0, 1.0, 11)
    var = np.array([lm.markov_var(floored_probs(n, k, m, e)) for e in eps_grid])
    pup = np.array(
        [dropout_update_probability(floored_probs(n, k, m, e), d) for e in eps_grid]
    )
    return np.asarray(eps_grid), var, pup
