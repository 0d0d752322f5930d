"""The paper's load metric X and its closed-form statistics.

X = number of rounds between subsequent selections of a client (= peak age).
The paper (Eq. 5-7) gives random selection's geometric law; Theorems 1-2 give
the optimal age-dependent Markov policy. This module implements every
closed form plus a numerically exact evaluator for *arbitrary* transition
probabilities via Eqs. (12)-(22), so theory can be cross-checked.

The closed forms and ``empirical_load_stats`` are plain numpy, copied from
the reference; the device accumulators below are torch, with the
reference's dtypes (int32 steps, float32 Kahan pairs).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Random selection (Eq. 5-7)
# ---------------------------------------------------------------------------


def random_selection_mean(n: int, k: int) -> float:
    """E[X] = n/k for uniform random selection of k of n clients."""
    return n / k


def random_selection_var(n: int, k: int) -> float:
    """Var[X] = n(n-k)/k^2 (Eq. 7)."""
    return n * (n - k) / k**2


# ---------------------------------------------------------------------------
# Markov policy: steady state + exact moments for arbitrary probs
# (Eqs. 8-22 of the paper)
# ---------------------------------------------------------------------------


def steady_state(probs: Sequence[float]) -> np.ndarray:
    """Stationary distribution pi_0..pi_m of the age chain (Eqs. 12-14)."""
    p = np.asarray(probs, dtype=np.float64)
    m = len(p) - 1
    if p[m] <= 0:
        raise ValueError("p_m must be > 0 for a recurrent chain")
    # unnormalized weights: w_0 = 1, w_i = prod_{j<i}(1-p_j) for i<m,
    # w_m = prod_{j<m}(1-p_j) / p_m
    w = np.ones(m + 1)
    for i in range(1, m + 1):
        w[i] = w[i - 1] * (1.0 - p[i - 1])
    w[m] = w[m] / p[m]
    return w / w.sum()


def selection_rate(probs: Sequence[float]) -> float:
    """Steady-state selection probability pi_0 = sum_i pi_i p_i = k/n (Eq. 8)."""
    return float(steady_state(probs)[0])


def markov_moments(probs: Sequence[float]) -> Tuple[float, float, float]:
    """(E[X], E[X^2], Var[X]) for the age chain, via Eqs. (15)-(22).

    E_i = expected rounds to return to state 0 starting the *next* round
    from state i; X is the return time from a selection (state 0).
    """
    p = np.asarray(probs, dtype=np.float64)
    m = len(p) - 1
    if p[m] <= 0:
        raise ValueError("p_m must be > 0")
    # E_i backward recursion: E_m = 1/p_m; E_i = 1 + (1-p_i) E_{i+1}
    E = np.zeros(m + 1)
    E[m] = 1.0 / p[m]
    for i in range(m - 1, -1, -1):
        E[i] = 1.0 + (1.0 - p[i]) * E[i + 1]
    # second moments S_i = E[X_i^2]: S_m = (2-p_m)/p_m^2;
    # S_i = 1 + (1-p_i)(2 E_{i+1} + S_{i+1})
    S = np.zeros(m + 1)
    S[m] = (2.0 - p[m]) / p[m] ** 2
    for i in range(m - 1, -1, -1):
        S[i] = 1.0 + (1.0 - p[i]) * (2.0 * E[i + 1] + S[i + 1])
    ex, ex2 = float(E[0]), float(S[0])
    return ex, ex2, ex2 - ex * ex


def markov_var(probs: Sequence[float]) -> float:
    return markov_moments(probs)[2]


# ---------------------------------------------------------------------------
# Optimal policy (Theorems 1-2)
# ---------------------------------------------------------------------------


def optimal_probs_for_mean(mean_gap: float, m: int) -> np.ndarray:
    """Optimal p_0..p_m for a target E[X] = mean_gap (Theorem 2 with
    n/k := mean_gap). Enables per-client heterogeneous selection rates."""
    if mean_gap < 1.0:
        raise ValueError("mean gap must be >= 1 round")
    if m < 1:
        raise ValueError("need m >= 1")
    r = float(mean_gap)
    i = math.floor(r)
    p = np.zeros(m + 1)
    if m <= i - 1:
        p[m] = 1.0 / (r - m)
    else:
        # note: if r is an integer, p_{i-1} = i+1-r = 1 and the policy is
        # deterministic "send exactly every r rounds" (Var = 0).
        if i >= 1:
            p[i - 1] = (i + 1) - r
        p[i:] = 1.0
    return p


def optimal_probs(n: int, k: int, m: int) -> np.ndarray:
    """Optimal transition probabilities p_0..p_m (Theorem 2).

    - m <= floor(n/k) - 1:  p* = [0,...,0, 1/(n/k - m)]
    - m >= floor(n/k):      with i = floor(n/k),
      p* = [0,...,0, (i+1) - n/k at index i-1, 1,...,1]
    """
    if not (0 < k <= n):
        raise ValueError("need 0 < k <= n")
    return optimal_probs_for_mean(n / k, m)


def optimal_var_for_mean(mean_gap: float, m: int) -> float:
    r = float(mean_gap)
    i = math.floor(r)
    if m <= i - 1:
        return (r - m) * (r - (m + 1))
    c = r - i
    return c * (1.0 - c)


def optimal_var(n: int, k: int, m: int) -> float:
    """Minimum Var[X] (Theorem 2 / Remark 2)."""
    return optimal_var_for_mean(n / k, m)


def theorem1_var(n: int, k: int, p0: float, p1: float) -> float:
    """Var[X] for m=1 as a function of (p0, p1) (Theorem 1)."""
    if p1 <= 0:
        raise ValueError("p1 must be > 0")
    return (1.0 + p0 - p1) * (1.0 - p0) / p1**2


def theorem1_optimal(n: int, k: int) -> Tuple[np.ndarray, float]:
    """Optimal (p0, p1) and Var for m=1 (Theorem 1)."""
    if 2 * k <= n:
        p = np.array([0.0, k / (n - k)])
        v = (n - k) * (n - 2 * k) / k**2
    else:
        p = np.array([(2 * k - n) / k, 1.0])
        v = (n - k) * (2 * k - n) / k**2
    return p, v


# ---------------------------------------------------------------------------
# Empirical estimation from selection histories
# ---------------------------------------------------------------------------


def peak_ages_from_history(history: np.ndarray) -> np.ndarray:
    """Extract all inter-selection gaps X from a (T, n) 0/1 selection matrix.

    Gaps are measured between consecutive selections of the same client
    (the first selection of each client opens its window and produces no
    sample, matching the paper's steady-state X).
    """
    history = np.asarray(history, dtype=bool)
    gaps = []
    T, n = history.shape
    for c in range(n):
        rounds = np.flatnonzero(history[:, c])
        if len(rounds) >= 2:
            gaps.append(np.diff(rounds))
    if not gaps:
        return np.zeros((0,), dtype=np.int64)
    return np.concatenate(gaps)


def empirical_load_stats(history: np.ndarray) -> dict:
    """Mean/var of X plus cohort-size statistics from a selection history."""
    gaps = peak_ages_from_history(history)
    sizes = np.asarray(history, dtype=np.int64).sum(axis=1)
    return {
        "num_samples": int(gaps.size),
        "mean_X": float(gaps.mean()) if gaps.size else float("nan"),
        "var_X": float(gaps.var()) if gaps.size else float("nan"),
        "mean_cohort": float(sizes.mean()),
        "std_cohort": float(sizes.std()),
        "min_cohort": int(sizes.min()),
        "max_cohort": int(sizes.max()),
    }


# ---------------------------------------------------------------------------
# Device-resident sufficient statistics for the same quantities
# ---------------------------------------------------------------------------
#
# The accumulators replace the materialized (rounds, n) selection matrix in
# the engine's hot loop: per-client last-selection step plus streaming
# first/second moments of the inter-selection gaps X and of the cohort
# sizes — enough to evaluate ``empirical_load_stats`` without ever pulling
# an (n,)-vector to the host. ``update_selection_accum`` stays on the
# tensors' device; ``selection_stats_from_accum`` runs on host floats at
# finalize time. Like ``peak_ages_from_history``, a client's first
# selection only opens its gap window (no X sample).
#
# The scalar moments are Kahan-compensated float32 pairs, as in the
# reference: a plain float32 sum loses the billions-of-samples counts a
# fleet-scale run produces (float32 stops representing consecutive
# integers at 2^24), and the compensated pair keeps the sequential
# accumulation error at O(eps).

_MOMENTS = ("gap_sum", "gap_sumsq", "gap_cnt", "size_sum", "size_sumsq")


def _kahan_add(sum_, comp, x):
    y = x - comp
    t = sum_ + y
    return t, (t - sum_) - y


def scatter_targets(idx, n: int):
    """JAX's index rules for a gather and a ``mode="drop"`` scatter over an
    axis of length ``n``: a negative index wraps once (``-1`` is ``n - 1``);
    then a gather clamps what is still out of range, and a scatter drops it.
    Returns ``(gather index, in-range mask)``."""
    import torch

    j = torch.where(idx < 0, idx + n, idx)
    return torch.clamp(j, 0, n - 1), (j >= 0) & (j < n)


def ewma_scatter_update(vec, idx, values, mask, alpha, layout=None):
    """Masked scatter-EWMA over an (n,) per-client statistic.

    ``vec[idx[j]] <- (1 - alpha) * vec[idx[j]] + alpha * values[j]`` for
    every slot with ``mask[j]``; other slots (padding, failed cohort
    members) add an exact 0.0, and a slot whose index is out of range
    writes nothing (it adds -0.0, the exact identity, at a clamped
    target), so an all-False mask is bitwise identity. Duplicate masked-in
    slots each add their step, as the reference's ``.at[].add`` does. The
    add is ``index_add_``: on the card it adds with atomics, which is exact
    in any order when each target gets at most one nonzero term — the
    engines' case (a step's valid clients are distinct). Under a sharded
    ``layout`` (``core.fleet``) ``vec`` is this rank's block, the indices
    are global, the current values come through the layout's gather and
    only the owner adds.
    """
    import torch

    from repro_torch.core.fleet import whole

    lay = whole(layout, vec.shape[0])
    g, inb = scatter_targets(idx, lay.n)
    delta = torch.where(mask, alpha * (values - lay.gather(vec, g)),
                        0.0).to(vec.dtype)
    delta = torch.where(inb, delta, -0.0)
    return lay.index_add(vec, g, delta)


def ewma_scatter_update_rows(mat, idx, rows, mask, alpha, layout=None):
    """Row-wise :func:`ewma_scatter_update` over an (n, d) per-client matrix:
    ``mat[idx[j]] <- (1 - alpha) * mat[idx[j]] + alpha * rows[j]`` for every
    slot with ``mask[j]``, under the same index, exactness and layout
    rules."""
    import torch

    from repro_torch.core.fleet import whole

    lay = whole(layout, mat.shape[0])
    g, inb = scatter_targets(idx, lay.n)
    delta = torch.where(mask[:, None], alpha * (rows - lay.gather(mat, g)),
                        0.0).to(mat.dtype)
    delta = torch.where(inb[:, None], delta, -0.0)
    return lay.index_add(mat, g, delta)


def init_selection_accum(n: int, expected_cohort: int = 0, device="cpu"):
    """Fresh accumulator dict for an ``n``-client fleet on ``device``.

    ``expected_cohort`` (the configured k) centers the cohort-size
    moments: sizes are accumulated as exact integer deviations from it, so
    ``size_sumsq`` stays O(steps * Var[size]) instead of O(steps * k^2).
    """
    import torch

    def z():
        return torch.zeros((), dtype=torch.float32, device=device)

    acc = {
        "last_sel": torch.full((n,), -1, dtype=torch.int32, device=device),
        "size_shift": torch.full((), expected_cohort, dtype=torch.int32,
                                 device=device),
        "size_min": torch.full((), np.iinfo(np.int32).max, dtype=torch.int32,
                               device=device),
        "size_max": torch.zeros((), dtype=torch.int32, device=device),
        "steps": torch.zeros((), dtype=torch.int32, device=device),
    }
    for name in _MOMENTS:
        acc[name] = z()
        acc["c_" + name] = z()  # Kahan compensation
    return acc


def update_selection_accum(acc, selected, layout=None):
    """Fold one round's (n,) bool selection vector into the accumulator
    (this rank's block of it under a sharded ``layout``, whose block sums
    are summed over ranks: exact, they are integer-valued)."""
    import torch

    from repro_torch.core.fleet import whole

    psum = whole(layout, selected.shape[0]).psum
    r = acc["steps"]
    has_gap = selected & (acc["last_sel"] >= 0)
    gap = torch.where(has_gap, r - acc["last_sel"], 0).to(torch.float32)
    size = psum(torch.sum(selected.to(torch.int32), dtype=torch.int32))
    dev = (size - acc["size_shift"]).to(torch.float32)
    out = {
        "last_sel": torch.where(selected, r, acc["last_sel"]),
        "size_shift": acc["size_shift"],
        "size_min": torch.minimum(acc["size_min"], size),
        "size_max": torch.maximum(acc["size_max"], size),
        "steps": r + 1,
    }
    increments = {
        "gap_sum": psum(torch.sum(gap)),
        "gap_sumsq": psum(torch.sum(gap * gap)),
        "gap_cnt": psum(torch.sum(has_gap.to(torch.float32))),
        "size_sum": dev,
        "size_sumsq": dev * dev,
    }
    for name, inc in increments.items():
        out[name], out["c_" + name] = _kahan_add(
            acc[name], acc["c_" + name], inc
        )
    return out


def selection_stats_from_accum(acc) -> dict:
    """``empirical_load_stats``-shaped dict from a selection accumulator."""
    # resolve each compensated pair in float64 on the host
    a = {name: float(acc[name]) - float(acc["c_" + name]) for name in _MOMENTS}
    steps = int(acc["steps"])
    cnt = a["gap_cnt"]
    if cnt > 0:
        mean_x = a["gap_sum"] / cnt
        var_x = max(a["gap_sumsq"] / cnt - mean_x * mean_x, 0.0)
    else:
        mean_x = var_x = float("nan")
    if steps > 0:
        mean_dev = a["size_sum"] / steps
        mean_c = float(acc["size_shift"]) + mean_dev
        var_c = max(a["size_sumsq"] / steps - mean_dev * mean_dev, 0.0)
        min_c, max_c = int(acc["size_min"]), int(acc["size_max"])
    else:
        mean_c = var_c = float("nan")
        min_c = max_c = 0
    return {
        "num_samples": int(cnt),
        "mean_X": mean_x,
        "var_X": var_x,
        "mean_cohort": mean_c,
        "std_cohort": math.sqrt(var_c) if steps > 0 else float("nan"),
        "min_cohort": min_c,
        "max_cohort": max_c,
    }


# ---------------------------------------------------------------------------
# Per-tier accumulators: the same X moments, grouped by aggregation node
# ---------------------------------------------------------------------------
#
# Under a multi-tier topology (repro_torch.topo) the fleet-wide Var[X] hides
# imbalance between tiers. The grouped accumulator keeps the selection-gap
# moments per tier-0 node, (E,) vectors instead of scalars, with the same
# Kahan compensation. The reference segment-sums the (n,) increments into
# (E,); here the client -> node map (``Topology.assign``) is static and
# contiguous, so each node's clients are one block of the fleet and the
# segment sum is a gather into an (E, block) table summed on its rows in a
# fixed order: no atomics, so runs repeat bitwise (the f32 sum of squared
# gaps is order-exact only below 2^24).

_TIER_MOMENTS = ("gap_sum", "gap_sumsq", "gap_cnt")


def tier_blocks(group_of_client, device="cpu", num_groups=None):
    """The (E, L) gather table of a contiguous client -> node map: row ``e``
    lists node ``e``'s clients in order, padded with ``n`` (an index past
    the fleet that ``block_sums`` points at a zero). ``num_groups`` fixes E
    (a rank's block of the map need not reach the last nodes)."""
    import torch

    g = np.asarray(group_of_client)
    n = g.shape[0]
    e = int(g.max()) + 1 if n else 0
    if num_groups is not None:
        e = int(num_groups)
    if np.any(np.diff(g) < 0):
        raise ValueError("tier_blocks needs a contiguous (non-decreasing) map")
    starts = np.searchsorted(g, np.arange(e), side="left")
    ends = np.searchsorted(g, np.arange(e), side="right")
    width = int((ends - starts).max()) if e else 0
    table = np.full((e, width), n, np.int64)
    for i, (s, t) in enumerate(zip(starts, ends)):
        table[i, :t - s] = np.arange(s, t)
    return torch.as_tensor(table, device=device)


def block_sums(values, table):
    """(E,) per-node sums of the (n,) ``values`` over ``tier_blocks``'s
    table, each a fixed-order row sum."""
    import torch

    padded = torch.cat([values, values.new_zeros((1,))])
    return padded[table].sum(dim=1)


def init_tier_accum(n: int, n_groups: int, device="cpu"):
    """Fresh per-tier gap accumulator: ``n`` clients over ``n_groups``
    tier-0 aggregation nodes."""
    import torch

    acc = {
        "last_sel": torch.full((n,), -1, dtype=torch.int32, device=device),
        "steps": torch.zeros((), dtype=torch.int32, device=device),
    }
    for name in _TIER_MOMENTS:
        acc[name] = torch.zeros((n_groups,), dtype=torch.float32, device=device)
        acc["c_" + name] = torch.zeros((n_groups,), dtype=torch.float32,
                                       device=device)
    return acc


def update_tier_accum(acc, selected, blocks, layout=None):
    """Fold one round's (n,) bool selection into the per-tier moments;
    ``blocks`` is ``tier_blocks(Topology.assign(n))`` on the fleet's
    device. Under a sharded ``layout`` ``selected`` is this rank's block,
    ``blocks`` the table of the block's map (``num_groups`` = E), and the
    per-node sums are summed over ranks (exact: integer-valued)."""
    import torch

    from repro_torch.core.fleet import whole

    psum = whole(layout, selected.shape[0]).psum
    r = acc["steps"]
    has_gap = selected & (acc["last_sel"] >= 0)
    gap = torch.where(has_gap, r - acc["last_sel"], 0).to(torch.float32)
    increments = {
        "gap_sum": psum(block_sums(gap, blocks)),
        "gap_sumsq": psum(block_sums(gap * gap, blocks)),
        "gap_cnt": psum(block_sums(has_gap.to(torch.float32), blocks)),
    }
    out = {
        "last_sel": torch.where(selected, r, acc["last_sel"]),
        "steps": r + 1,
    }
    for name, inc in increments.items():
        out[name], out["c_" + name] = _kahan_add(
            acc[name], acc["c_" + name], inc
        )
    return out


def tier_stats_from_accum(acc) -> dict:
    """Per-tier-node mean/var of X as plain lists (JSON-safe), NaN where
    a node has no gap samples yet."""
    a = {
        name: np.asarray(acc[name].cpu(), np.float64)
        - np.asarray(acc["c_" + name].cpu(), np.float64)
        for name in _TIER_MOMENTS
    }
    cnt = a["gap_cnt"]
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.where(cnt > 0, a["gap_sum"] / cnt, np.nan)
        var = np.where(
            cnt > 0,
            np.maximum(a["gap_sumsq"] / np.maximum(cnt, 1.0) - mean * mean, 0.0),
            np.nan,
        )
    return {
        "tier_num_samples": [int(c) for c in cnt],
        "tier_mean_X": [float(v) for v in mean],
        "tier_var_X": [float(v) for v in var],
    }


# ---------------------------------------------------------------------------
# Per-replica accumulators: the serving tier's load metric
# ---------------------------------------------------------------------------
#
# The serving tier (repro_torch.serve) applies the same Var[X] argument to
# inference replicas: X = number of routing decisions between subsequent
# assignments of a replica (one decision = one epoch of the age chain, so
# the paper's closed forms for n := replicas, k := 1 apply verbatim). It is
# the tier accumulator under the identity grouping, each replica its own
# node: the per-replica moments are (R,) vectors under the same Kahan
# compensation, and the fleet-wide moments are their sums.


def init_replica_accum(n_replicas: int, device="cpu"):
    """Fresh per-replica assignment-gap accumulator for ``n_replicas``
    serving replicas (one node per replica; identity grouping)."""
    return init_tier_accum(n_replicas, n_replicas, device)


def update_replica_accum(acc, assigned):
    """Fold one routing decision's (R,) bool assignment vector into the
    accumulator (all-False advances the epoch without a sample: a rejected
    admission still ages every replica's chain). The identity grouping's
    table is (R, 1), row ``r`` holding replica ``r``."""
    import torch

    r = assigned.shape[0]
    blocks = torch.arange(r, device=assigned.device)[:, None]
    return update_tier_accum(acc, assigned, blocks)


def replica_stats_from_accum(acc) -> dict:
    """``serve_stats``: fleet-wide mean/Var of the replica assignment gap
    X (from the summed per-replica moments) plus the per-replica
    breakdown, with the reference's keys."""
    a = {
        name: np.asarray(acc[name].cpu(), np.float64)
        - np.asarray(acc["c_" + name].cpu(), np.float64)
        for name in _TIER_MOMENTS
    }
    cnt = float(a["gap_cnt"].sum())
    if cnt > 0:
        mean = float(a["gap_sum"].sum()) / cnt
        var = max(float(a["gap_sumsq"].sum()) / cnt - mean * mean, 0.0)
    else:
        mean = var = float("nan")
    per = tier_stats_from_accum(acc)
    return {
        "num_samples": int(cnt),
        "mean_X": mean,
        "var_X": var,
        "decisions": int(acc["steps"]),
        "replica_num_samples": per["tier_num_samples"],
        "replica_mean_X": per["tier_mean_X"],
        "replica_var_X": per["tier_var_X"],
    }
