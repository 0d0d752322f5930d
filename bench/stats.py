"""Arithmetic the harness and the metric readers share: the 95th
percentile, the union of device intervals, idle gaps, and the gaps that
decide ``correct``. Pure Python, no program import."""
from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of ``values``: the nearest-rank value, so it is
    always one of the samples (and at least 5% of them lie at or above it)."""
    vals = sorted(values)
    if not vals:
        raise ValueError("p95 of no values")
    rank = math.ceil(0.95 * len(vals))
    return vals[rank - 1]


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """Each interval cut to ``[lo, hi]``; those outside dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union: time with at least one interval open."""
    return sum(e - s for s, e in merge(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def worst_leaf_gap(prog_norms: Sequence[float], ref_norms: Sequence[float],
                   keep: Sequence[bool] = None) -> float:
    """The worst leaf's gap between two norms: ``|a - b|`` over the larger
    of the reference's norm of that leaf and of the median leaf. Leaves
    with ``keep`` false are left out."""
    idx = [i for i in range(len(ref_norms)) if keep is None or keep[i]]
    if not idx:
        raise ValueError("no leaf to compare")
    med = statistics.median(ref_norms[i] for i in idx)
    worst = 0.0
    for i in idx:
        a, b = float(prog_norms[i]), float(ref_norms[i])
        if not (math.isfinite(a) and math.isfinite(b)):
            return math.inf
        den = max(b, med)
        worst = max(worst, abs(a - b) / den if den > 0 else (0.0 if a == b else math.inf))
    return worst


def rel_gap(a: float, b: float) -> float:
    """``|a - b| / |b|`` (inf where ``a`` is not finite)."""
    a, b = float(a), float(b)
    if not math.isfinite(a):
        return math.inf
    return abs(a - b) / abs(b) if b else abs(a - b)
