"""Moving-target aggregation: rotate the robust rule online.

The port of ``repro.defense.adaptive``. ``adaptive_aggregate`` wraps the
engines' aggregate hook. Level 0 on the mtd ladder is the configured base
rule, untouched (its params come back as the base rule returned them);
level L >= 1 swaps in a robust rule. The reference picks the rung inside
its jitted step with ``lax.cond``/``lax.switch``; here the level is a
Python int the engine reads from the device once per closed mtd window
(``Defense.step_level``), so each step computes the base rule and, above
level 0, only the rung it takes — no rung is evaluated and thrown away,
and no step but a window's last reads the device.

Two ladder shapes. The default (``mtd_families=None``) walks trim
fractions of one rule: a trimmed mean at ``mtd_trims[level]``. With
``mtd_families`` the rungs rotate across aggregator *families*:

  * ``base``              — the engine's configured rule, untouched
  * ``trimmed_mean``      — static per-rung trim from ``mtd_trims``
  * ``coordinate_median`` — parameter-free, maximum breakdown
  * ``norm_clip``         — per-slot L2 clip at the cohort's *median*
                            delta norm; its clipped weighted sum
                            ``sum_c d_c * w_c * scale_c`` is K1's function,
                            one ``fedavg_reduce_leaves`` call

The order-statistic rungs share ``engine/robust.py``'s sort and
reductions. All rungs are non-additive over the cohort axis, so config
rejects mtd under tiered topologies, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map, tree_paths
from repro_torch.defense.stats import masked_median, median_ranks
from repro_torch.engine.aggregators import cohort_reduce
from repro_torch.engine.robust import (
    median_sorted,
    sorted_valid_deltas,
    trimmed_mean_sorted,
)


def tree_where(cond, a, b):
    """Leaf-wise ``torch.where(cond, a, b)`` over two trees."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


def _trimmed_mean_delta(g, updates, bases, w, trim):
    """g + per-coordinate trimmed mean of valid deltas."""
    valid = w > 0
    c = valid.to(torch.int32).sum()

    def one(gl, u, b):
        mean = trimmed_mean_sorted(*sorted_valid_deltas(u, b, valid), c, trim)
        return (gl + mean.to(gl.dtype)).to(gl.dtype)

    moved = tree_map(one, g, updates, bases)
    return tree_where(c > 0, moved, g)  # empty cohort: params stand


def _coordinate_median_delta(g, updates, bases, w):
    """g + per-coordinate median of valid deltas — the lo/hi sorted-rank
    pick of ``engine.robust.make_coordinate_median``."""
    valid = w > 0
    c = valid.to(torch.int32).sum()

    def one(gl, u, b):
        med = median_sorted(*sorted_valid_deltas(u, b, valid), c)
        return (gl + med.to(gl.dtype)).to(gl.dtype)

    moved = tree_map(one, g, updates, bases)
    return tree_where(c > 0, moved, g)


def _norm_clip_delta(g, updates, bases, w):
    """g + weighted mean of deltas L2-clipped at the cohort's *median*
    delta norm — ``engine.robust.make_norm_clip`` arithmetic with the
    static clip replaced by a per-cohort order statistic. The clipped sum
    is one K1 call over the tree."""
    valid = w > 0
    c, lo, hi = median_ranks(valid)
    deltas = tree_map(lambda u, b: (u - b).to(torch.float32), updates, bases)
    sq = sum(torch.sum(d.reshape(d.shape[0], -1) * d.reshape(d.shape[0], -1), dim=1)
             for _, d in tree_paths(deltas))
    norm = torch.sqrt(sq)
    clip = masked_median(norm, valid, c, lo, hi)
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    ws = w * scale
    wsum = w.sum()
    denom = torch.clamp(wsum, min=1e-9)
    moved = tree_map(lambda gl, ds: (gl + (ds / denom).to(gl.dtype)).to(gl.dtype),
                     g, cohort_reduce(deltas, ws))
    return tree_where(wsum > 0, moved, g)


def _family_branch(fam, trim):
    """One rung: (g, updates, bases, w, base_params) -> params. ``trim`` is
    static per rung (read from ``mtd_trims``)."""
    if fam == "base":
        return lambda g, u, b, w, bp: bp
    if fam == "trimmed_mean":
        return lambda g, u, b, w, bp: _trimmed_mean_delta(g, u, b, w, trim)
    if fam == "coordinate_median":
        return lambda g, u, b, w, bp: _coordinate_median_delta(g, u, b, w)
    if fam == "norm_clip":
        return lambda g, u, b, w, bp: _norm_clip_delta(g, u, b, w)
    raise ValueError(f"unknown mtd family {fam!r}")  # config validated


def adaptive_aggregate(base_apply, trims, families=None):
    """Wrap an engine aggregate hook with the mtd ladder.

    Returns ``apply(g, updates, bases, w, idx, level)`` with ``level`` a
    Python int; the base rule's stats are surfaced whatever the level, so
    counters like ``agg_clipped`` keep their meaning while the ladder is
    hot. ``families`` (validated upstream: same length as ``trims``, entry
    0 ``"base"``) switches the ladder from trim fractions to aggregator
    families; level 0 passes the base rule's params through untouched
    either way, and a level out of range takes the nearest rung.
    """
    trims = tuple(float(t) for t in trims)
    top = len(trims) - 1

    if families is None:
        def apply(g, updates, bases, w, idx, level):
            base_params, stats = base_apply(g, updates, bases, w, idx)
            if level > 0:
                trim = trims[min(level, top)]
                return _trimmed_mean_delta(g, updates, bases, w, trim), stats
            return base_params, stats

        return apply

    branches = [_family_branch(f, t) for f, t in zip(families, trims)]

    def apply(g, updates, bases, w, idx, level):
        base_params, stats = base_apply(g, updates, bases, w, idx)
        rung = branches[min(max(level, 0), len(branches) - 1)]
        return rung(g, updates, bases, w, base_params), stats

    return apply
