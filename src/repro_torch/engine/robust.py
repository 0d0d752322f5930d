"""Robust aggregation: registry entries that survive corrupted updates.

The port of ``repro.engine.robust``. Plain (weighted-)mean aggregation has
breakdown point zero — one sign-flipped or 10x-scaled delta moves the
global params arbitrarily far. These aggregators bound that influence:

  * ``norm_clip`` — per-slot L2 clipping of the delta *before* the
    staleness-weighted mean. Clipping is per-slot, so the accumulator is
    still a plain sum (``additive=True``), and that sum
    ``sum_c w_c * scale_c * d_c`` over the f32 delta stack is exactly K1's
    function: one ``fedavg_reduce_leaves`` call (one CUDA launch for the
    tree on the GPU), and its node form under a topology is the same call
    on K1's segmented route. Carries a ``clipped`` counter in
    ``acc["stats"]`` (surfaced as ``agg_clipped``).
  * ``trimmed_mean`` — coordinate-wise trimmed mean of the deltas: the
    ``trim`` fraction of highest and lowest values per coordinate is
    discarded. Order statistics do not sum, so ``additive=False``.
  * ``coordinate_median`` — coordinate-wise median of the deltas, the
    trim -> 50% limit; maximum breakdown, non-additive like above.

The order statistics sort the cohort axis with ``torch.sort`` (the
reference sorts with ``jnp.sort``, outside any Pallas kernel), invalid
slots pushed to ``+inf``; the valid count stays on the device. The sort
and the two reductions (``sorted_valid_deltas``, ``trimmed_mean_sorted``,
``median_sorted``) also serve the moving-target ladder's order-statistic
rungs (``defense/adaptive.py``). All three
are delta aggregators (``finalize`` adds the robust mean delta to the
global params); ``trimmed_mean``/``coordinate_median`` treat weights as
validity only (order statistics are unweighted — counted per slot in the
``agg_unweighted`` stat and enforced by rejecting staleness kwargs), while
``norm_clip`` keeps fedbuff's staleness weighting.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map, tree_paths
from repro_torch.engine.aggregators import (
    Aggregator,
    cohort_reduce,
    node_sums,
    staleness_weight,
)
from repro_torch.engine.registry import register_aggregator


def _f32_zeros_like(g):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), g)


def _zero(g) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=tree_paths(g)[0][1].device)


@register_aggregator("norm_clip")
def make_norm_clip(clip: float = 10.0, staleness_mode: str = "poly",
                   staleness_exp: float = 0.5) -> Aggregator:
    """Per-slot L2 norm clipping of deltas, then the staleness-weighted
    mean: a slot whose delta exceeds ``clip`` is scaled down onto the
    ball, so a scaled-update attacker contributes at most a unit-norm
    vote. Additive — per-slot clipping commutes with the sum."""
    if clip <= 0:
        raise ValueError(f"norm_clip: clip must be > 0, got {clip}")

    def weigh(mask, staleness):
        return mask.to(torch.float32) * staleness_weight(
            staleness, staleness_mode, staleness_exp
        )

    def init(g):
        return {"dsum": _f32_zeros_like(g), "wsum": _zero(g),
                "stats": {"clipped": _zero(g)}}

    def clipped_deltas(updates, bases, w):
        """The f32 deltas, the clipped weights ``w * scale`` and the
        per-slot clip indicator."""
        deltas = tree_map(lambda u, b: (u - b).to(torch.float32), updates, bases)
        # per-slot global L2 over the whole delta tree, leaves summed in the
        # reference's order
        sq = sum(torch.sum(d * d, dim=tuple(range(1, d.dim())))
                 for _, d in tree_paths(deltas))
        norm = torch.sqrt(sq)
        scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
        return deltas, w * scale, ((norm > clip) & (w > 0)).to(torch.float32)

    def accumulate(acc, updates, bases, w):
        deltas, ws, hit = clipped_deltas(updates, bases, w)
        # the clipped weighted delta sums of all leaves: one K1 call
        dsum = tree_map(torch.add, acc["dsum"], cohort_reduce(deltas, ws))
        clipped = acc["stats"]["clipped"] + torch.sum(hit)
        return {"dsum": dsum, "wsum": acc["wsum"] + w.sum(),
                "stats": {"clipped": clipped}}

    def accumulate_nodes(g, updates, bases, w, seg, num_nodes):
        deltas, ws, hit = clipped_deltas(updates, bases, w)
        return {"dsum": cohort_reduce(deltas, ws, seg, num_nodes),
                "wsum": node_sums(w, seg, num_nodes),
                "stats": {"clipped": node_sums(hit, seg, num_nodes)}}

    def finalize(g, acc):
        has = acc["wsum"] > 0
        denom = torch.clamp(acc["wsum"], min=1e-9)
        return tree_map(
            lambda gl, s: torch.where(has, gl + (s / denom).to(gl.dtype), gl),
            g, acc["dsum"])

    return Aggregator("norm_clip", weigh, init, accumulate, finalize,
                      additive=True, stat_names=("clipped",),
                      accumulate_nodes=accumulate_nodes)


def sorted_valid_deltas(u, b, valid):
    """The f32 deltas ``u - b`` of one leaf sorted over the cohort axis, the
    invalid slots pushed to ``+inf`` at the top, and the rank of each row
    (shaped to broadcast against them)."""
    ws = (-1,) + (1,) * (u.dim() - 1)
    d = torch.where(valid.view(ws), (u - b).to(torch.float32), torch.inf)
    d_sorted = torch.sort(d, dim=0, stable=True).values
    ranks = torch.arange(d.shape[0], device=d.device).view(ws)
    return d_sorted, ranks


def trimmed_mean_sorted(d_sorted, ranks, c, trim):
    """Mean of the ``c`` valid sorted values without the ``floor(c * trim)``
    lowest and highest (at most ``(c - 1) // 2`` each side)."""
    t = torch.floor(c.to(torch.float32) * trim).to(c.dtype)
    t = torch.minimum(torch.clamp(t, min=0), torch.clamp((c - 1) // 2, min=0))
    keep = (ranks >= t) & (ranks < c - t)
    kept = torch.where(keep, d_sorted, 0.0)
    return kept.sum(dim=0) / torch.clamp(c - 2 * t, min=1)


def median_sorted(d_sorted, ranks, c):
    """Median of the ``c`` valid sorted values (0.0 when ``c`` is 0)."""
    lo = torch.clamp((c - 1) // 2, min=0)
    hi = torch.clamp(c // 2, min=0)
    pick = torch.where(c > 0, (ranks == lo).to(torch.float32)
                       + (ranks == hi).to(torch.float32), 0.0)
    # lo == hi for odd c: pick sums to 2 either way, so /2 is the
    # median (odd) or the midpoint of the two middle values (even);
    # the other terms are exact zeros, so any summation order gives
    # the reference's bits
    return torch.where(
        c > 0, torch.sum(torch.where(pick > 0, d_sorted * pick, 0.0),
                         dim=0) / 2.0, 0.0)


def _order_stat_aggregator(name: str, reduce_sorted) -> Aggregator:
    """Shared chassis of the order-statistic aggregators: per-coordinate
    sort of the valid deltas (invalid slots pushed to +inf at the top),
    then ``reduce_sorted(d_sorted, ranks, c)`` picks the robust center.
    Non-additive by construction."""

    def weigh(mask, staleness):
        # validity only: order statistics are unweighted
        return mask.to(torch.float32)

    def init(g):
        return {"delta": _f32_zeros_like(g), "count": _zero(g),
                "stats": {"unweighted": _zero(g)}}

    def accumulate(acc, updates, bases, w):
        valid = w > 0
        c = valid.to(torch.int32).sum()  # stays on the device

        delta = tree_map(lambda u, b: reduce_sorted(*sorted_valid_deltas(u, b, valid), c),
                         updates, bases)
        cf = c.to(torch.float32)
        return {
            "delta": tree_map(torch.add, acc["delta"], delta),
            "count": acc["count"] + cf,
            # every slot that entered an order-stat reduction did so with
            # its staleness weight ignored — surfaced as agg_unweighted
            "stats": {"unweighted": acc["stats"]["unweighted"] + cf},
        }

    def finalize(g, acc):
        has = acc["count"] > 0
        return tree_map(lambda gl, d: torch.where(has, gl + d.to(gl.dtype), gl),
                        g, acc["delta"])

    return Aggregator(name, weigh, init, accumulate, finalize,
                      additive=False, stat_names=("unweighted",))


def _reject_staleness(name: str, staleness_mode, staleness_exp) -> None:
    """Order statistics are unweighted: accepting fedbuff staleness knobs
    here and silently ignoring them has bitten before — refuse loudly."""
    if staleness_mode is not None or staleness_exp is not None:
        raise ValueError(
            f"{name}: staleness_mode/staleness_exp are not supported — "
            "order-statistic aggregators treat weights as validity only "
            "and ignore staleness discounting (use norm_clip for a "
            "robust aggregator that keeps staleness weighting)"
        )


@register_aggregator("trimmed_mean")
def make_trimmed_mean(trim: float = 0.2, staleness_mode=None,
                      staleness_exp=None) -> Aggregator:
    """Coordinate-wise trimmed mean of the deltas: per coordinate, drop
    the ``floor(c * trim)`` lowest and highest values among the ``c``
    valid slots and average the middle — robust to ``trim`` of the
    cohort colluding arbitrarily."""
    _reject_staleness("trimmed_mean", staleness_mode, staleness_exp)
    if not 0.0 <= trim < 0.5:
        raise ValueError(f"trimmed_mean: trim must be in [0, 0.5), got {trim}")

    return _order_stat_aggregator(
        "trimmed_mean",
        lambda d_sorted, ranks, c: trimmed_mean_sorted(d_sorted, ranks, c, trim))


@register_aggregator("coordinate_median")
def make_coordinate_median(staleness_mode=None,
                           staleness_exp=None) -> Aggregator:
    """Coordinate-wise median of the deltas — the trim -> 50% limit of
    ``trimmed_mean`` (even counts average the two middle values)."""
    _reject_staleness("coordinate_median", staleness_mode, staleness_exp)

    return _order_stat_aggregator("coordinate_median", median_sorted)
