"""Pluggable server-side aggregation: ``weigh/init/accumulate/finalize``.

An ``Aggregator`` owns everything between "the cohort's local updates are
stacked on axis 0" and "here are the new global params":

    w     = agg.weigh(mask, staleness)        # (B,) float32 weights
    acc   = agg.init(global_params)           # accumulator dict
    acc   = agg.accumulate(acc, updates, bases, w)
    new_g = agg.finalize(global_params, acc)

``updates`` is a params dict with a stacked cohort axis; ``bases`` is the
params each cohort member trained *from* (the dispatch-time ring version),
which is what lets delta-based aggregators express staleness. All
functions stay on the tensors' device and are safe with an all-zero
weight vector (an empty buffer leaves the global params untouched).

Built-ins, as in the reference:
  * ``fedavg``  — weighted mean of the updated params; ignores staleness.
                  Its cohort sums are one ``fedavg_reduce_leaves`` call (K1).
  * ``fedbuff`` — staleness-discounted mean of *deltas* added to the
                  global params (FedBuff/FedAsync style, ``(1+s)^-a``).
  * ``fedprox`` — fedbuff with the mean delta scaled by ``1/(1+mu)``.

The robust aggregators (``norm_clip``, ``trimmed_mean``,
``coordinate_median``) live in ``engine/robust.py``.

Node form (``accumulate_nodes``): under a multi-tier topology
(``topo.reduce.tiered_apply``) the cohort is accumulated per tier-0 node.
Each additive built-in sums ``w_c * term_c`` over its slots, where
``term_c`` is ``u``, ``u - b`` or the clipped ``u - b``, so its node form is
one call of K1's segmented route on the same stacks; the per-node scalars
(``wsum``, telemetry) are ``node_sums``. A plugin without a node form is
accumulated one slot at a time (``tiered_apply``'s fallback).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.engine.registry import register_aggregator
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """The aggregation protocol the engines dispatch through.

    ``additive`` declares, as in the reference, that the accumulator is a
    plain sum over cohort members (``init`` is the zero element, and the
    accumulators of two disjoint cohort slices add up to the full
    cohort's): what a tier merge (``topo.reduce.tiered_apply``) and a
    cohort-sharded merge (``cohort_sharded_apply``) need. Every aggregator
    opts in explicitly; the order-statistic robust aggregators do not.
    """

    name: str
    weigh: Callable  # (mask bool (B,), staleness i32 (B,)) -> f32 (B,)
    init: Callable  # (global_params) -> acc
    accumulate: Callable  # (acc, updates, bases, weights) -> acc
    finalize: Callable  # (global_params, acc) -> new global_params
    additive: bool = False
    # scalar telemetry names the accumulator carries under acc["stats"]
    # (e.g. norm_clip's "clipped" count). Engines surface each as an
    # ``agg_<name>`` counter in RunResult.load_stats; () (every
    # non-robust built-in) adds no stats key and no per-step ops.
    stat_names: tuple = ()
    # (g, updates, bases, w, seg, num_nodes) -> the accumulators of the
    # tier-0 nodes, every leaf with a leading (num_nodes,) axis: node e's
    # accumulator over the slots with seg == e. None: ``tiered_apply``
    # accumulates one slot at a time and sums the slots by node.
    accumulate_nodes: Optional[Callable] = None


def node_sums(x: torch.Tensor, seg: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """(B,) -> (num_nodes,) sums of ``x`` over the slots of each node: a
    masked (num_nodes, B) tensor summed on its rows, in a fixed order (a
    value of another node is replaced, not multiplied, by 0)."""
    nodes = torch.arange(num_nodes, device=x.device, dtype=seg.dtype)
    return torch.where(seg[None, :] == nodes[:, None], x[None, :], 0.0).sum(dim=1)


def cohort_reduce(terms, w: torch.Tensor, seg=None, num_nodes: int = 1):
    """K1 over a tree of (B, ...) ``terms``, one call for the tree: each
    leaf's f32 weighted sum over the cohort, or with a (B,) int32 node map
    ``seg`` (K1's segmented route) its (num_nodes, ...) sums by node."""
    stacks = [t.reshape(t.shape[0], -1).to(torch.float32).contiguous()
              for t in tree_leaves(terms)]
    sums = iter(kops.fedavg_reduce_leaves(stacks, w.contiguous(), seg, num_nodes))
    lead = () if seg is None else (num_nodes,)
    return tree_map(lambda t: next(sums).view(lead + tuple(t.shape[1:])), terms)


def acc_stats(acc) -> dict:
    """The scalar telemetry dict a finished accumulator carries (empty for
    aggregators that declare no ``stat_names``)."""
    return acc.get("stats", {}) if isinstance(acc, dict) else {}


def cohort_sharded_apply(agg: Aggregator, mesh) -> Callable:
    """The aggregator seam's rank-local path for cohort-parallel execution:
    ``apply(global_params, updates, bases, w, idx=None) -> (new params,
    stats)`` where ``updates``/``w`` (and ``bases`` when stacked) are this
    rank's slice of the cohort over ``mesh`` (a
    ``core.distributed.FleetMesh``); ``stats`` is the merged accumulator's
    scalar telemetry (``acc_stats``).

    Each rank runs ``agg.init``/``agg.accumulate`` over its own ``B/D``
    slots (K1 for fedavg), the accumulators are merged by the rank-order
    ``psum`` (an all-gather, then a sum in rank order: every rank gets the
    same bits, and runs repeat bitwise) — O(params) traffic instead of the
    ``B x params`` update stack — and every rank runs ``finalize`` on the
    merged accumulator. Requires ``agg.additive``; engines pad the cohort
    with zero-weight slots to a multiple of the mesh. Allclose, not
    bitwise, to the one-device reduction: the cohort sum is split in D
    partial sums. ``bases`` is the slice's stacked bases, or the sync
    engine's unstacked global tree (``accumulate`` broadcasts it).
    """
    from repro_torch.core.distributed import psum

    if not agg.additive:
        raise ValueError(
            f"aggregator {agg.name!r} is not additive: its accumulator "
            "cannot be merged by psum, so it cannot run cohort-sharded "
            "(drop shard_cohort for this aggregator)"
        )

    def apply(g, updates, bases, w, idx=None):
        # ``idx`` (the cohort -> client map) is part of the engines'
        # aggregate-hook signature for topology-aware reductions; the
        # star-shaped single-server reduction has no use for it
        acc = agg.accumulate(agg.init(g), updates, bases, w)
        merged = tree_map(lambda a: psum(a, mesh), acc)
        return agg.finalize(g, merged), acc_stats(merged)

    return apply


def staleness_weight(s: torch.Tensor, mode: str = "poly",
                     exp: float = 0.5) -> torch.Tensor:
    """Aggregation discount for an update of staleness ``s`` versions."""
    s = torch.clamp(s.to(torch.float32), min=0.0)
    if mode == "const":
        return torch.ones_like(s)
    if mode == "poly":
        return (1.0 + s) ** (-exp)
    raise ValueError(f"unknown staleness mode {mode!r}")


def _wview(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return w.view((-1,) + (1,) * (u.dim() - 1))


@register_aggregator("fedavg")
def make_fedavg() -> Aggregator:
    """Weighted mean of updated params; empty cohorts keep the old params."""

    def weigh(mask, staleness):
        return mask.to(torch.float32)

    def init(g):
        return {"usum": tree_map(torch.zeros_like, g),
                "wsum": torch.zeros((), dtype=torch.float32,
                                    device=tree_leaves(g)[0].device)}

    def accumulate(acc, updates, bases, w):
        # the weighted cohort sums of all leaves are one K1 call (one CUDA
        # launch on the GPU, its plain version on the CPU)
        usum = tree_map(lambda s, t: s + t.to(s.dtype), acc["usum"],
                        cohort_reduce(updates, w))
        return {"usum": usum, "wsum": acc["wsum"] + w.sum()}

    def finalize(g, acc):
        empty = acc["wsum"] == 0.0
        denom = torch.clamp(acc["wsum"], min=1.0)
        return tree_map(
            lambda gl, s: torch.where(empty, gl, (s / denom.to(s.dtype)).to(gl.dtype)),
            g, acc["usum"],
        )

    def accumulate_nodes(g, updates, bases, w, seg, num_nodes):
        usum = cohort_reduce(updates, w, seg, num_nodes)
        return {"usum": tree_map(lambda gl, s: s.to(gl.dtype), g, usum),
                "wsum": node_sums(w, seg, num_nodes)}

    return Aggregator("fedavg", weigh, init, accumulate, finalize,
                      additive=True, accumulate_nodes=accumulate_nodes)


def _delta_aggregator(name: str, staleness_mode: str, staleness_exp: float,
                      scale: float) -> Aggregator:
    """Shared core of fedbuff/fedprox: staleness-weighted mean delta,
    scaled by ``scale`` and added to the global params."""

    def weigh(mask, staleness):
        return mask.to(torch.float32) * staleness_weight(
            staleness, staleness_mode, staleness_exp
        )

    def init(g):
        return {
            "dsum": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), g),
            "wsum": torch.zeros((), dtype=torch.float32,
                                device=tree_leaves(g)[0].device),
        }

    def accumulate(acc, updates, bases, w):
        dsum = tree_map(
            lambda s, u, b: s + torch.sum((u - b).to(torch.float32) * _wview(w, u),
                                          dim=0),
            acc["dsum"], updates, bases,
        )
        return {"dsum": dsum, "wsum": acc["wsum"] + w.sum()}

    def finalize(g, acc):
        has = acc["wsum"] > 0
        denom = torch.clamp(acc["wsum"], min=1e-9)

        def fin(gl, s):
            d = s / denom
            if scale != 1.0:
                d = d * scale
            return torch.where(has, gl + d.to(gl.dtype), gl)

        return tree_map(fin, g, acc["dsum"])

    def accumulate_nodes(g, updates, bases, w, seg, num_nodes):
        deltas = tree_map(lambda u, b: (u - b).to(torch.float32), updates, bases)
        return {"dsum": cohort_reduce(deltas, w, seg, num_nodes),
                "wsum": node_sums(w, seg, num_nodes)}

    return Aggregator(name, weigh, init, accumulate, finalize,
                      additive=True, accumulate_nodes=accumulate_nodes)


@register_aggregator("fedbuff")
def make_fedbuff(staleness_mode: str = "poly", staleness_exp: float = 0.5) -> Aggregator:
    """Staleness-discounted buffered delta aggregation (FedBuff-style)."""
    return _delta_aggregator("fedbuff", staleness_mode, staleness_exp, scale=1.0)


@register_aggregator("fedprox")
def make_fedprox(prox_mu: float = 0.1, staleness_mode: str = "poly",
                 staleness_exp: float = 0.5) -> Aggregator:
    """Proximally damped delta aggregation: mean delta scaled by 1/(1+mu)."""
    if prox_mu < 0:
        raise ValueError(f"prox_mu must be >= 0, got {prox_mu}")
    return _delta_aggregator(
        "fedprox", staleness_mode, staleness_exp, scale=1.0 / (1.0 + prox_mu)
    )
