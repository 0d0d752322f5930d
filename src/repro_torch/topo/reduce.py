"""Tier reductions and per-hop latency on torch tensors (``repro.topo.reduce``).

``tiered_apply`` turns a :class:`~repro_torch.topo.graph.Topology` into the
engines' ``aggregate(global_params, updates, bases, w, idx) -> (params,
stats)`` hook. It is reduction structure over the aggregator protocol, no
new aggregator math:

  1. the cohort's tier-0 node accumulators: the aggregator's node form
     (``Aggregator.accumulate_nodes``: for the additive built-ins one call
     of K1's segmented route, ``seg = assign[idx]``), or, for a plugin
     without one, one ``accumulate`` per slot (exact: the aggregator is
     additive and ``init`` is the zero element) summed by node;
  2. each upper tier merges its nodes' accumulators into their parents:
     K1's segmented route with weight 1 over the static parent map;
  3. the top tier sums into the global root (``sum(dim=0)``, a fixed-order
     reduction) — or, for gossip graphs, the peer accumulators mix through
     the doubly stochastic ring matrix for ``gossip_rounds`` rounds (row
     ``i`` of the matrix as K1's weights over the (E, N) stack: E launches a
     round, full f32 whatever TF32 says) and the global model reads node
     0's view times E;
  4. one ``agg.finalize`` on the merged accumulator.

Every sum is a fixed-order f32 sum with no atomics, so tiered runs repeat
bitwise (chunked == per-step, crash-restart). A NaN in one slot stays in its
tier-0 node's accumulator, as in the reference, where every slot is its own
accumulator before the segment sum.

``make_hop_latency`` prices the DAG: one latency draw per client for the
client -> tier-0 link, then one per aggregation node per upper hop, gathered
down the maps (clients under the same edge node share its uplink draw);
gossip peers pay their link once per gossip round. Hop ``i`` draws from the
sub-stream ``str(i)`` of the source it is given (the reference's ``i``-th
split of its fold-104 key).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.engine.aggregators import Aggregator, acc_stats, cohort_reduce
from repro_torch.sim import latency as lat_mod
from repro_torch.topo.graph import Topology


def segment_sum_tree(tree, seg: torch.Tensor, num_segments: int):
    """Each (C, ...) leaf of ``tree`` -> (num_segments, ...): its rows summed
    by ``seg`` in row order, one call of K1's segmented route (weight 1) for
    the whole tree; leaves keep their dtypes."""
    ones = torch.ones((seg.shape[0],), dtype=torch.float32, device=seg.device)
    sums = cohort_reduce(tree, ones, seg, num_segments)
    return tree_map(lambda s, x: s.to(x.dtype), sums, tree)


def mix_tree(tree, mix: torch.Tensor):
    """One gossip round over (E, ...) accumulators: row ``i`` of the result
    is ``sum_j mix[i, j] * tree[j]``, K1 with ``mix[i]`` as its weights (one
    launch a row for the whole tree)."""
    rows = [cohort_reduce(tree, mix[i]) for i in range(mix.shape[0])]
    return tree_map(lambda x, *r: torch.stack(r).to(x.dtype), tree, *rows)


def slot_accums(agg: Aggregator, g, updates, bases, w, stacked_bases: bool):
    """(B,)-stacked per-slot accumulators: each cohort slot accumulated
    alone into the zero element (exact because the aggregator is
    additive). The fallback for aggregators without a node form."""
    zero = agg.init(g)
    accs = []
    for c in range(w.shape[0]):
        u = tree_map(lambda x: x[c:c + 1], updates)
        b = tree_map(lambda x: x[c:c + 1], bases) if stacked_bases else bases
        accs.append(agg.accumulate(zero, u, b, w[c:c + 1]))
    return tree_map(lambda *xs: torch.stack(xs), *accs)


def tier0_accums(agg: Aggregator, g, updates, bases, w, seg: torch.Tensor,
                 num_nodes: int, stacked_bases: bool = True):
    """The tier-0 node accumulators, every leaf (num_nodes, ...): node ``e``
    accumulates the slots with ``seg == e``."""
    if agg.accumulate_nodes is not None:
        return agg.accumulate_nodes(g, updates, bases, w, seg, num_nodes)
    return segment_sum_tree(slot_accums(agg, g, updates, bases, w, stacked_bases),
                            seg, num_nodes)


class _DeviceMaps:
    """A topology's static maps, moved to each device once."""

    def __init__(self, **maps):
        self._host = {k: torch.as_tensor(np.asarray(v)) for k, v in maps.items()}
        self._on: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def on(self, device) -> Dict[str, torch.Tensor]:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = {k: v.to(device) for k, v in self._host.items()}
        return self._on[device]


def tiered_apply(agg: Aggregator, topo: Topology, n_clients: int, mesh=None,
                 stacked_bases: bool = True):
    """Build the tiered ``aggregate(g, updates, bases, w, idx)`` hook.

    ``idx`` is the (B,) cohort -> client index map the engines hold;
    padded or invalid slots carry weight 0 and add the zero accumulator.
    ``stacked_bases=False`` is the sync engine's convention (``bases`` is
    the unstacked global tree).

    With ``mesh`` (a ``core.distributed.FleetMesh``) the hook is the
    cohort-parallel form: ``updates``/``w``/``idx`` are this rank's slice of the cohort, the slot accumulation and the
    tier-0 segment sums run rank-locally (K1's segmented route), and the
    (E0, ...) node accumulators merge by the rank-order ``psum`` before the
    upper tiers, which every rank runs whole."""
    if topo.is_star:
        raise ValueError(
            f"topology {topo.name!r} is a star: engines use the plain "
            "aggregator path (bit-for-bit identical), not tiered_apply"
        )
    if not agg.additive:
        raise ValueError(
            f"aggregator {agg.name!r} is not additive: tier reductions "
            "are accumulator merges, so non-additive aggregators cannot "
            "run under a multi-tier topology"
        )
    sizes = [int(s) for s in topo.tier_sizes]
    maps = _DeviceMaps(assign=topo.assign(n_clients),
                       **{f"parent{i}": p for i, p in enumerate(topo.parents())},
                       **({"mix": topo.gossip_mixing()} if topo.kind == "gossip"
                          else {}))

    def apply(g, updates, bases, w, idx):
        dev = maps.on(w.device)
        seg = dev["assign"][idx]
        acc = tier0_accums(agg, g, updates, bases, w, seg, sizes[0], stacked_bases)
        if mesh is not None:
            from repro_torch.core.distributed import psum

            acc = tree_map(lambda a: psum(a, mesh), acc)
        for i, size in enumerate(sizes[1:]):
            acc = segment_sum_tree(acc, dev[f"parent{i}"], size)
        if "mix" in dev:
            for _ in range(topo.gossip_rounds):
                acc = mix_tree(acc, dev["mix"])
            # node 0's decentralized estimate of the network sum: the
            # doubly stochastic mixing preserves the total, so the x E
            # readout converges to the hierarchical reduction as rounds grow
            acc = tree_map(lambda a: a[0] * sizes[0], acc)
        else:
            acc = tree_map(lambda a: a.sum(dim=0), acc)
        return agg.finalize(g, acc), acc_stats(acc)

    return apply


def tier_suspect_counts(topo: Topology, n_clients: int, status) -> list:
    """Host-side per-edge-node suspect census for run telemetry: the
    defense tier's final per-client status (non-zero = quarantined or on
    probation) bucketed by the tier-0 assignment. A star has one implicit
    edge node."""
    suspect = (np.asarray(status) != 0).astype(np.float64)
    if topo.is_star:
        return [float(suspect.sum())]
    assign = np.asarray(topo.assign(n_clients))
    counts = np.bincount(
        assign, weights=suspect, minlength=int(topo.tier_sizes[0])
    )
    return [float(c) for c in counts]


def make_hop_latency(topo: Topology, n_clients: int):
    """Per-client extra wall time through the aggregation DAG.

    Returns ``hop(draws) -> (n,) f32`` on ``draws.device`` (or None for a
    star: no extra hops). Hop ``i`` draws ``sample_latency`` from
    ``draws.sub(str(i))``: ``0`` the client -> tier-0 link per client, then
    one per aggregation node for each upper hop (gossip: one per round).
    Profiles default to ``datacenter`` when the topology names none."""
    if topo.is_star:
        return None
    hops = topo.n_tiers + 1
    names = topo.tier_profiles or ("datacenter",) * hops
    profs = [lat_mod.get_profile(p) for p in names]
    sizes = [int(s) for s in topo.tier_sizes]
    gossip = topo.kind == "gossip"
    maps = _DeviceMaps(assign=topo.assign(n_clients).astype(np.int64),
                       **{f"parent{i}": p.astype(np.int64)
                          for i, p in enumerate(topo.parents())})

    def hop(draws):
        dev = maps.on(draws.device)
        ones_n = torch.ones((n_clients,), dtype=torch.float32, device=draws.device)
        extra = lat_mod.sample_latency(draws.sub("0"), profs[0], ones_n)
        node = dev["assign"]
        for lvl, size in enumerate(sizes):
            ones_e = torch.ones((size,), dtype=torch.float32, device=draws.device)
            if gossip:
                draw = torch.zeros((size,), dtype=torch.float32, device=draws.device)
                for rr in range(topo.gossip_rounds):
                    draw = draw + lat_mod.sample_latency(draws.sub(str(1 + rr)),
                                                         profs[1], ones_e)
            else:
                draw = lat_mod.sample_latency(draws.sub(str(1 + lvl)),
                                              profs[1 + lvl], ones_e)
            extra = extra + draw[node]
            if f"parent{lvl}" in dev:
                node = dev[f"parent{lvl}"][node]
        return extra

    return hop
