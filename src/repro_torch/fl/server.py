"""FedAvg server: cohort gather and aggregation.

Aggregation handles *variable-size* cohorts (the Markov policy selects a
Binomial(~k) number of clients each round): selected indices are padded to
``width`` and averaged with 0/1 weights. ``use_kernel=True`` takes the
weighted sums of all leaves through ``kernels.ops.fedavg_reduce_leaves``
(K1: one CUDA launch for the tree on the GPU, its plain version on the
CPU); the default path is plain tensor code. Nothing here synchronizes with the host.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.tree import tree_map


def cohort_indices(selected: torch.Tensor, width: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices (width,) i64, weights (width,) f32) from an (n,) bool mask.

    The reference's ``jnp.nonzero(size=width, fill_value=-1)`` as a
    fixed-width compaction: each selected client's rank (a cumsum) is its
    slot, and clients past ``width`` or not selected write to a dump slot.
    Overflow beyond ``width`` drops the highest indices (rare: the default
    width is k + 4 sigma of the binomial cohort size); padding entries
    point at client 0 with weight 0.
    """
    n = selected.shape[0]
    dev = selected.device
    rank = torch.cumsum(selected.to(torch.int64), 0) - 1
    slot = torch.where(selected & (rank < width), rank, width)
    buf = torch.full((width + 1,), -1, dtype=torch.int64, device=dev)
    buf = buf.index_put((slot,), torch.arange(n, device=dev))
    idx = buf[:width]
    return torch.clamp(idx, min=0), (idx >= 0).to(torch.float32)


def fedavg_aggregate(global_params: Dict, cohort_params: Dict,
                     weights: torch.Tensor, use_kernel: bool = False) -> Dict:
    """Weighted mean over the stacked cohort axis; keeps the global params
    when the cohort is empty (no update this round).

    cohort_params: params dict with a leading cohort axis of ``weights``'
    length.
    """
    wsum = weights.sum()
    empty = wsum == 0.0
    denom = torch.clamp(wsum, min=1.0)

    if use_kernel:
        from repro_torch.kernels import ops as kops

        # every leaf's weighted sum in one K1 launch, in tree_map's order
        stacks = []
        tree_map(lambda g, c: stacks.append(
            c.reshape(c.shape[0], -1).to(torch.float32).contiguous()),
            global_params, cohort_params)
        sums = iter(kops.fedavg_reduce_leaves(stacks, weights / denom))

        def agg(g, c):
            return torch.where(empty, g, next(sums).reshape(g.shape).to(g.dtype))

    else:

        def agg(g, c):
            wv = weights.view((-1,) + (1,) * (c.dim() - 1)).to(c.dtype)
            out = torch.sum(c * wv, dim=0) / denom.to(c.dtype)
            return torch.where(empty, g, out.to(g.dtype))

    return tree_map(agg, global_params, cohort_params)


def broadcast_to_cohort(params: Dict, width: int) -> Dict:
    """Global params along a new cohort axis, as stride-0 views (no
    ``width`` copies are materialized)."""
    return tree_map(lambda p: p.expand((width,) + p.shape), params)
