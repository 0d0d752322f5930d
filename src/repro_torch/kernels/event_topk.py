"""K2 on Hopper: the k earliest pending completion times among n.

Replaces the TPU kernel ``src/repro/kernels/event_topk.py::tile_next_k``
(``_next_k_kernel``) and its phase 2 in ``src/repro/kernels/ops.py::
event_next_k``. The CUDA source is ``src/repro_torch/csrc/event_topk.cu``;
the kernel is the radix select of ``csrc/radix_topk.cuh`` (shared with K3,
which runs it in descending order; ``kernels/radix_topk.py`` holds the
plan, the launch and the CPU emulation of its schedule). It takes any
1 <= k <= n in one launch, always sorted: four MSD digit passes find the
k-th time, the gather takes the k earliest in index order, four stable LSD
passes sort them, so equal times keep index order.

Bound on the H100: the function reads ``n * 4`` bytes and writes ``k * 12``;
at the main path's (16384, 256) that is ~20 ns of HBM time, and the call is
one launch of one CTA holding the times in shared memory, bound by the
launch and the latency of its passes. No host sync.

``event_topk(times, k)`` is the wrapper: a CPU tensor goes to the plain
version ``next_k_plain`` (a stable sort), a CUDA tensor to the kernel; a
kernel that does not build or launch raises. ``launches`` counts the
kernel calls.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.radix_topk import check, launch, plan  # noqa: F401

launches = 0  # kernel calls (one per event_topk on a CUDA tensor)


def next_k_plain(times: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: a stable ascending sort, then the first k.
    Ties go to the lower index because the sort is stable (bare
    ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(times, stable=True)
    return vals[:k], idx[:k]


def event_topk(times: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(times (k,) f32, idx (k,) i64) of the k earliest entries of
    ``times``; entries with no event carry ``+inf`` (mask by finiteness)."""
    global launches
    check(times, k)
    if times.device.type == "cpu":
        return next_k_plain(times, k)
    out = launch("event_topk", times, k, True)
    launches += 1
    return out
