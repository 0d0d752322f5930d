"""K3 on Hopper: the k largest values among n, ties to the lower index.

Replaces the TPU kernel ``src/repro/kernels/aoi_topk.py::tile_topk``
(``_topk_kernel``) and its phase 2 in ``src/repro/kernels/ops.py::
oldest_age_topk``. The CUDA source is ``src/repro_torch/csrc/aoi_topk.cu``,
K2's radix select (``csrc/radix_topk.cuh``, planned and emulated in
``kernels/radix_topk.py``) in descending order: an image is the complement
of the value's order-preserving bits. It takes any 1 <= k <= n in one
launch. Sorted, the result is ``jax.lax.top_k``'s: values descending,
equal values by ascending index; unsorted, the same k in ascending order of
index (the gather's own order, no sort passes).

The Pallas tiles pad with -1 and phase 2 picks among tile-major
candidates, so the reference's result differs from ``lax.top_k`` only where
the last partial tile's -1 padding outranks real values below -1. The port
has no padding, so it equals ``lax.top_k`` for every finite input, and does
not reproduce that corner.

Bound on the H100: the function reads ``n * 4`` bytes and writes
``k * 12``; at the policy's n = 16384 that is ~20 ns of HBM time, and the
call is one launch of one CTA, bound by the launch and its passes' latency.

``aoi_topk(values, k, sorted=True)`` is the wrapper: a CPU tensor goes to
the plain version ``topk_plain`` (a stable descending sort), a CUDA tensor
to the kernel, which raises on what it does not take. ``launches`` counts
the kernel calls.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.radix_topk import check, launch, plan  # noqa: F401

launches = 0  # kernel calls (one per aoi_topk on a CUDA tensor)


def topk_plain(values: torch.Tensor, k: int,
               sorted: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: a stable descending sort, then the first k.
    Equal values keep index order, so ties go to the lower index (bare
    ``torch.topk`` promises no tie order). Unsorted: those k re-sorted by
    index."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    if not sorted:
        idx, order = torch.sort(idx)
        vals = vals[order]
    return vals, idx


def aoi_topk(values: torch.Tensor, k: int,
             sorted: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (k,) f32, idx (k,) i64) of the k largest entries of
    ``values``: in descending order, ties to the lower index, or, with
    ``sorted=False``, in ascending order of index."""
    global launches
    check(values, k)
    if values.device.type == "cpu":
        return topk_plain(values, k, sorted)
    out = launch("aoi_topk", values, k, sorted)
    launches += 1
    return out
