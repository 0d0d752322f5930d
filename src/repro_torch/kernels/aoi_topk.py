"""K3 on Hopper: the k largest values among n, ties to the lower index.

Replaces the TPU kernel ``src/repro/kernels/aoi_topk.py::tile_topk``
(``_topk_kernel``) and its phase 2 in ``src/repro/kernels/ops.py::
oldest_age_topk``. The CUDA source is ``src/repro_torch/csrc/aoi_topk.cu``,
K2's kernel (``csrc/tile_topk.cuh``) in descending order: each value is packed with its index
into one 64-bit key (the complement of the value's order-preserving bits
high, the index low), one CTA bitonic-sorts a tile of ``TILE`` keys in
shared memory ascending and keeps its first k, and the same kernel runs
over the ``tiles * k`` candidates until one tile remains. The result is
``jax.lax.top_k``'s: values descending, equal values by ascending index.

The Pallas tiles pad with -1 and phase 2 picks among tile-major
candidates, so the reference's result differs from ``lax.top_k`` only where
the last partial tile's -1 padding outranks real values below -1. The port
pads with a key that loses to every real value, so it equals ``lax.top_k``
for every finite input, and does not reproduce that corner.

Bound on the H100: the function reads ``n * 4`` bytes and writes
``k * 12``; at the policy's n = 16384 that is ~20 ns of HBM time, so the
call is bound by launch latency (two launches at n = 16384).

``aoi_topk(values, k)`` is the wrapper: a CPU tensor goes to the plain
version ``topk_plain`` (a stable descending sort), a CUDA tensor to the
kernel, which raises on what it does not take (k above ``MAX_K``
included). ``launches`` counts the kernel calls.
"""
from __future__ import annotations

from typing import Tuple

import torch

# K2's tiling and launch path, shared: k <= MAX_K, num_passes(n, k) launches
from repro_torch.kernels.event_topk import MAX_K, TILE, check, launch, num_passes  # noqa: F401

launches = 0  # kernel calls (one per aoi_topk on a CUDA tensor)


def topk_plain(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: a stable descending sort, then the first k.
    Equal values keep index order, so ties go to the lower index (bare
    ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[:k], idx[:k]


def aoi_topk(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (k,) f32, idx (k,) i64) of the k largest entries of
    ``values``, in descending order, ties to the lower index."""
    global launches
    check(values, k)
    if values.device.type == "cpu":
        return topk_plain(values, k)
    out = launch("aoi_topk", values, k)
    launches += 1
    return out
