"""K1 on Hopper: the weighted cohort sum ``out[n] = sum_c w[c] * P[c, n]``,
for every leaf of a parameter tree in one launch.

Replaces the TPU kernel ``src/repro/kernels/fedavg_reduce.py::
fedavg_reduce`` (``_fedavg_kernel``). The CUDA source is
``src/repro_torch/csrc/fedavg_reduce.cu``: one launch takes up to
``MAX_LEAVES`` leaves through a leaf table passed by value (no copy to the
device, no sync); each CTA finds its leaf in the table's prefix sums of
block counts, and each thread owns consecutive columns of that leaf (four,
with 16-byte loads, when N is a multiple of 4 and the pointers are
aligned), walking the cohort axis in order with an f32 FMA and the weights
staged in shared memory. Every output is a fixed-order sum, so launches are
bitwise repeatable and a leaf's sums do not depend on the other leaves of
its launch. Weight-0 slots still count, as in the Pallas dot: a padded slot
adds exactly 0 and a NaN propagates.

Bound on the H100: a leaf moves ``(C*N + C + N) * 4`` bytes for ``2*C*N``
flops, so it is bound by memory; at the sync main path's fc1 leaf (C = 30,
N = 1 605 632) that is 199 MB, about 59 us at 3.35 TB/s, and the whole
paper-CNN tree about 62 us.

``fedavg_reduce_leaves(stacks, weights)`` takes the (C, N_i) stacks of one
cohort and the shared (C,) weights and returns each leaf's (N_i,) sum: CPU
tensors go to the plain version leaf by leaf, CUDA tensors to one launch
per ``MAX_LEAVES`` leaves (``plan_launches`` cuts the tree). A kernel that
does not build or launch raises. ``fedavg_reduce(params, weights)`` is a
tree of one leaf. ``launches`` counts kernel launches, of both routes.

The segmented route (``seg``, ``num_segments``) is the tiered aggregation's
tier merge: each leaf returns ``(E, N_i)`` with ``out[e] = sum over c
ascending with seg[c] == e of w[c] * P[c]``. On the card a CTA owns (column
tile, leaf, segment) and loads only its segment's rows, so rows of other
segments are skipped (a NaN stays in its segment) and an empty segment is
exactly 0; each output is a fixed-order f32 FMA sum, bitwise repeatable.
Its plain version is ``index_add_`` on the CPU, which adds in row order.
Bound: ``(C*N + E*N + 2*C) * 4`` bytes a leaf (the stack read once).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch

launches = 0  # kernel launches (one per fedavg_reduce_leaves call of <= 16 leaves)
THREADS = 256  # threads per CTA of the kernel
MAX_LEAVES = 16  # leaves in one launch's table
VEC_COLS = 4  # columns a thread takes with 16-byte loads


def fedavg_reduce_plain(params: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The plain version: ``(w[:, None] * P).sum(0)`` in f32."""
    return (weights[:, None] * params).sum(0)


def segment_reduce_plain(params: torch.Tensor, weights: torch.Tensor,
                         seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The segmented route's plain version: ``(E, N)`` with row ``e`` the sum
    of ``w[c] * P[c]`` over the rows ``c`` with ``seg[c] == e``
    (``index_add_``, which adds in row order on the CPU)."""
    out = params.new_zeros((num_segments, params.shape[1]))
    return out.index_add_(0, seg.long(), weights[:, None] * params)


def leaf_blocks(n: int, vec: bool) -> int:
    """CTAs the kernel gives a leaf of ``n`` columns: each thread takes
    ``VEC_COLS`` consecutive columns when ``vec``, else one."""
    cols = THREADS * (VEC_COLS if vec else 1)
    return -(-n // cols)


def plan_launches(sizes: Sequence[int], vec: Sequence[bool]) -> List[List[tuple]]:
    """The leaf tables of a tree: leaves in order, cut into launches of at
    most ``MAX_LEAVES``. Each launch is a list of ``(leaf, block_end)``,
    ``block_end`` the inclusive prefix sum of the launch's block counts."""
    plans = []
    for start in range(0, len(sizes), MAX_LEAVES):
        table, end = [], 0
        for i in range(start, min(start + MAX_LEAVES, len(sizes))):
            end += leaf_blocks(sizes[i], vec[i])
            table.append((i, end))
        plans.append(table)
    return plans


@functools.cache
def _launcher():
    """The built library's ``fedavg_reduce_group_launch``, typed (built at
    first use)."""
    from repro_torch.kernels.build import library

    fn = library("fedavg_reduce").fedavg_reduce_group_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(params: torch.Tensor, weights: torch.Tensor) -> None:
    if params.dim() != 2 or params.dtype != torch.float32:
        raise ValueError(
            f"params must be a 2-D float32 tensor, got {tuple(params.shape)} "
            f"{params.dtype}"
        )
    if weights.dim() != 1 or weights.dtype != torch.float32:
        raise ValueError(
            f"weights must be a 1-D float32 tensor, got {tuple(weights.shape)} "
            f"{weights.dtype}"
        )
    if weights.shape[0] != params.shape[0]:
        raise ValueError(
            f"weights has length {weights.shape[0]}, params has "
            f"{params.shape[0]} cohort rows"
        )
    if params.device != weights.device:
        raise ValueError(
            f"params on {params.device}, weights on {weights.device}"
        )
    if not (params.is_contiguous() and weights.is_contiguous()):
        raise ValueError("params and weights must be contiguous")
    if params.shape[0] >= 2**31:
        raise ValueError(f"C={params.shape[0]} exceeds the kernel's int range")


def _check_seg(seg: torch.Tensor, weights: torch.Tensor, num_segments: int) -> None:
    if seg.dim() != 1 or seg.dtype != torch.int32 or seg.shape[0] != weights.shape[0]:
        raise ValueError(
            f"seg must be a ({weights.shape[0]},) int32 tensor, got "
            f"{tuple(seg.shape)} {seg.dtype}"
        )
    if seg.device != weights.device or not seg.is_contiguous():
        raise ValueError(f"seg must be contiguous on {weights.device}, got {seg.device}")
    if not 1 <= num_segments <= 65535:
        raise ValueError(f"num_segments must be in 1..65535, got {num_segments}")


def fedavg_reduce_leaves(stacks: Sequence[torch.Tensor], weights: torch.Tensor,
                         seg: Optional[torch.Tensor] = None,
                         num_segments: int = 1) -> List[torch.Tensor]:
    """Each leaf's ``(N_i,)`` f32 weighted sum over the cohort rows of its
    ``(C, N_i)`` stack, all leaves sharing ``weights`` (C,). With ``seg``
    ((C,) int32 on the weights' device) each leaf gives ``(num_segments,
    N_i)``: row ``e`` sums the rows ``c`` with ``seg[c] == e``."""
    global launches
    for params in stacks:
        _check(params, weights)
    if seg is not None:
        _check_seg(seg, weights, num_segments)
    elif num_segments != 1:
        raise ValueError("num_segments without a segment map")
    if weights.device.type == "cpu":
        if seg is None:
            return [fedavg_reduce_plain(params, weights) for params in stacks]
        return [segment_reduce_plain(params, weights, seg, num_segments)
                for params in stacks]
    if weights.device.type != "cuda":
        raise ValueError(f"fedavg_reduce runs on cpu or cuda, got {weights.device}")
    sizes = [params.shape[1] for params in stacks]
    rows = num_segments if seg is not None else 1
    # one buffer for every output, each leaf's slice starting 16-byte aligned
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n * rows // VEC_COLS) * VEC_COLS
    buf = torch.empty((total,), dtype=torch.float32, device=weights.device)
    outs = [buf[o:o + n * rows].view(rows, n) if seg is not None else buf[o:o + n]
            for o, n in zip(offsets, sizes)]
    vec = [n % VEC_COLS == 0 and p.data_ptr() % 16 == 0 and o.data_ptr() % 16 == 0
           for n, p, o in zip(sizes, stacks, outs)]
    C = weights.shape[0]
    fn = _launcher()
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream(weights.device).cuda_stream
        for table in plan_launches(sizes, vec):
            if table[-1][1] == 0:  # every leaf of this launch is empty
                continue
            m = len(table)
            leaves = [i for i, _ in table]
            err = fn((ctypes.c_void_p * m)(*(stacks[i].data_ptr() for i in leaves)),
                     (ctypes.c_void_p * m)(*(outs[i].data_ptr() for i in leaves)),
                     (ctypes.c_longlong * m)(*(sizes[i] for i in leaves)),
                     (ctypes.c_int * m)(*(int(vec[i]) for i in leaves)),
                     (ctypes.c_int * m)(*(end for _, end in table)),
                     m, weights.data_ptr(), C,
                     seg.data_ptr() if seg is not None else None, rows, stream)
            if err != 0:
                raise RuntimeError(f"fedavg_reduce launch failed: CUDA error {err}")
            launches += 1
    return outs


def fedavg_reduce(params: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``(N,)`` f32 weighted sum over the cohort rows of ``params`` (C, N):
    a tree of one leaf."""
    return fedavg_reduce_leaves([params], weights)[0]
