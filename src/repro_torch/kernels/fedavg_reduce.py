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
tree of one leaf. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

launches = 0  # kernel launches (one per fedavg_reduce_leaves call of <= 16 leaves)
THREADS = 256  # threads per CTA of the kernel
MAX_LEAVES = 16  # leaves in one launch's table
VEC_COLS = 4  # columns a thread takes with 16-byte loads


def fedavg_reduce_plain(params: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The plain version: ``(w[:, None] * P).sum(0)`` in f32."""
    return (weights[:, None] * params).sum(0)


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
                                           ctypes.c_void_p]
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


def fedavg_reduce_leaves(stacks: Sequence[torch.Tensor],
                         weights: torch.Tensor) -> List[torch.Tensor]:
    """Each leaf's ``(N_i,)`` f32 weighted sum over the cohort rows of its
    ``(C, N_i)`` stack, all leaves sharing ``weights`` (C,)."""
    global launches
    for params in stacks:
        _check(params, weights)
    if weights.device.type == "cpu":
        return [fedavg_reduce_plain(params, weights) for params in stacks]
    if weights.device.type != "cuda":
        raise ValueError(f"fedavg_reduce runs on cpu or cuda, got {weights.device}")
    sizes = [params.shape[1] for params in stacks]
    # one buffer for every output, each leaf's slice starting 16-byte aligned
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // VEC_COLS) * VEC_COLS
    buf = torch.empty((total,), dtype=torch.float32, device=weights.device)
    outs = [buf[o:o + n] for o, n in zip(offsets, sizes)]
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
                     m, weights.data_ptr(), C, stream)
            if err != 0:
                raise RuntimeError(f"fedavg_reduce launch failed: CUDA error {err}")
            launches += 1
    return outs


def fedavg_reduce(params: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``(N,)`` f32 weighted sum over the cohort rows of ``params`` (C, N):
    a tree of one leaf."""
    return fedavg_reduce_leaves([params], weights)[0]
