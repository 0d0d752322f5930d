"""K2 on Hopper: the k earliest pending completion times among n.

Replaces the TPU kernel ``src/repro/kernels/event_topk.py::tile_next_k``
(``_next_k_kernel``) and its phase 2 in ``src/repro/kernels/ops.py::
event_next_k``. The CUDA source is ``src/repro_torch/csrc/event_topk.cu``:
each time is packed with its index into one 64-bit key (time bits high,
index low, so ties order by index for free), one CTA bitonic-sorts a tile
of ``TILE`` keys in shared memory and keeps its first k, and the same
kernel runs over the ``tiles * k`` candidates until one tile remains.

Bound on the H100: the function reads ``n * 4`` bytes and writes ``k * 12``;
at the main path's n = 16384 that is ~20 ns of HBM time, so the call is
bound by launch latency (two launches at n = 16384). The design keeps the
launch count at ``1 + ceil(log_{TILE/k}(n / TILE))`` and does no host sync.

``event_topk(times, k)`` is the wrapper: a CPU tensor goes to the plain
version ``next_k_plain`` (a stable sort), a CUDA tensor to the kernel; a
kernel that does not build or launch raises. ``launches`` counts the
kernel calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

# keys per CTA in csrc/event_topk.cu; a pass keeps k of every TILE keys,
# so k <= TILE // 2 guarantees each pass at least halves the candidates
TILE = 2048
MAX_K = TILE // 2

launches = 0  # kernel calls (one per event_topk on a CUDA tensor)


def next_k_plain(times: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: a stable ascending sort, then the first k.
    Ties go to the lower index because the sort is stable (bare
    ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(times, stable=True)
    return vals[:k], idx[:k]


def num_passes(n: int, k: int) -> int:
    """Kernel launches one call makes: tile passes until one tile is left."""
    passes, m = 1, n
    while -(-m // TILE) > 1:
        m = -(-m // TILE) * k
        passes += 1
    return passes


@functools.cache
def _launcher():
    """The built library's ``event_topk_launch``, typed (built at first use)."""
    from repro_torch.kernels.build import library

    lib = library("event_topk")
    if lib.event_topk_tile() != TILE:
        raise RuntimeError("csrc/event_topk.cu TILE differs from event_topk.TILE")
    fn = lib.event_topk_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(times: torch.Tensor, k: int) -> None:
    if times.dim() != 1 or times.dtype != torch.float32:
        raise ValueError(
            f"times must be a 1-D float32 tensor, got {tuple(times.shape)} "
            f"{times.dtype}"
        )
    n = times.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    if n >= 2**31:
        raise ValueError(f"n={n} exceeds the kernel's 31-bit index range")


def event_topk(times: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(times (k,) f32, idx (k,) i64) of the k earliest entries of
    ``times``; entries with no event carry ``+inf`` (mask by finiteness)."""
    global launches
    _check(times, k)
    if times.device.type == "cpu":
        return next_k_plain(times, k)
    if times.device.type != "cuda":
        raise ValueError(f"event_topk runs on cpu or cuda, got {times.device}")
    if k > MAX_K:
        raise ValueError(
            f"event_topk keeps k <= {MAX_K} per {TILE}-key tile, got k={k}"
        )
    if not times.is_contiguous():
        raise ValueError("times must be contiguous")
    fn = _launcher()
    n = times.shape[0]
    dev = times.device
    cand = -(-n // TILE) * k
    scratch = torch.empty((2, cand), dtype=torch.int64, device=dev)
    out_t = torch.empty((k,), dtype=torch.float32, device=dev)
    out_i = torch.empty((k,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(times.data_ptr(), n, k, scratch[0].data_ptr(),
                 scratch[1].data_ptr(), out_t.data_ptr(), out_i.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"event_topk launch failed: CUDA error {err}")
    launches += 1
    return out_t, out_i
