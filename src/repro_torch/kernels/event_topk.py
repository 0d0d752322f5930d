"""K2 on Hopper: the k earliest pending completion times among n.

Replaces the TPU kernel ``src/repro/kernels/event_topk.py::tile_next_k``
(``_next_k_kernel``) and its phase 2 in ``src/repro/kernels/ops.py::
event_next_k``. The CUDA source is ``src/repro_torch/csrc/event_topk.cu``
(the kernel is ``csrc/tile_topk.cuh``, shared with K3 in descending order):
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
def launcher(name: str):
    """The built library ``name``'s ``<name>_launch`` (a ``tile_topk.cuh``
    launcher: K2's ``event_topk`` or K3's ``aoi_topk``), typed (built at
    first use)."""
    from repro_torch.kernels.build import library

    lib = library(name)
    if getattr(lib, f"{name}_tile")() != TILE:
        raise RuntimeError(f"csrc/{name}.cu TILE differs from event_topk.TILE")
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check(values: torch.Tensor, k: int) -> None:
    """What both tile top-k wrappers take: a 1-D f32 vector, 1 <= k <= n."""
    if values.dim() != 1 or values.dtype != torch.float32:
        raise ValueError(
            f"values must be a 1-D float32 tensor, got {tuple(values.shape)} "
            f"{values.dtype}"
        )
    n = values.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    if n >= 2**31:
        raise ValueError(f"n={n} exceeds the kernel's 31-bit index range")


def launch(name: str, values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run kernel ``name``'s tile passes on a CUDA vector; (values (k,) f32,
    idx (k,) i64). Raises on what the kernel does not take."""
    if values.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {values.device}")
    if k > MAX_K:
        raise ValueError(f"{name} keeps k <= {MAX_K} per {TILE}-key tile, got k={k}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    fn = launcher(name)
    n = values.shape[0]
    dev = values.device
    cand = -(-n // TILE) * k
    scratch = torch.empty((2, cand), dtype=torch.int64, device=dev)
    out_v = torch.empty((k,), dtype=torch.float32, device=dev)
    out_i = torch.empty((k,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(values.data_ptr(), n, k, scratch[0].data_ptr(),
                 scratch[1].data_ptr(), out_v.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out_v, out_i


def event_topk(times: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(times (k,) f32, idx (k,) i64) of the k earliest entries of
    ``times``; entries with no event carry ``+inf`` (mask by finiteness)."""
    global launches
    check(times, k)
    if times.device.type == "cpu":
        return next_k_plain(times, k)
    out = launch("event_topk", times, k)
    launches += 1
    return out
