"""K1 on Hopper: the weighted cohort sum ``out[n] = sum_c w[c] * P[c, n]``.

Replaces the TPU kernel ``src/repro/kernels/fedavg_reduce.py::
fedavg_reduce`` (``_fedavg_kernel``). The CUDA source is
``src/repro_torch/csrc/fedavg_reduce.cu``: each thread owns consecutive
columns (four, with 16-byte loads, when N is a multiple of 4), walks the
cohort axis in order with an f32 FMA and the weights staged in shared
memory, so every output is a fixed-order sum and launches are bitwise
repeatable. Weight-0 slots still count, as in the Pallas dot: a padded
slot adds exactly 0 and a NaN propagates.

Bound on the H100: the function moves ``(C*N + C + N) * 4`` bytes for
``2*C*N`` flops, so it is bound by memory; at the sync main path's fc1
leaf (C = 30, N = 1 605 632) that is 199 MB, about 59 us at 3.35 TB/s.

``fedavg_reduce(params, weights)`` is the wrapper: a CPU tensor goes to the
plain version ``fedavg_reduce_plain``, a CUDA tensor to the kernel; a
kernel that does not build or launch raises. ``launches`` counts the
kernel calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

launches = 0  # kernel calls (one per fedavg_reduce on CUDA tensors with N > 0)


def fedavg_reduce_plain(params: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The plain version: ``(w[:, None] * P).sum(0)`` in f32."""
    return (weights[:, None] * params).sum(0)


@functools.cache
def _launcher():
    """The built library's ``fedavg_reduce_launch``, typed (built at first
    use)."""
    from repro_torch.kernels.build import library

    fn = library("fedavg_reduce").fedavg_reduce_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
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


def fedavg_reduce(params: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``(N,)`` f32 weighted sum over the cohort rows of ``params`` (C, N)."""
    global launches
    _check(params, weights)
    if params.device.type == "cpu":
        return fedavg_reduce_plain(params, weights)
    if params.device.type != "cuda":
        raise ValueError(f"fedavg_reduce runs on cpu or cuda, got {params.device}")
    C, N = params.shape
    dev = params.device
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(params.data_ptr(), weights.data_ptr(), C, N, out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"fedavg_reduce launch failed: CUDA error {err}")
    launches += 1
    return out
