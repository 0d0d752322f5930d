"""Entry points of the port's kernels, named as in ``repro.kernels.ops``.

Each entry point goes to its kernel's wrapper, which launches the Hopper
kernel on a CUDA tensor and takes the plain PyTorch version on a CPU
tensor.
"""
from __future__ import annotations

from repro_torch.kernels import event_topk as _etopk
from repro_torch.kernels import fedavg_reduce as _fedavg


def event_next_k(times, k):
    """K2: (times (k,), indices (k,)) of the k earliest events; slots with
    no pending event carry ``+inf`` times (mask by finiteness)."""
    return _etopk.event_topk(times, k)


def fedavg_reduce(params, weights):
    """K1: ``out[n] = sum_c weights[c] * params[c, n]`` over a (C, N) f32
    stack of flattened cohort params; weight-0 slots add nothing."""
    return _fedavg.fedavg_reduce(params, weights)
