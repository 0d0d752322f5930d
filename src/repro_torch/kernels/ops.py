"""Entry points of the port's kernels, named as in ``repro.kernels.ops``.

Each entry point goes to its kernel's wrapper, which launches the Hopper
kernel on a CUDA tensor and takes the plain PyTorch version on a CPU
tensor.
"""
from __future__ import annotations

from repro_torch.kernels import event_topk as _etopk


def event_next_k(times, k):
    """K2: (times (k,), indices (k,)) of the k earliest events; slots with
    no pending event carry ``+inf`` times (mask by finiteness)."""
    return _etopk.event_topk(times, k)
