"""Entry points of the port's kernels, named as in ``repro.kernels.ops``.

Each entry point goes to its kernel's wrapper, which launches the Hopper
kernel on a CUDA tensor and takes the plain PyTorch version on a CPU
tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import aoi_topk as _topk
from repro_torch.kernels import event_topk as _etopk
from repro_torch.kernels import fedavg_reduce as _fedavg
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_decode as _fdec
from repro_torch.kernels import ssd_scan as _ssd


def event_next_k(times, k):
    """K2: (times (k,), indices (k,)) of the k earliest events; slots with
    no pending event carry ``+inf`` times (mask by finiteness)."""
    return _etopk.event_topk(times, k)


def fedavg_reduce(params, weights):
    """K1: ``out[n] = sum_c weights[c] * params[c, n]`` over a (C, N) f32
    stack of flattened cohort params; weight-0 slots add nothing."""
    return _fedavg.fedavg_reduce(params, weights)


def fedavg_reduce_leaves(stacks, weights, seg=None, num_segments=1):
    """K1 over a whole parameter tree: each leaf's (N_i,) weighted sum of its
    (C, N_i) f32 stack against the shared (C,) weights, one launch for up to
    16 leaves on the GPU (the per-leaf plain version on the CPU). With a
    (C,) int32 segment map ``seg``, each leaf's (num_segments, N_i) sums of
    the rows of each segment (the tiered aggregation's tier merge)."""
    return _fedavg.fedavg_reduce_leaves(stacks, weights, seg, num_segments)


def flash_attention(q, k, v, *, scale, kind="full", window=0, block_q=None,
                    block_k=None):
    """K4: causal GQA attention, q (B, Hk, G, S, D) over k/v (B, Hk, S, D),
    with ``kind`` full, sliding or chunked (``window``). Differentiable:
    under autograd or ``torch.func`` it runs K4's autograd Function (the
    forward with lse, then K4's backward kernel)."""
    return _flash.flash_attention(q, k, v, scale=scale, kind=kind, window=window,
                                  block_q=block_q, block_k=block_k)


def flash_decode(q, k, v, valid_len, *, scale, block_l=None):
    """K5: one token's queries (B, Hk, G, D) over a (B, Hk, L, D) cache, slots
    at or past ``valid_len`` (() or (B,)) masked."""
    return _fdec.flash_decode(q, k, v, valid_len, scale=scale, block_l=block_l)


def ssd_scan(x, dt, A, B_, C_, *, chunk=256):
    """K6: the Mamba2 SSD chunked scan from a zero state, y (B, S, nh, hd) in
    x's dtype (``ssd_scan.ssd_scan`` also gives the f32 y and final state).
    Differentiable: under autograd or ``torch.func`` it runs K6's autograd
    Function (the forward with the entering states, then K6's backward
    kernel)."""
    y, _ = _ssd.ssd_scan(x, dt, A, B_, C_, chunk)
    return y.to(x.dtype)


def oldest_age_topk(ages, k, sorted=True):
    """K3: fleet-scale oldest-age selection. Returns (values (k,) f32,
    indices (k,) i64) of the k highest ages (cast to f32), highest first,
    ties to the lower index; ``sorted=False``: the same k in index order."""
    return _topk.aoi_topk(ages.to(torch.float32), k, sorted)
