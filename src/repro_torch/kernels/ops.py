"""Entry points of the port's kernels, named as in ``repro.kernels.ops``.

Each entry point goes to its kernel's wrapper, which launches the Hopper
kernel on a CUDA tensor and takes the plain PyTorch version on a CPU
tensor.
"""
from __future__ import annotations

from repro_torch.kernels import event_topk as _etopk
from repro_torch.kernels import fedavg_reduce as _fedavg
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_decode as _fdec


def event_next_k(times, k):
    """K2: (times (k,), indices (k,)) of the k earliest events; slots with
    no pending event carry ``+inf`` times (mask by finiteness)."""
    return _etopk.event_topk(times, k)


def fedavg_reduce(params, weights):
    """K1: ``out[n] = sum_c weights[c] * params[c, n]`` over a (C, N) f32
    stack of flattened cohort params; weight-0 slots add nothing."""
    return _fedavg.fedavg_reduce(params, weights)


def flash_attention(q, k, v, *, scale, kind="full", window=0, block_q=None,
                    block_k=None):
    """K4: causal GQA attention, q (B, Hk, G, S, D) over k/v (B, Hk, S, D),
    with ``kind`` full, sliding or chunked (``window``)."""
    return _flash.flash_attention(q, k, v, scale=scale, kind=kind, window=window,
                                  block_q=block_q, block_k=block_k)


def flash_decode(q, k, v, valid_len, *, scale, block_l=None):
    """K5: one token's queries (B, Hk, G, D) over a (B, Hk, L, D) cache, slots
    at or past ``valid_len`` (() or (B,)) masked."""
    return _fdec.flash_decode(q, k, v, valid_len, scale=scale, block_l=block_l)
