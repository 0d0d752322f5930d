"""Prompt ingestion over the model's decode path.

Port of ``repro.serve.batching.prefill_tokens``. The slot-pool functions
(``init_slot_pool``, ``slot_decode_fn``, ``write_slot``, ``read_slot``)
serve only ``serve/loop.py`` and arrive with it (ROADMAP queue 1, slice H).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch


def prefill_tokens(
    decode_step: Callable, params, caches, prompts: torch.Tensor
) -> Tuple[torch.Tensor, Any]:
    """Feed ``prompts`` (B, P) int through ``decode_step`` one token at a
    time; returns ``(logits, caches)`` where ``logits`` is the last step's
    (B, 1, V) output — the Python loop
    ``for t: logits, caches = decode_step(..., prompts[:, t:t+1])``, which
    is what the reference's ``lax.scan`` computes. The model's decode step
    updates ``caches`` in place."""
    logits = None
    for t in range(prompts.shape[1]):
        logits, caches = decode_step(params, caches, prompts[:, t:t + 1])
    return logits, caches
