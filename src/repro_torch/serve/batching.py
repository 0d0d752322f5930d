"""Continuous-batching primitives over the model decode path.

Port of ``repro.serve.batching``. The unit of serving state is a *slot*:
one stream's decode cache (ring KV cache with its own write index, or an
SSM state). The reference stacks ``S`` batch-1 caches on a leading axis and
vmaps ``decode_step`` over them. Here a pool of ``S`` slots is one batch-S
cache tree whose attention ``index`` is per row: ``(S,)``, or
``(repeats, S)`` under the stacked ``blocks``. ``attention_decode`` takes
each row's RoPE position, ring slot, ``valid_len`` (K5 takes a ``(B,)`` one)
and window mask from its own index, and the SSM caches are per row
already, so one ``decode_step`` over the batch advances every slot, and a
row's tokens depend on that row's cache alone: a request joining slot 3
or leaving slot 0 does not perturb the tokens slot 1 decodes (held by
``tests/test_torch_serve_loop.py``). Join = prefill the request's prompt
into a fresh batch-1 cache and write it over the slot's row; evict = mark
the slot free (its stale row is overwritten by the next join).

A slot's row is on axis 1 of a ``blocks`` leaf (axis 0 is the repeats)
and on axis 0 of a ``prefix``/``remainder`` leaf. The encoder-decoder's
tree (``self``, ``cross_k``, ``cross_v``, each stacked on the decoder's
layer axis) has its rows on axis 1.

An MoE layer routes the pool's tokens per row: the reference's tick is a
vmap of its batch-1 step, so each slot's token is a routing group of one
(capacity ``top_k``, nothing dropped) and never shares an expert's
capacity with another slot's (``slot_decode_fn``).

``prefill_tokens`` is the prompt-ingestion path, used by
``repro_torch.launch.serve`` and the serving loop's join.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.tree import tree_map


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


def _map_rows(fn: Callable, *trees) -> Dict:
    """``fn(*leaves, axis)`` over every leaf of the cache trees, ``axis``
    the slot-row axis of the leaf's part of the tree."""
    head = trees[0]
    out = {}
    for part in head:
        axis = 0 if part in ("prefix", "remainder") else 1
        out[part] = tree_map(lambda *leaves, a=axis: fn(*leaves, a),
                             *(t[part] for t in trees))
    return out


def init_slot_pool(model, slots: int, ctx: int, device=None) -> Dict:
    """A pool of ``slots`` independent streams: the model's batch-``slots``
    decode caches with every attention ``index`` made per row."""
    pool = model.init_decode_caches(slots, ctx, device)

    def per_row(leaf, axis):
        # a 0-d index (or a (repeats,) one under blocks) gains the row axis
        if leaf.dtype == torch.int32 and leaf.dim() == axis:
            return leaf.unsqueeze(-1).expand(leaf.shape + (slots,)).clone()
        return leaf

    return _map_rows(per_row, pool)


def slot_decode_fn(model) -> Callable:
    """The pool's decode tick: one ``decode_step`` over the batch-S pool,
    updating it in place; an MoE arch's step routes each row as its own
    group (``moe_group=1``), as the reference's vmapped batch-1 tick.

        logits, pool = tick(params, pool, tokens)   # tokens (S, 1), logits (S, 1, V)
    """
    if any(spec.mlp.kind == "moe" for spec in model.cfg.all_layers()):
        return functools.partial(model.decode_step, moe_group=1)
    return model.decode_step


def write_slot(pool, s: int, one) -> Dict:
    """Join: overwrite slot ``s``'s row of every leaf, in place, with the
    freshly prefilled batch-1 cache ``one``; returns the pool."""

    def write(p, o, axis):
        row = p.select(axis, s)
        row.copy_(o if o.dim() < p.dim() else o.select(axis, 0))
        return p

    return _map_rows(write, pool, one)


def read_slot(pool, s: int) -> Dict:
    """A copy of the batch-1 cache slot ``s`` holds: ``decode_step`` on it
    continues that stream without touching the pool."""

    def read(p, axis):
        if p.dtype == torch.int32 and p.dim() == axis + 1:  # the per-row index
            return p.select(axis, s).clone()
        return p.narrow(axis, s, 1).clone()

    return _map_rows(read, pool)
