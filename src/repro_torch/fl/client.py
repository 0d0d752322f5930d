"""Client local training: E epochs of SGD over each client shard (FedAvg
step (i)), for a whole cohort at once.

The reference writes one client's update and ``vmap``s it over the
cohort; here the cohort axis is written out: ``torch.func.vmap`` of
``grad`` over the stacked per-slot params and batches, and a Python loop
over the SGD steps (the reference's ``lax.scan``).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.tree import tree_map


def make_local_update(
    loss_fn: Callable, epochs: int, batch_size: int, examples: int
) -> Callable:
    """Returns f(params, shards, draws, lr) -> (params, mean_loss) over a
    cohort: every leaf of ``params``/``shards`` and ``lr`` carry a leading
    cohort axis B.

    Each epoch reshuffles each shard (one permutation per slot and epoch,
    drawn at site ``local_perm``) truncated to ``nb * bs`` examples, and
    runs ``nb = max(examples // batch_size, 1)`` SGD steps of batch
    ``bs = min(batch_size, examples)`` (paper: E=5, B=50). The loss is the
    mean over the steps.

    ``perm_rows = (width, rows)`` trains a slice of a wider cohort: the
    permutations are drawn for all ``width`` slots (so the draws are the
    whole cohort's) and slot ``j`` uses row ``rows[j]`` (a (B,) index
    tensor) — the cohort-parallel engines' slice of the padded cohort.
    """
    nb = max(examples // batch_size, 1)
    bs = min(batch_size, examples)
    step_grad = vmap(grad_and_value(loss_fn))

    def local_update(params: Dict, shards: Dict, draws, lr: torch.Tensor,
                     perm_rows=None):
        B = lr.shape[0]
        if perm_rows is None:
            perms = draws.permutation("local_perm", examples, batch=(B, epochs))
        else:
            width, rows = perm_rows
            perms = draws.permutation("local_perm", examples,
                                      batch=(width, epochs))[rows]
        perms = perms[..., : nb * bs].reshape(B, epochs * nb, bs)
        rows = torch.arange(B, device=lr.device)[:, None]
        losses = []
        for s in range(epochs * nb):
            idx = perms[:, s]
            batch = {k: a[rows, idx] for k, a in shards.items()}
            g, loss = step_grad(params, batch)
            params = tree_map(
                lambda w, gw: w - lr.view((-1,) + (1,) * (w.dim() - 1)) * gw,
                params, g,
            )
            losses.append(loss)
        return params, torch.stack(losses, dim=1).mean(dim=1)

    return local_update
