"""FL task abstraction: client-sharded data on a device plus a loss.

Only the paper's CNN classification task is ported so far; the causal-LM
task (``repro.fl.task.make_lm_task``) arrives with LM training, ROADMAP queue 1,
slice G2.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.data import partition_dirichlet, partition_iid
from repro_torch.data.synthetic import ImageDataset
from repro_torch.device import resolve_device
from repro_torch.models import cnn as cnn_mod

EVAL_BATCH = 500


@dataclasses.dataclass(frozen=True)
class FLTask:
    name: str
    init: Callable  # draws -> params
    loss_fn: Callable  # (params, batch) -> scalar
    eval_fn: Callable  # (params) -> dict (accuracy/loss on held-out data)
    client_data: Dict  # tensors on ``device``, leading axis = n_clients
    examples_per_client: int
    device: torch.device
    # batched eval over held-out data (``eval_batch_fn(params, eval_data)``
    # -> the *summed* metrics of those examples), so a cohort-parallel
    # engine can split the eval examples over ranks and merge the sums.
    # ``eval_data``'s leading axis is the usable eval prefix ``eval_fn``
    # scores (it drops the last partial batch). Tasks without these fields
    # fall back to the replicated ``eval_fn`` everywhere.
    eval_data: Optional[Dict] = None  # tensors, leading axis = eval examples
    eval_batch_fn: Optional[Callable] = None  # (params, eval_data) -> dict


def make_cnn_task(
    cfg: CNNConfig,
    train: ImageDataset,
    test: ImageDataset,
    n_clients: int,
    noniid_alpha: Optional[float] = None,
    seed: int = 0,
    device=None,
) -> FLTask:
    """The paper's CNN task over ``n_clients`` equal shards of ``train``,
    with all data on ``device`` (the GPU unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    if noniid_alpha is None:
        parts = partition_iid(len(train.labels), n_clients, seed)
    else:
        parts = partition_dirichlet(train.labels, n_clients, alpha=noniid_alpha,
                                    seed=seed)
    cx = torch.as_tensor(train.images[parts], device=dev)  # (n, shard, H, W, C)
    cy = torch.as_tensor(train.labels[parts], device=dev).long()  # (n, shard)
    tx = torch.as_tensor(test.images, device=dev)
    ty = torch.as_tensor(test.labels, device=dev).long()

    def loss_fn(params, batch):
        return cnn_mod.cross_entropy(cnn_mod.forward(params, batch["x"]), batch["y"])

    bs = min(EVAL_BATCH, int(tx.shape[0]))
    nb = max(tx.shape[0] // bs, 1)
    n_used = nb * bs

    def eval_sums(params, x, y):
        # batched to bound memory: summed NLL and correct count
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(0, x.shape[0], bs):
            xb, yb = x[i:i + bs], y[i:i + bs]
            logits = cnn_mod.forward(params, xb)
            logp = torch.log_softmax(logits, dim=-1)
            loss = loss - torch.gather(logp, -1, yb[:, None]).sum()
            correct = correct + (logits.argmax(-1) == yb).sum()
        return {"accuracy": correct.to(torch.float32), "loss": loss}

    @torch.no_grad()
    def eval_fn(params):
        # drops the last partial batch, as the reference does
        sums = eval_sums(params, tx[:n_used], ty[:n_used])
        return {"accuracy": sums["accuracy"] / n_used, "loss": sums["loss"] / n_used}

    return FLTask(
        name=cfg.name,
        init=lambda draws: cnn_mod.init_params(draws, cfg),
        loss_fn=loss_fn,
        eval_fn=eval_fn,
        client_data={"x": cx, "y": cy},
        examples_per_client=int(cx.shape[1]),
        device=dev,
        eval_data={"x": tx[:n_used], "y": ty[:n_used]},
        eval_batch_fn=lambda params, data: eval_sums(params, data["x"], data["y"]),
    )
