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

    @torch.no_grad()
    def eval_fn(params):
        # batched eval to bound memory; drops the last partial batch, as
        # the reference does
        bs = min(EVAL_BATCH, int(tx.shape[0]))
        nb = max(tx.shape[0] // bs, 1)
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(nb):
            xb, yb = tx[i * bs:(i + 1) * bs], ty[i * bs:(i + 1) * bs]
            logits = cnn_mod.forward(params, xb)
            logp = torch.log_softmax(logits, dim=-1)
            loss = loss - torch.gather(logp, -1, yb[:, None]).sum()
            correct = correct + (logits.argmax(-1) == yb).sum()
        ntot = nb * bs
        return {"accuracy": correct / ntot, "loss": loss / ntot}

    return FLTask(
        name=cfg.name,
        init=lambda draws: cnn_mod.init_params(draws, cfg),
        loss_fn=loss_fn,
        eval_fn=eval_fn,
        client_data={"x": cx, "y": cy},
        examples_per_client=int(cx.shape[1]),
        device=dev,
    )
