"""FL task abstraction: client-sharded data on a device plus a loss.

Two constructors, as in ``repro.fl.task``: the paper's CNN classification
task, and a causal-LM task so an assigned architecture (reduced variant on
the CPU, or any the port builds on the card) can be the federated workload.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.data import partition_dirichlet, partition_iid
from repro_torch.data.synthetic import ImageDataset, make_token_stream
from repro_torch.device import resolve_device
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import factory

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


# ---------------------------------------------------------------------------
# Causal-LM task (an assigned architecture as the FL workload)
# ---------------------------------------------------------------------------


def _lm_docs(vocab_size: int, n_docs: int, seq_len: int, seed: int) -> np.ndarray:
    """``n_docs`` consecutive windows of ``seq_len + 1`` tokens of one
    ``make_token_stream`` (the reference's sliding-window cut)."""
    stream = make_token_stream(vocab_size, n_docs * (seq_len + 1) + seq_len, seed)
    return np.array(np.lib.stride_tricks.sliding_window_view(stream, seq_len + 1)[
        ::seq_len + 1][:n_docs])


def make_lm_task(
    cfg: ArchConfig,
    n_clients: int,
    seq_len: int = 128,
    docs_per_client: int = 16,
    seed: int = 0,
    device=None,
) -> FLTask:
    """``n_clients`` shards of ``docs_per_client`` token documents of
    ``seq_len + 1`` tokens from ``make_token_stream(seed)``, and 32 held-out
    documents from seed ``seed + 99``: the reference's documents exactly,
    as int32 on ``device`` (the GPU unless ``"cpu"`` is asked for).
    ``loss_fn`` is the model's mean next-token cross entropy of a batch of
    documents; ``eval_fn`` scores the held-out set (``accuracy`` is minus
    the loss: higher is better); ``eval_batch_fn`` returns the summed
    metrics of its documents. ``init`` draws the params from the run's
    ``params`` sub-stream (a generator source)."""
    dev = resolve_device(device)
    model = factory.build(cfg)
    docs = _lm_docs(cfg.vocab_size, n_clients * docs_per_client, seq_len, seed)
    cdocs = torch.as_tensor(docs.reshape(n_clients, docs_per_client, seq_len + 1),
                            device=dev)
    held = torch.as_tensor(_lm_docs(cfg.vocab_size, 32, seq_len, seed + 99), device=dev)

    def loss_fn(params, batch):
        docs_b = batch["docs"]  # (bs, seq + 1)
        loss, _ = model.loss(params, {"tokens": docs_b[:, :-1], "labels": docs_b[:, 1:]})
        return loss

    @torch.no_grad()
    def eval_fn(params):
        loss = loss_fn(params, {"docs": held})
        return {"loss": loss, "accuracy": -loss}  # higher is better convention

    @torch.no_grad()
    def eval_batch_fn(params, data):
        # every document has seq_len labels, so the mean over documents of
        # the per-batch mean is the held-out mean: the sum is n times it
        total = loss_fn(params, data) * data["docs"].shape[0]
        return {"loss": total, "accuracy": -total}

    return FLTask(
        name=f"lm:{cfg.name}",
        init=lambda draws: model.init(draws.sub("params").generator),
        loss_fn=loss_fn,
        eval_fn=eval_fn,
        client_data={"docs": cdocs},
        examples_per_client=docs_per_client,
        device=dev,
        eval_data={"docs": held},
        eval_batch_fn=eval_batch_fn,
    )
