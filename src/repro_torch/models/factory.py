"""Uniform model API over the decoder architectures the port runs.

    model = build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    loss, metrics = model.loss(params, batch)
    new_params, metrics = model.sgd_train_step(params, batch, lr)
    logits, caches = model.prefill(params, batch)
    logits, caches = model.decode_step(params, caches, token)

Port of ``repro.models.factory`` for dense attention decoders and pure
Mamba2 (SSD) stacks. ``build`` raises for what the port cannot run yet,
naming the slice that brings it. Training runs through autograd: on the
card a dense decoder's attention takes K4 forward and backward, a Mamba2
stack's scan K6 forward and backward (their autograd Functions); on the
CPU the same Functions take the plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import transformer
from repro_torch.optim.optimizers import scale

MOE_AUX_WEIGHT = 0.01
_LATER = ("ROADMAP queue 1, slice G3 (MoE, MLA, hybrid SSM, windowed and "
          "multimodal models)")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable  # (generator) -> params on the generator's device
    loss: Callable  # (params, batch) -> (scalar, metrics)
    sgd_train_step: Callable  # (params, batch, lr) -> (params, metrics)
    prefill: Callable  # (params, batch) -> (logits, caches)
    decode_step: Callable  # (params, caches, token) -> (logits, caches)
    init_decode_caches: Callable  # (batch, seq_len, device) -> caches


def _vocab_chunk(cfg: ArchConfig, seq_len: int) -> int:
    return 512 if cfg.vocab_size * seq_len > 2**27 else 0


def _unsupported(cfg: ArchConfig) -> str:
    """Why this slice cannot run ``cfg`` ('' if it can)."""
    if cfg.encoder is not None:
        return f"encoder-decoder models arrive with {_LATER}"
    if cfg.frontend != "none":
        return f"frontend stubs arrive with {_LATER}"
    if len({spec.kind for spec in cfg.all_layers()}) > 1:
        return f"hybrid attention and SSM stacks arrive with {_LATER}"
    for spec in cfg.all_layers():
        a = spec.attn
        if spec.mlp.kind == "moe":
            return f"MoE layers arrive with {_LATER}"
        if spec.kind == "mamba":
            s = spec.ssm
            if (s.head_dim, s.d_state) not in ssd_scan.SHAPES:
                return (f"(head_dim, d_state) {(s.head_dim, s.d_state)} is not one "
                        f"the K6 kernel takes {ssd_scan.SHAPES}")
            continue
        if a.is_mla:
            return f"MLA attention arrives with {_LATER}"
        if a.kind != "full":
            return f"{a.kind} attention arrives with {_LATER}"
        if a.qk_norm:
            return f"qk_norm arrives with {_LATER}"
        if not a.causal:
            return f"bidirectional attention arrives with {_LATER}"
        if a.head_dim not in HEAD_DIMS:
            return f"head_dim {a.head_dim} is not one the K4/K5 kernels take {HEAD_DIMS}"
    return ""


def build(cfg: ArchConfig, remat: bool = True) -> Model:
    """The model API of ``cfg``. ``remat`` (the reference's default too)
    recomputes each repeated layer's activations in the backward
    (``transformer.forward``)."""
    why = _unsupported(cfg)
    if why:
        raise NotImplementedError(f"{cfg.name}: not ported to repro_torch yet: {why}")

    def init(gen: torch.Generator):
        return transformer.init_params(gen, cfg)

    def loss(params, batch):
        x, aux, _ = transformer.forward(params, cfg, batch["tokens"], mode="train",
                                        remat=remat)
        ce = transformer.lm_loss(params, cfg, x, batch["labels"],
                                 vocab_chunk=_vocab_chunk(cfg, x.shape[1]))
        total = ce + MOE_AUX_WEIGHT * aux
        return total, {"loss": ce, "moe_aux": aux}

    def sgd_train_step(params, batch, lr):
        """One SGD step on ``loss``: ``p - lr * g`` with ``lr * g`` in the
        leaf's dtype (``lr`` rounded to it first), as the reference rounds
        a Python-float ``lr`` (``lr`` a Python float or a 0-d float32
        tensor on the params' device). Returns the new params
        and ``{loss, moe_aux, total_loss}`` as device tensors (no host
        sync)."""
        with torch.enable_grad():
            tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
            total, metrics = loss(tracked, batch)
            leaves = tree_leaves(tracked)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        it = iter(g if g is not None else torch.zeros_like(p) for p, g in zip(leaves, grads))
        grads = tree_map(lambda _: next(it), params)
        new_params = tree_map(lambda p, g: (p.detach() - scale(lr, g, p.dtype)).to(p.dtype),
                              params, grads)
        return new_params, {**{k: v.detach() for k, v in metrics.items()},
                            "total_loss": total.detach()}

    def prefill(params, batch):
        x, _, caches = transformer.forward(params, cfg, batch["tokens"], mode="prefill")
        return transformer.unembed(params, cfg, x[:, -1:]), caches

    def decode_step(params, caches, token):
        return transformer.decode_step(params, cfg, caches, token)

    def init_decode_caches(batch, seq_len, device=None):
        return transformer.init_decode_caches(cfg, batch, seq_len, device)

    return Model(cfg, init, loss, sgd_train_step, prefill, decode_step,
                 init_decode_caches)


def synth_batch(gen: torch.Generator, cfg: ArchConfig, batch: int,
                seq_len: int) -> Dict:
    """Random tokens and labels (on the generator's device), as the
    reference's ``synth_batch`` for a decoder without a frontend."""
    dev = gen.device
    return {
        "tokens": torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=gen,
                                device=dev, dtype=torch.int32),
        "labels": torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=gen,
                                device=dev, dtype=torch.int32),
    }
