"""Uniform model API over every architecture the port runs.

    model = build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    loss, metrics = model.loss(params, batch)
    new_params, metrics = model.sgd_train_step(params, batch, lr)
    logits, caches = model.prefill(params, batch)
    logits, caches = model.decode_step(params, caches, token)

Port of ``repro.models.factory`` for every architecture the reference
registers: decoders (dense, windowed, MLA, MoE, hybrid mamba:attention,
pure Mamba2, with or without the vision stub) and the whisper
encoder-decoder. ``build`` refuses only a shape that a kernel on the
model's path does not take. Training runs through autograd: on the card
attention takes K4 forward and backward, a Mamba2 scan K6 forward and
backward (their autograd Functions); on the CPU the same Functions take
the plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import encdec, transformer
from repro_torch.models.moe import DEFAULT_GROUP
from repro_torch.models.common import dtype_of
from repro_torch.optim.optimizers import scale

MOE_AUX_WEIGHT = 0.01


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
    """Why the port's kernels cannot run ``cfg`` ('' if they can): a head
    dim that K4/K5 is not built for on a layer that reaches them (MLA and
    the bidirectional encoder do not), or a Mamba2 shape that K6 is not."""
    for spec in cfg.all_layers():
        a = spec.attn
        if spec.kind == "mamba":
            s = spec.ssm
            if (s.head_dim, s.d_state) not in ssd_scan.SHAPES:
                return (f"(head_dim, d_state) {(s.head_dim, s.d_state)} is not one "
                        f"the K6 kernel takes {ssd_scan.SHAPES}")
        elif not a.is_mla and a.head_dim not in HEAD_DIMS:
            return f"head_dim {a.head_dim} is not one the K4/K5 kernels take {HEAD_DIMS}"
    return ""


def _sgd_step(loss):
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

    return sgd_train_step


def _build_decoder(cfg: ArchConfig, remat: bool, mla_absorb: bool) -> Model:
    def init(gen: torch.Generator):
        return transformer.init_params(gen, cfg)

    def loss(params, batch):
        x, aux, _ = transformer.forward(params, cfg, batch["tokens"],
                                        extra_embeds=batch.get("frontend"),
                                        mode="train", remat=remat)
        ce = transformer.lm_loss(params, cfg, x, batch["labels"],
                                 vocab_chunk=_vocab_chunk(cfg, x.shape[1]))
        total = ce + MOE_AUX_WEIGHT * aux
        return total, {"loss": ce, "moe_aux": aux}

    def prefill(params, batch):
        x, _, caches = transformer.forward(params, cfg, batch["tokens"],
                                           extra_embeds=batch.get("frontend"),
                                           mode="prefill")
        return transformer.unembed(params, cfg, x[:, -1:]), caches

    def decode_step(params, caches, token, moe_group=DEFAULT_GROUP):
        return transformer.decode_step(params, cfg, caches, token, mla_absorb=mla_absorb,
                                       moe_group=moe_group)

    def init_decode_caches(batch, seq_len, device=None):
        return transformer.init_decode_caches(cfg, batch, seq_len, device)

    return Model(cfg, init, loss, _sgd_step(loss), prefill, decode_step,
                 init_decode_caches)


def _build_encdec(cfg: ArchConfig) -> Model:
    """whisper: ``batch`` holds ``frames`` (B, T, d) and ``tokens``; a
    prefill batch also ``seq_len``, the decode context. As in the
    reference, ``prefill`` returns fresh self-attention caches (index 0:
    the prompt is not written into them) beside the prompt's cross K/V."""

    def init(gen: torch.Generator):
        return encdec.init_params(gen, cfg)

    def loss(params, batch):
        memory = encdec.encode(params, cfg, batch["frames"])
        x = encdec.decode_train(params, cfg, memory, batch["tokens"])
        ce = transformer.lm_loss({"embed": params["embed"]},
                                 dataclasses.replace(cfg, tie_embeddings=True), x,
                                 batch["labels"], vocab_chunk=_vocab_chunk(cfg, x.shape[1]))
        return ce, {"loss": ce, "moe_aux": torch.zeros((), device=x.device)}

    def prefill(params, batch):
        memory = encdec.encode(params, cfg, batch["frames"])
        x = encdec.decode_train(params, cfg, memory, batch["tokens"])
        caches = encdec.init_decode_caches(cfg, batch["tokens"].shape[0],
                                           batch["seq_len"], x.device)
        caches["cross_k"], caches["cross_v"] = encdec.precompute_cross(params, cfg, memory)
        return encdec.unembed(params, x[:, -1:]), caches

    def decode_step(params, caches, token):
        return encdec.decode_step(params, cfg, caches, token)

    def init_decode_caches(batch, seq_len, device=None):
        return encdec.init_decode_caches(cfg, batch, seq_len, device)

    return Model(cfg, init, loss, _sgd_step(loss), prefill, decode_step,
                 init_decode_caches)


def build(cfg: ArchConfig, remat: bool = True, mla_absorb: bool = True) -> Model:
    """The model API of ``cfg``. ``remat`` (the reference's default too)
    recomputes each repeated layer's activations in the backward
    (``transformer.forward``); ``mla_absorb`` picks MLA's absorbed decode.
    A decoder's ``decode_step`` also takes ``moe_group``, the MoE token
    group (``serve.batching.slot_decode_fn`` passes 1)."""
    why = _unsupported(cfg)
    if why:
        raise NotImplementedError(f"{cfg.name}: the port's kernels do not take it: {why}")
    if cfg.encoder is not None:
        return _build_encdec(cfg)
    return _build_decoder(cfg, remat, mla_absorb)


def synth_batch(gen: torch.Generator, cfg: ArchConfig, batch: int,
                seq_len: int) -> Dict:
    """Random inputs (on the generator's device), as the reference's
    ``synth_batch``: tokens and labels; an encoder's ``frames`` (B, T, d);
    the vision stub's ``frontend`` (B, P, d) embeddings, with the text cut
    to ``seq_len - P`` tokens and the labels' first P positions -1
    (ignored). Embeddings are standard normal in the compute dtype."""
    dev = gen.device
    cdtype = dtype_of(cfg.compute_dtype)

    def ints(n):
        return torch.randint(0, cfg.vocab_size, (batch, n), generator=gen, device=dev,
                             dtype=torch.int32)

    def normal(n):
        return torch.randn((batch, n, cfg.d_model), generator=gen, device=dev).to(cdtype)

    if cfg.encoder is not None:
        return {"frames": normal(cfg.encoder.source_len), "tokens": ints(seq_len),
                "labels": ints(seq_len)}
    ft = cfg.frontend_tokens if cfg.frontend != "none" else 0
    out = {"tokens": ints(seq_len - ft),
           "labels": torch.cat([torch.full((batch, ft), -1, dtype=torch.int32, device=dev),
                                ints(seq_len - ft)], dim=1)}
    if ft:
        out["frontend"] = normal(ft)
    return out
