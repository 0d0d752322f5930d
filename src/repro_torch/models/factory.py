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

Under a mesh (``pshard.mesh_context`` with a live ``launch.mesh.Mesh``)
every entry point runs the rank's part: ``params`` are the rank's blocks
laid out by ``sharding.params_pspecs`` (``param_specs``), a batch is the
rank's rows of a global batch split over the data axes (``global_batch``
in a prefill batch names a batch that the data axes do not split), and
caches are laid out by ``sharding.cache_pspecs``: a ``ShardedCaches``
that carries its layout, from ``prefill`` or ``init_decode_caches``; a
decode step moves each layer's caches to the layout it computes on at use.
``sgd_train_step`` updates each rank's own blocks.
``input_specs(cfg, shape)`` gives every input of the step a shape lowers,
caches included, as tensors on the meta device (nothing allocated).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import encdec, pshard, transformer
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


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is ``meta``: ``init`` with it makes
    the params tree's shapes and dtypes and allocates nothing."""

    @property
    def device(self):
        return torch.device("meta")


def _shapes_only(init: Callable, *args) -> Dict:
    """``init(*args)``, a tree made for its shapes alone, with every dispatch
    mode set aside: it is no work on any device, and its cache must not
    count in whichever step (and whichever cost counter) first asks for it."""
    with _disable_current_modes():
        return init(*args)


@functools.lru_cache(maxsize=None)
def abstract_params(cfg: ArchConfig) -> Dict:
    """``cfg``'s params tree on the meta device."""
    init = encdec.init_params if cfg.encoder is not None else transformer.init_params
    return _shapes_only(init, _MetaGenerator(), cfg)


@functools.lru_cache(maxsize=None)
def _specs_for(cfg: ArchConfig, shape: tuple) -> Dict:
    from repro_torch.launch.mesh import Mesh

    return sharding.params_pspecs(abstract_params(cfg), Mesh(dict(shape)))


def param_specs(cfg: ArchConfig, mesh=None):
    """``sharding.params_pspecs`` of ``cfg``'s tree on ``mesh`` (the current
    mesh by default; None without one)."""
    mesh = mesh if mesh is not None else pshard.current_mesh()
    if mesh is None:
        return None
    return _specs_for(cfg, tuple(mesh.shape.items()))


class ShardedCaches(dict):
    """A rank's decode caches (laid out by ``sharding.cache_pspecs``) with
    their ``layout``: (the caches' specs, the specs of the layout the decode
    step computes on, ``sharding.compute_cache_pspecs``)."""

    layout = None


def _abstract_caches(cfg: ArchConfig, batch: int, seq_len: int) -> Dict:
    init = encdec.init_decode_caches if cfg.encoder is not None \
        else transformer.init_decode_caches
    return _shapes_only(init, cfg, batch, seq_len, "meta")


def _cache_layout(cfg, batch: int, seq_len: int, mesh):
    abstract = _abstract_caches(cfg, batch, seq_len)
    return (abstract, sharding.cache_pspecs(abstract, mesh),
            sharding.compute_cache_pspecs(abstract, mesh))


def _local_zeros(abstract, specs, mesh, device):
    return tree_map(lambda t, sp: torch.zeros(sharding.local_shape(t.shape, sp, mesh),
                                              dtype=t.dtype, device=device), abstract, specs)


def _stored(caches, store, comp, mesh) -> ShardedCaches:
    """Caches in the compute layout moved to the stored one."""
    out = ShardedCaches(tree_map(lambda t, a, b: sharding.relayout(t, a, b, mesh).contiguous()
                                 if tuple(a) != tuple(b) else t, caches, comp, store))
    out.layout = (store, comp)
    return out


def _global_batch(rows: int, given=None) -> int:
    return given if given is not None else rows * pshard.axis_size(pshard.dp())


def _layout_of(caches):
    """The (stored, compute) specs of a sharded decode step's caches."""
    layout = getattr(caches, "layout", None)
    if layout is None:
        raise ValueError("a sharded decode step takes the ShardedCaches of a sharded "
                         "prefill or init_decode_caches")
    return layout


def _init_caches(cfg, init):
    def init_decode_caches(batch, seq_len, device=None):
        """Fresh caches of a global ``batch`` at context ``seq_len``; under a
        mesh the rank's blocks (a ``ShardedCaches``)."""
        mesh = pshard.current_mesh()
        if mesh is None:
            return init(batch, seq_len, device)
        abstract, store, comp = _cache_layout(cfg, batch, seq_len, mesh)
        out = ShardedCaches(_local_zeros(abstract, store, mesh, device))
        out.layout = (store, comp)
        return out

    return init_decode_caches


def _build_decoder(cfg: ArchConfig, remat: bool, mla_absorb: bool, seq_parallel: bool,
                   explicit_tp: bool, remat_save_outputs: bool) -> Model:
    def init(gen: torch.Generator):
        return transformer.init_params(gen, cfg)

    def loss(params, batch):
        specs = param_specs(cfg)
        x, aux, _ = transformer.forward(params, cfg, batch["tokens"],
                                        extra_embeds=batch.get("frontend"),
                                        mode="train", remat=remat, specs=specs,
                                        seq_shard=seq_parallel, explicit_tp=explicit_tp,
                                        remat_save_outputs=remat_save_outputs)
        ce = transformer.lm_loss(params, cfg, x, batch["labels"],
                                 vocab_chunk=_vocab_chunk(cfg, x.shape[1]), specs=specs)
        total = ce + MOE_AUX_WEIGHT * aux
        return total, {"loss": ce, "moe_aux": aux}

    def prefill(params, batch):
        specs = param_specs(cfg)
        x, _, caches = transformer.forward(params, cfg, batch["tokens"],
                                           extra_embeds=batch.get("frontend"),
                                           mode="prefill", specs=specs,
                                           seq_shard=seq_parallel)
        logits = transformer.unembed(params, cfg, x[:, -1:], specs)
        if specs is None:
            return logits, caches
        mesh = pshard.current_mesh()
        _, store, comp = _cache_layout(
            cfg, _global_batch(x.shape[0], batch.get("global_batch")), x.shape[1], mesh)
        return logits, _stored(caches, store, comp, mesh)

    def decode_step(params, caches, token, moe_group=DEFAULT_GROUP):
        specs = param_specs(cfg)
        if specs is None:
            return transformer.decode_step(params, cfg, caches, token,
                                           mla_absorb=mla_absorb, moe_group=moe_group)
        logits, _ = transformer.decode_step(params, cfg, caches, token,
                                            mla_absorb=mla_absorb, moe_group=moe_group,
                                            specs=specs, cache_layout=_layout_of(caches))
        return logits, caches

    def init_decode_caches(batch, seq_len, device=None):
        return transformer.init_decode_caches(cfg, batch, seq_len, device)

    return Model(cfg, init, loss, _sgd_step(loss), prefill, decode_step,
                 _init_caches(cfg, init_decode_caches))


def _build_encdec(cfg: ArchConfig) -> Model:
    """whisper: ``batch`` holds ``frames`` (B, T, d) and ``tokens``; a
    prefill batch also ``seq_len``, the decode context. As in the
    reference, ``prefill`` returns fresh self-attention caches (index 0:
    the prompt is not written into them) beside the prompt's cross K/V."""

    def init(gen: torch.Generator):
        return encdec.init_params(gen, cfg)

    def loss(params, batch):
        specs = param_specs(cfg)
        memory = encdec.encode(params, cfg, batch["frames"], specs)
        x = encdec.decode_train(params, cfg, memory, batch["tokens"], specs)
        ce = transformer.lm_loss({"embed": params["embed"]},
                                 dataclasses.replace(cfg, tie_embeddings=True), x,
                                 batch["labels"], vocab_chunk=_vocab_chunk(cfg, x.shape[1]),
                                 specs=None if specs is None else {"embed": specs["embed"]})
        return ce, {"loss": ce, "moe_aux": torch.zeros((), device=x.device)}

    def prefill(params, batch):
        specs = param_specs(cfg)
        memory = encdec.encode(params, cfg, batch["frames"], specs)
        x = encdec.decode_train(params, cfg, memory, batch["tokens"], specs)
        logits = encdec.unembed(params, x[:, -1:], specs)
        B = x.shape[0]
        if specs is None:
            caches = encdec.init_decode_caches(cfg, B, batch["seq_len"], x.device)
            caches["cross_k"], caches["cross_v"] = encdec.precompute_cross(params, cfg, memory)
            return logits, caches
        mesh = pshard.current_mesh()
        abstract, store, comp = _cache_layout(
            cfg, _global_batch(B, batch.get("global_batch")), batch["seq_len"], mesh)
        caches = _local_zeros(abstract, comp, mesh, x.device)
        caches["cross_k"], caches["cross_v"] = encdec.precompute_cross(params, cfg, memory,
                                                                       specs)
        return logits, _stored(caches, store, comp, mesh)

    def decode_step(params, caches, token):
        specs = param_specs(cfg)
        if specs is None:
            return encdec.decode_step(params, cfg, caches, token)
        logits, _ = encdec.decode_step(params, cfg, caches, token, specs,
                                       cache_layout=_layout_of(caches))
        return logits, caches

    def init_decode_caches(batch, seq_len, device=None):
        return encdec.init_decode_caches(cfg, batch, seq_len, device)

    return Model(cfg, init, loss, _sgd_step(loss), prefill, decode_step,
                 _init_caches(cfg, init_decode_caches))


def build(cfg: ArchConfig, remat: bool = True, mla_absorb: bool = True,
          seq_parallel: bool = False, explicit_tp: bool = False,
          remat_save_outputs: bool = False) -> Model:
    """The model API of ``cfg``. ``remat`` (the reference's default too)
    recomputes each repeated layer's activations in the backward
    (``transformer.forward``); ``mla_absorb`` picks MLA's absorbed decode.
    A decoder's ``decode_step`` also takes ``moe_group``, the MoE token
    group (``serve.batching.slot_decode_fn`` passes 1). Under a mesh:
    ``seq_parallel`` splits the residual stream over the sequence on
    ``model`` between layers, ``explicit_tp`` takes the MLP's explicit
    bf16 sum, ``remat_save_outputs`` keeps each branch's output for the
    backward (a split checkpoint); the encoder-decoder takes none of the
    three, as in the reference."""
    why = _unsupported(cfg)
    if why:
        raise NotImplementedError(f"{cfg.name}: the port's kernels do not take it: {why}")
    if cfg.encoder is not None:
        return _build_encdec(cfg)
    return _build_decoder(cfg, remat, mla_absorb, seq_parallel, explicit_tp,
                          remat_save_outputs)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict:
    """Every model input of the step ``shape`` lowers (train, prefill or
    decode), global shapes and dtypes, as tensors on the meta device:
    tokens, labels, the vision stub's ``frontend`` or the encoder's
    ``frames``; a decode step's caches and token."""
    B, S = shape.global_batch, shape.seq_len
    cdtype = dtype_of(cfg.compute_dtype)

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    i32 = torch.int32
    if shape.mode == "decode":
        return {"caches": _abstract_caches(cfg, B, S), "token": meta((B, 1), i32)}
    if cfg.encoder is not None:
        return {"frames": meta((B, cfg.encoder.source_len, cfg.d_model), cdtype),
                "tokens": meta((B, S), i32), "labels": meta((B, S), i32)}
    s_text = S - (cfg.frontend_tokens if cfg.frontend != "none" else 0)
    batch = {"tokens": meta((B, s_text), i32), "labels": meta((B, S), i32)}
    if cfg.frontend != "none":
        batch["frontend"] = meta((B, cfg.frontend_tokens, cfg.d_model), cdtype)
    if shape.mode == "prefill":
        batch.pop("labels")
    return batch


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
