"""Whisper-style encoder-decoder backbone.

Port of ``repro.models.encdec``, same parameter tree (``frontend_proj``,
``enc_layers`` and ``dec_layers`` stacked on a leading layer axis,
``enc_ln``, ``embed``, ``final_norm``) and cache tree (``self``: the
decoder's ring caches stacked on the layer axis; ``cross_k``/``cross_v``
(n_dec, B, T, Hk, D)). The mel-spectrogram and conv feature extractor is a
stub, as in the reference: ``frames`` are precomputed (B, T, d_model) frame
embeddings.

Routes: the encoder's self-attention is bidirectional, so it never reaches
K4 (which is causal) and takes the reference's kernel-off route. The
decoder's causal self-attention reaches K4 in ``decode_train`` where the
text length is a multiple of 128, and K5 in ``decode_step``. Cross
attention is unmasked plain torch, as in the reference. The decode step
updates the ``self`` caches in place.

Under a mesh (``specs``: ``sharding.params_pspecs`` of the tree) every
layer runs the rank's part through the same attention and MLP functions
as the decoder-only stack (``transformer._branch_layout``): heads (or
query rows) over ``model``, the MLP column- and row-parallel, the tied
vocab split over ``model``, the batch over the data axes.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig, AttentionSpec, LayerSpec
from repro_torch.core.tree import tree_map
from repro_torch.models import attention as attn_mod
from repro_torch.models import pshard
from repro_torch.models import transformer
from repro_torch.models.common import (
    apply_norm,
    dense_init,
    dtype_of,
    embed_init,
    init_norm,
    sinusoid_at,
    sinusoid_positions,
)
from repro_torch.models.mlp import init_mlp, mlp_fwd
from repro_torch.models.transformer import _stack, _unbound

_BRANCH = {"ln1": "ln1", "ln_x": "ln1", "ln2": "ln2", "attn": "attn", "cross": "attn",
           "mlp": "mlp"}


def _enc_spec(cfg: ArchConfig) -> AttentionSpec:
    e = cfg.encoder
    return AttentionSpec(
        num_heads=e.num_heads,
        num_kv_heads=e.num_heads,
        head_dim=cfg.d_model // e.num_heads,
        causal=False,
        rope=False,
    )


def _dec_spec(cfg: ArchConfig) -> AttentionSpec:
    return cfg.pattern[0].attn


def _n_dec(cfg: ArchConfig) -> int:
    return len(cfg.pattern) * cfg.repeats


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Dict:
    """Params drawn from ``gen`` (on its device), in the reference's tree."""
    dtype = dtype_of(cfg.param_dtype)
    dev = gen.device
    espec, dspec = _enc_spec(cfg), _dec_spec(cfg)
    mlp_spec = cfg.pattern[0].mlp

    def enc_layer():
        return {
            "ln1": init_norm(cfg.d_model, cfg.norm, dtype, dev),
            "attn": attn_mod.init_attention(gen, cfg.d_model, espec, dtype),
            "ln2": init_norm(cfg.d_model, cfg.norm, dtype, dev),
            "mlp": init_mlp(gen, cfg.d_model, mlp_spec, dtype),
        }

    def dec_layer():
        return {
            "ln1": init_norm(cfg.d_model, cfg.norm, dtype, dev),
            "attn": attn_mod.init_attention(gen, cfg.d_model, dspec, dtype),
            "ln_x": init_norm(cfg.d_model, cfg.norm, dtype, dev),
            "cross": attn_mod.init_cross_attention(gen, cfg.d_model, dspec, dtype),
            "ln2": init_norm(cfg.d_model, cfg.norm, dtype, dev),
            "mlp": init_mlp(gen, cfg.d_model, mlp_spec, dtype),
        }

    return {
        "frontend_proj": dense_init(gen, (cfg.d_model, cfg.d_model), 0, dtype),
        "enc_layers": _stack([enc_layer() for _ in range(cfg.encoder.num_layers)]),
        "enc_ln": init_norm(cfg.d_model, cfg.norm, dtype, dev),
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "dec_layers": _stack([dec_layer() for _ in range(_n_dec(cfg))]),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dtype, dev),
    }


def _layer_spec(cfg: ArchConfig, attn: AttentionSpec) -> LayerSpec:
    return LayerSpec(kind="attn", attn=attn, mlp=cfg.pattern[0].mlp)


def _per_layer(params, specs, key: str):
    """The stack ``key``'s layers (views) with their specs (None unsharded)."""
    layers = _unbound(params[key])
    if specs is None:
        return [(p, None) for p in layers]
    ps = tree_map(lambda sp: sharding.P(*sp[1:]), specs[key])
    return [(p, ps) for p in layers]


def _cross(tree):
    return {k: tree[k] for k in ("cross_k", "cross_v")}


def _materialize(p, ps, spec: LayerSpec, decode: bool = False):
    """A layer's leaves as the rank's part uses them."""
    if ps is None:
        return p
    out = {}
    for k, v in p.items():
        keep, mode = transformer._branch_layout(_BRANCH[k], spec, decode)
        out[k] = pshard.materialize_tree(v, ps[k], keep, mode)
    return out


def _top(params, specs, name):
    if specs is None:
        return params[name]
    return pshard.materialize_tree(params[name], specs[name], mode="replicated")


def encode(params, cfg: ArchConfig, frames: torch.Tensor, specs=None) -> torch.Tensor:
    """frames (B, T, d_model) stub embeddings -> encoder memory (B, T, d).
    The frames are cast to the params' dtype first: a departure from the
    reference, where JAX promotes a bf16 tree's encoder to f32 for f32
    frames (the drivers draw the frames in the compute dtype)."""
    espec = _enc_spec(cfg)
    lspec = _layer_spec(cfg, espec)
    mlp_spec = cfg.pattern[0].mlp
    proj = params["frontend_proj"]
    if specs is not None:
        proj = pshard.materialize(proj, specs["frontend_proj"], mode="replicated")
    x = frames.to(proj.dtype) @ proj
    T = x.shape[1]
    x = x + sinusoid_positions(T, cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(T, dtype=torch.int32, device=x.device)
    for p, ps in _per_layer(params, specs, "enc_layers"):
        p = _materialize(p, ps, lspec)
        h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        x = x + attn_mod.attention_fwd(p["attn"], h, espec, None, positions)
        h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
        x = x + mlp_fwd(p["mlp"], h, mlp_spec)
    return apply_norm(_top(params, specs, "enc_ln"), x, cfg.norm, cfg.norm_eps)


def decode_train(params, cfg: ArchConfig, memory, tokens, specs=None) -> torch.Tensor:
    """Teacher-forced decoder forward -> final hidden (B, S, d)."""
    dspec = _dec_spec(cfg)
    lspec = _layer_spec(cfg, dspec)
    mlp_spec = cfg.pattern[0].mlp
    x = transformer.lookup(params, tokens, specs)
    S = x.shape[1]
    x = x + sinusoid_positions(S, cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    for p, ps in _per_layer(params, specs, "dec_layers"):
        p = _materialize(p, ps, lspec)
        h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        x = x + attn_mod.attention_fwd(p["attn"], h, dspec, None, positions)
        h = apply_norm(p["ln_x"], x, cfg.norm, cfg.norm_eps)
        x = x + attn_mod.cross_attention_fwd(p["cross"], h, memory, dspec)
        h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
        x = x + mlp_fwd(p["mlp"], h, mlp_spec)
    return apply_norm(_top(params, specs, "final_norm"), x, cfg.norm, cfg.norm_eps)


def unembed(params, x, specs=None):
    if specs is None:
        return x @ params["embed"].T
    return transformer.logits_of(x, *transformer._head(params, True, specs))


# ---------------------------------------------------------------------------
# Decode with cache
# ---------------------------------------------------------------------------


def init_decode_caches(cfg: ArchConfig, batch: int, seq_len: int,
                       device=None) -> Dict:
    """Fresh decoder caches at context ``seq_len``: the self-attention rings
    (index 0) and zero cross K/V."""
    dtype = dtype_of(cfg.compute_dtype)
    dspec = _dec_spec(cfg)
    n_dec = _n_dec(cfg)
    Hk, D = dspec.num_kv_heads, dspec.head_dim
    one = attn_mod.init_cache(dspec, batch, seq_len, dtype, device)
    shape = (n_dec, batch, cfg.encoder.source_len, Hk, D)
    return {
        "self": _stack([one] * n_dec),
        "cross_k": torch.zeros(shape, dtype=dtype, device=device),
        "cross_v": torch.zeros(shape, dtype=dtype, device=device),
    }


def precompute_cross(params, cfg: ArchConfig, memory,
                     specs=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross K/V of ``memory``: (n_dec, B, T, Hk, D)
    (under a mesh the rank's kv heads where they split, else all)."""
    if specs is not None:
        lspec = _layer_spec(cfg, _dec_spec(cfg))
        ks, vs = [], []
        with torch.no_grad():
            for p, ps in _per_layer(params, specs, "dec_layers"):
                c = _materialize({"cross": p["cross"]}, ps, lspec, decode=True)["cross"]
                ks.append(torch.einsum("btd,dhe->bthe", memory, c["w_k"]))
                vs.append(torch.einsum("btd,dhe->bthe", memory, c["w_v"]))
        return torch.stack(ks), torch.stack(vs)
    cross = params["dec_layers"]["cross"]
    k = torch.einsum("btd,ndhe->nbthe", memory, cross["w_k"])
    v = torch.einsum("btd,ndhe->nbthe", memory, cross["w_v"])
    return k, v


def _cross_decode(p, x, spec, k, v):
    """x (B, 1, d) against precomputed k/v (B, T, Hk, D), unmasked."""
    route = attn_mod.cross_route(spec, decode=True)
    if route is not None:
        x = pshard.enter(x)
    return attn_mod.cross_attend(p, x, k, v, spec, route)


def decode_step(params, cfg: ArchConfig, caches: Dict, token: torch.Tensor, specs=None,
                cache_layout=None):
    """One decoder token against the self caches (updated IN PLACE) and the
    precomputed cross K/V. ``caches["self"]["index"]`` is (n_dec,) or, in
    the slot pool, (n_dec, B): each row's sinusoid position is its own.
    Under a mesh ``cache_layout`` (the stored specs, the compute specs) lays
    out the caches: each layer's moved to the compute layout at use
    (``sharding.cache_at_use``). Returns (logits (B, 1, V), caches)."""
    dspec = _dec_spec(cfg)
    lspec = _layer_spec(cfg, dspec)
    mlp_spec = cfg.pattern[0].mlp
    index = caches["self"]["index"][0]  # () or (B,)
    x = transformer.lookup(params, token, specs)
    pe = sinusoid_at(index, cfg.d_model).to(x.dtype)
    x = x + (pe[:, None] if index.dim() else pe[None, None])
    store, comp = cache_layout if cache_layout is not None else (None, None)
    mesh = pshard.current_mesh()
    cross = _cross(caches)
    for r, (p, ps) in enumerate(_per_layer(params, specs, "dec_layers")):
        p = _materialize(p, ps, lspec, decode=True)
        with sharding.cache_at_use(caches["self"], store and store["self"],
                                   comp and comp["self"], mesh, layer=r) as sc, \
                sharding.cache_at_use(cross, store and _cross(store), comp and _cross(comp),
                                      mesh, layer=r) as cc:
            h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
            y, _ = attn_mod.attention_decode(p["attn"], h, dspec, None, sc)
            x = x + y
            h = apply_norm(p["ln_x"], x, cfg.norm, cfg.norm_eps)
            x = x + _cross_decode(p["cross"], h, dspec, cc["cross_k"], cc["cross_v"])
        h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
        x = x + mlp_fwd(p["mlp"], h, mlp_spec)
    x = apply_norm(_top(params, specs, "final_norm"), x, cfg.norm, cfg.norm_eps)
    return unembed(params, x, specs), caches
