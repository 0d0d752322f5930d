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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, AttentionSpec
from repro_torch.models import attention as attn_mod
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


def encode(params, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T, d_model) stub embeddings -> encoder memory (B, T, d).
    The frames are cast to the params' dtype first: a departure from the
    reference, where JAX promotes a bf16 tree's encoder to f32 for f32
    frames (the drivers draw the frames in the compute dtype)."""
    espec = _enc_spec(cfg)
    mlp_spec = cfg.pattern[0].mlp
    x = frames.to(params["frontend_proj"].dtype) @ params["frontend_proj"]
    T = x.shape[1]
    x = x + sinusoid_positions(T, cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(T, dtype=torch.int32, device=x.device)
    for p in _unbound(params["enc_layers"]):
        h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        x = x + attn_mod.attention_fwd(p["attn"], h, espec, None, positions)
        h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
        x = x + mlp_fwd(p["mlp"], h, mlp_spec)
    return apply_norm(params["enc_ln"], x, cfg.norm, cfg.norm_eps)


def decode_train(params, cfg: ArchConfig, memory, tokens) -> torch.Tensor:
    """Teacher-forced decoder forward -> final hidden (B, S, d)."""
    dspec = _dec_spec(cfg)
    mlp_spec = cfg.pattern[0].mlp
    x = params["embed"][tokens]
    S = x.shape[1]
    x = x + sinusoid_positions(S, cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    for p in _unbound(params["dec_layers"]):
        h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        x = x + attn_mod.attention_fwd(p["attn"], h, dspec, None, positions)
        h = apply_norm(p["ln_x"], x, cfg.norm, cfg.norm_eps)
        x = x + attn_mod.cross_attention_fwd(p["cross"], h, memory, dspec)
        h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
        x = x + mlp_fwd(p["mlp"], h, mlp_spec)
    return apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)


def unembed(params, x):
    return x @ params["embed"].T


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


def precompute_cross(params, cfg: ArchConfig, memory) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross K/V of ``memory``: (n_dec, B, T, Hk, D)."""
    cross = params["dec_layers"]["cross"]
    k = torch.einsum("btd,ndhe->nbthe", memory, cross["w_k"])
    v = torch.einsum("btd,ndhe->nbthe", memory, cross["w_v"])
    return k, v


def _cross_decode(p, x, spec, k, v):
    """x (B, 1, d) against precomputed k/v (B, T, Hk, D), unmasked."""
    H, Hk, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    B = x.shape[0]
    q = torch.einsum("bsd,dhe->bshe", x, p["w_q"]).reshape(B, 1, Hk, H // Hk, D)
    out = attn_mod._attend_unmasked(q, k, v, D).to(x.dtype)
    return torch.einsum("bshe,hed->bsd", out, p["w_o"])


def decode_step(params, cfg: ArchConfig, caches: Dict, token: torch.Tensor):
    """One decoder token against the self caches (updated IN PLACE) and the
    precomputed cross K/V. ``caches["self"]["index"]`` is (n_dec,) or, in
    the slot pool, (n_dec, B): each row's sinusoid position is its own.
    Returns (logits (B, 1, V), caches)."""
    dspec = _dec_spec(cfg)
    mlp_spec = cfg.pattern[0].mlp
    index = caches["self"]["index"][0]  # () or (B,)
    x = params["embed"][token]
    pe = sinusoid_at(index, cfg.d_model).to(x.dtype)
    x = x + (pe[:, None] if index.dim() else pe[None, None])
    layers = zip(_unbound(params["dec_layers"]), _unbound(caches["self"]),
                 caches["cross_k"].unbind(0), caches["cross_v"].unbind(0))
    for p, self_c, ck, cv in layers:
        h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        y, _ = attn_mod.attention_decode(p["attn"], h, dspec, None, self_c)
        x = x + y
        h = apply_norm(p["ln_x"], x, cfg.norm, cfg.norm_eps)
        x = x + _cross_decode(p["cross"], h, dspec, ck, cv)
        h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
        x = x + mlp_fwd(p["mlp"], h, mlp_spec)
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return unembed(params, x), caches
