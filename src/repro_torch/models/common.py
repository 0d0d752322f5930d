"""Shared layer primitives of the LM: norms, RoPE, initializers.

Port of ``repro.models.common``. Initializers draw from a
``torch.Generator`` (the tensors land on its device), with the
reference's distributions; the bits differ from ``jax.random``'s, so
parity tests load the reference's params through ``repro_torch.convert``.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Scaled normal (fan-in) initializer: N(0, 1) / sqrt(shape[in_axis])."""
    scale = 1.0 / math.sqrt(max(shape[in_axis], 1))
    return (_normal(gen, shape) * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return (_normal(gen, shape) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms (computed in f32, cast back to the input's dtype)
# ---------------------------------------------------------------------------


def init_norm(d: int, kind: str, dtype=torch.float32, device=None):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(params, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    else:
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rms_norm_headwise(scale: torch.Tensor, x: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last (head) dim — gemma3 qk-norm."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, rope_frac: float = 1.0,
                     device=None):
    """(f32 inverse frequencies of the rotated sub-dimension, its width)."""
    rot = int(head_dim * rope_frac) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    return torch.as_tensor(inv, dtype=torch.float32, device=device), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
               rot: int) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int. The angles and the
    rotation are f32; the result is cast back to x's dtype."""
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    ang = positions[..., :, None, None].float() * inv_freq  # (..., S, 1, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


def activation(name: str) -> Callable:
    """jax.nn's silu / gelu (tanh approximation, jax's default) / relu."""
    return {"silu": F.silu, "gelu": lambda t: F.gelu(t, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# Fixed sinusoidal positions (the encoder-decoder)
# ---------------------------------------------------------------------------


def sinusoid_positions(length: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal table (length, d_model), computed in
    float64 and rounded to f32 as the reference's numpy table."""
    pos = np.arange(length)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    ang = pos / (10000.0 ** (dim / max(d_model // 2 - 1, 1)))
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(table, dtype=torch.float32, device=device)


def sinusoid_at(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """The sinusoidal embedding at integer position(s) ``pos`` on the
    device, in f32: () -> (d_model,), (B,) -> (B, d_model)."""
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[..., None] / torch.pow(10000.0, dim / max(d_model // 2 - 1, 1))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
