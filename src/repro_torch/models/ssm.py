"""Mamba2 (SSD, state-space duality) block. [arXiv:2405.21060]

Port of ``repro.models.ssm``. Train and prefill use the chunked dual form:
attention-like compute within chunks of ``chunk`` steps and a linear
recurrence across chunks carrying the (heads, head_dim, d_state) f32
state. ``ssm_fwd`` runs it through the K6 CUDA kernel
(``kernels.ssd_scan``) where the reference calls ``ssd_chunked``: on a CPU
tensor the wrapper takes the plain version, which is ``ssd_chunked`` here.
Training differentiates it through K6's ``autograd.Function`` (its backward
kernel on the card, the plain backward on the CPU); x, B and C reach it as
strided views of the conv output, and autograd's slice backward places
their gradients in that output's gradient.
Decode is the O(1) single-step recurrence, updating its cache in place.
Parameter names and layouts are the reference's, so a reference tree
converts key for key.

Under a mesh whose ``model`` axis splits the heads, each rank runs K6 on
its ``nh / tp`` heads with its blocks of ``D``, ``A_log``, ``dt_bias``,
``norm_scale`` and the rows of ``w_out`` (row-parallel, summed over
``model``; the gated norm's mean square is summed over the ranks first).
``w_in`` ((d, 2 di + 2 ds + nh)) and the conv's ``di + 2 ds`` channels are
cut by the rules into contiguous blocks that do not fall on head
boundaries (z, x, B, C and dt share the axis), so the layer all-gathers
them at use and computes the whole projection and conv on every rank,
keeping its heads' channels of z, x and dt (B and C are shared by all
heads); their gradients are reduce-scattered back. Heads that ``model``
does not split leave the layer replicated.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMSpec
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models import pshard
from repro_torch.models.common import dense_init

ssd_chunked = _ssd.ssd_chunked_plain


def init_ssm(gen: torch.Generator, d_model: int, spec: SSMSpec, dtype) -> Dict:
    """Params drawn from ``gen`` (on its device), the reference's leaves."""
    di, ds, nh = spec.d_inner, spec.d_state, spec.num_heads
    conv_ch = di + 2 * ds
    dev = gen.device
    w_in = dense_init(gen, (d_model, 2 * di + 2 * ds + nh), 0, dtype)
    conv_w = (torch.randn((spec.conv_width, conv_ch), generator=gen, device=dev)
              * 0.1).to(dtype)
    w_out = dense_init(gen, (di, d_model), 0, dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # in_proj -> [z (di), x (di), B (ds), C (ds), dt (nh)]
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.full((nh,), float(np.log(np.expm1(0.01))), **f32),
        "D": torch.ones((nh,), **f32),
        "norm_scale": torch.ones((di,), dtype=dtype, device=dev),
        "w_out": w_out,
    }


def _split_in(p, x, spec: SSMSpec):
    di, ds = spec.d_inner, spec.d_state
    proj = x @ p["w_in"]
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * ds]
    dt_raw = proj[..., di + di + 2 * ds:]
    return z, xbc, dt_raw


def _causal_conv(p, xbc, spec: SSMSpec):
    """Depthwise causal conv via shifted adds (width is tiny)."""
    w = p["conv_w"]  # (W, ch)
    W = w.shape[0]
    out = xbc * w[W - 1]
    for i in range(W - 1):
        shift = W - 1 - i
        shifted = F.pad(xbc, (0, 0, shift, 0))[:, :xbc.shape[1]]
        out = out + shifted * w[i]
    return F.silu(out + p["conv_b"])


def _gated_norm(p, y, z, eps=1e-5, width=None):
    """RMS-normed ``y * silu(z)``; with ``width`` (the rank holds a block of
    its channels) the mean square is over all ``width`` channels, the
    ranks' sums of squares summed over ``model``."""
    g = y * F.silu(z)
    gf = g.float()
    if width is None:
        var = (gf * gf).mean(-1, keepdim=True)
    else:  # the sum is used by every rank's own channels: summed both ways
        ss = pshard.copy(pshard.psum((gf * gf).sum(-1, keepdim=True), "model"), "model")
        var = ss / width
    return (gf * torch.rsqrt(var + eps)).to(y.dtype) * p["norm_scale"]


def heads_parallel(spec: SSMSpec) -> bool:
    tp = pshard.axis_size("model")
    return tp > 1 and spec.num_heads % tp == 0


def sharded_dims(spec: SSMSpec) -> Dict:
    """The dims of each leaf's block the layer consumes as they lie over
    ``model`` (``w_in`` and the conv are gathered)."""
    if not heads_parallel(spec):
        return {}
    return {"A_log": (0,), "dt_bias": (0,), "D": (0,), "norm_scale": (0,), "w_out": (0,)}


def _rank_heads(z, xin, dt_raw, spec: SSMSpec):
    """The rank's heads' channels of z, x (di wide) and dt (nh wide)."""
    tp = pshard.axis_size("model")
    nl = spec.num_heads // tp
    dl = nl * spec.head_dim
    r = pshard.index("model")
    return z.narrow(-1, r * dl, dl), xin.narrow(-1, r * dl, dl), dt_raw.narrow(-1, r * nl, nl)


def _out_proj(p, y, z, spec: SSMSpec, par: bool, dtype):
    if not par:
        return _gated_norm(p, y, z) @ p["w_out"]
    normed = _gated_norm(p, y, z, width=spec.d_inner)
    return pshard.leave(normed.float() @ p["w_out"].float()).to(dtype)


def ssd_reference(x, dt, A, B_, C_, h0=None):
    """Naive step-by-step recurrence (oracle for tests), in f32 (f64 for
    f64 inputs). Returns (y (B, S, nh, hd), h_final)."""
    Bb, S, nh, hd = x.shape
    ds = B_.shape[-1]
    wide = _ssd._wide
    h = (torch.zeros((Bb, nh, hd, ds), dtype=_ssd._wide_dtype(x), device=x.device)
         if h0 is None else h0)
    ys = []
    for t in range(S):
        dtt = wide(dt[:, t])
        a = torch.exp(dtt * A)  # (B, nh)
        upd = torch.einsum("bh,bhp,bn->bhpn", dtt, wide(x[:, t]), wide(B_[:, t]))
        h = a[:, :, None, None] * h + upd
        ys.append(torch.einsum("bn,bhpn->bhp", wide(C_[:, t]), h))
    return torch.stack(ys, dim=1), h


def _ssm_fwd(p: Dict, x: torch.Tensor, spec: SSMSpec, h0=None):
    """(out (B, S, d_model), h_final, xbc before the conv)."""
    di, ds, hd = spec.d_inner, spec.d_state, spec.head_dim
    par = heads_parallel(spec)
    if par:
        x = pshard.enter(x, torch.float32)
    z, xbc_in, dt_raw = _split_in(p, x, spec)
    xbc = _causal_conv(p, xbc_in, spec)
    xin = xbc[..., :di]
    B_ = xbc[..., di:di + ds]
    C_ = xbc[..., di + ds:]
    if par:
        z, xin, dt_raw = _rank_heads(z, xin, dt_raw, spec)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(*xin.shape[:2], dt.shape[-1], hd)  # a view of xbc: strides, no copy
    y, h = _ssd.ssd_scan(xh, dt, A, B_, C_, spec.chunk, h0)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(*x.shape[:2], xin.shape[-1]).to(x.dtype)
    return _out_proj(p, y, z, spec, par, x.dtype), h, xbc_in


def ssm_fwd(p: Dict, x: torch.Tensor, spec: SSMSpec, h0=None,
            return_state: bool = False):
    """Full-sequence mamba2 block. x: (B, S, d_model). The scan is the K6
    kernel on the GPU (``kernels.ssd_scan``), ``ssd_chunked`` on the CPU;
    under autograd or ``torch.func`` K6's Function, forward and backward."""
    out, h, _ = _ssm_fwd(p, x, spec, h0)
    if return_state:
        return out, h
    return out


# ---------------------------------------------------------------------------
# Decode (O(1) recurrence)
# ---------------------------------------------------------------------------


def init_ssm_cache(spec: SSMSpec, batch: int, dtype, device=None) -> Dict:
    conv_ch = spec.d_inner + 2 * spec.d_state
    return {
        "h": torch.zeros((batch, spec.num_heads, spec.head_dim, spec.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, spec.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def ssm_decode(p: Dict, x: torch.Tensor, spec: SSMSpec, cache: Dict):
    """x: (B, 1, d_model) -> (y, cache). The cache's ``h`` and ``conv`` are
    updated IN PLACE (no host sync) and returned."""
    di, ds, hd = spec.d_inner, spec.d_state, spec.head_dim
    par = heads_parallel(spec)
    if par:
        x = pshard.enter(x)
    z, xbc, dt_raw = _split_in(p, x, spec)  # (B, 1, .)
    # conv over [cache, current]; hist is a new tensor, so its shifted tail
    # can be copied into the cache without overlapping it
    hist = torch.cat([cache["conv"], xbc], dim=1)  # (B, W, ch)
    conv_out = torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"]
    xbc1 = F.silu(conv_out)[:, None]  # (B, 1, ch)
    xin = xbc1[..., :di]
    B_ = xbc1[:, 0, di:di + ds].float()
    C_ = xbc1[:, 0, di + ds:].float()
    if par:
        z, xin, dt_raw = _rank_heads(z, xin, dt_raw, spec)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])[:, 0]  # (B, nh)
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(x.shape[0], dt.shape[-1], hd)
    a = torch.exp(dt * A)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh.float(), B_)
    h = cache["h"]
    h.mul_(a[:, :, None, None]).add_(upd)
    y = torch.einsum("bn,bhpn->bhp", C_, h)
    y = y + p["D"][None, :, None] * xh.float()
    y = y.reshape(x.shape[0], 1, xin.shape[-1]).to(x.dtype)
    out = _out_proj(p, y, z, spec, par, x.dtype)
    cache["conv"].copy_(hist[:, 1:])
    return out, cache
