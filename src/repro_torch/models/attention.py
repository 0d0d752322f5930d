"""Attention layers (GQA/MHA, with causal, sliding-window and chunked
masks): train/prefill forward and cached single-token decode.

Port of ``repro.models.attention``, same names, parameter layouts
(``w_q`` (d_model, H, D), ``w_o`` (H, D, d_model)) and cache layout
(``k``/``v`` (B, L, Hk, D) ring buffers with a 0-d int32 ``index``; the
serving tier's slot pool gives each row its own index, a (B,) one).

Full-sequence attention goes through K4 (``kernels.flash_attention``)
when ``set_kernel_attention`` is on (the default here, the reference's
"TPU deployments" setting) and the shape meets the kernel's conditions;
otherwise it takes the reference's kernel-off route (``_attend_direct``
or the blocked online softmax ``_attend_flash_jnp``). In training the K4
route is differentiable through K4's autograd Function, whose backward is
a kernel too; the reference trains with its kernel off, so its gradient
there is autodiff of the direct route (the same function). The decode step of a
``full`` layer goes through K5 (``kernels.flash_decode``): its ring mask
keeps exactly the slots ``0 .. min(index + 1, L) - 1``, a prefix, which is
what K5's ``valid_len`` masks. MLA and cross attention are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AttentionSpec
from repro_torch.kernels import ops as kops
from repro_torch.models.common import apply_rope, dense_init, rms_norm_headwise

BLOCK_Q = 1024
BLOCK_K = 1024
FLASH_THRESHOLD = 2048  # use blocked attention above this seq length

# When enabled, full-sequence attention runs through the K4 kernel instead
# of the kernel-off route. Positions must be 0..S-1 (train/prefill),
# S % 128 == 0. On in the port: it serves on the GPU.
_USE_KERNEL = True


def set_kernel_attention(enabled: bool) -> None:
    global _USE_KERNEL
    _USE_KERNEL = enabled


def _mla_not_ported():
    return NotImplementedError(
        "MLA attention (deepseek-v2) is not ported to repro_torch yet: it "
        "arrives with ROADMAP queue 1, slice G3 (MoE, MLA, SSM and windowed "
        "models)")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, d_model: int, spec: AttentionSpec,
                   dtype) -> Dict:
    if spec.is_mla:
        raise _mla_not_ported()
    H, Hk, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    p: Dict = {
        "w_q": dense_init(gen, (d_model, H, D), 0, dtype),
        "w_k": dense_init(gen, (d_model, Hk, D), 0, dtype),
        "w_v": dense_init(gen, (d_model, Hk, D), 0, dtype),
        "w_o": dense_init(gen, (H, D, d_model), 0, dtype),
    }
    if spec.qk_norm:
        p["q_norm"] = torch.ones((D,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((D,), dtype=dtype, device=gen.device)
    return p


# ---------------------------------------------------------------------------
# Mask helpers
# ---------------------------------------------------------------------------


def _pair_mask(spec: AttentionSpec, q_pos, k_pos):
    """(..., Q, K) boolean validity from absolute positions."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                    device=q.device)
    if spec.causal:
        ok &= k <= q
    if spec.kind == "sliding" and spec.window > 0:
        ok &= k > q - spec.window
    elif spec.kind == "chunked" and spec.window > 0:
        ok &= (k // spec.window) == (q // spec.window)
    return ok


# ---------------------------------------------------------------------------
# Core grouped attention (q already (B, Hk, G, Sq, D))
# ---------------------------------------------------------------------------


def _attend_direct(q, k, v, mask, scale):
    """Materialized-scores attention (short sequences / decode)."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, k).float() * scale
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", w.to(v.dtype), v)


def _attend_flash_jnp(q, k, v, spec: AttentionSpec, q_pos, k_pos, scale):
    """Blocked online-softmax attention; never materializes (Sq, Sk). The
    reference's kernel-off route for long sequences (a loop over key blocks
    for all query blocks at once). Supports distinct K and V head dims."""
    B, Hk, G, Sq, D = q.shape
    Sk = k.shape[2]
    Dv = v.shape[-1]
    bq = min(BLOCK_Q, Sq)
    bk = min(BLOCK_K, Sk)
    nq, nk = Sq // bq, Sk // bk
    assert Sq % bq == 0 and Sk % bk == 0, (Sq, Sk, bq, bk)

    qb = q.reshape(B, Hk, G, nq, bq, D)
    qp = q_pos.reshape(nq, bq)
    m = torch.full((B, Hk, G, nq, bq), float("-inf"), device=q.device)
    l = torch.zeros((B, Hk, G, nq, bq), device=q.device)
    acc = torch.zeros((B, Hk, G, nq, bq, Dv), device=q.device)
    for j in range(nk):
        k_j, v_j = k[:, :, j * bk:(j + 1) * bk], v[:, :, j * bk:(j + 1) * bk]
        s = torch.einsum("bhgnqd,bhkd->bhgnqk", qb, k_j).float() * scale
        mask = _pair_mask(spec, qp, k_pos[j * bk:(j + 1) * bk])  # (nq, bq, bk)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgnqk,bhkd->bhgnqd", p.to(v_j.dtype), v_j).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hk, G, Sq, Dv)


def _grouped_attention(q, k, v, spec, q_pos, k_pos, scale, force_direct=False):
    Sq, Sk = q.shape[3], k.shape[2]
    if (
        _USE_KERNEL
        and not force_direct
        and spec.causal
        and Sq == Sk
        and Sq % 128 == 0
        and q.shape[-1] == k.shape[-1] == v.shape[-1]
    ):
        bq = min(BLOCK_Q, 128 if Sq <= 512 else 256)
        bk = min(BLOCK_K, 128 if Sq <= 512 else 512)
        return kops.flash_attention(
            q, k, v, scale=scale, kind=spec.kind, window=spec.window,
            block_q=bq, block_k=bk,
        ).to(v.dtype)
    if force_direct or max(Sq, Sk) <= FLASH_THRESHOLD or Sq % 128 != 0:
        mask = _pair_mask(spec, q_pos, k_pos)[None, None, None]
        return _attend_direct(q, k, v, mask, scale)
    return _attend_flash_jnp(q, k, v, spec, q_pos, k_pos, scale)


# ---------------------------------------------------------------------------
# Standard (GQA) attention forward
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RopeTable:
    inv_freq: torch.Tensor
    rot: int


def _project_qkv(p, x, spec):
    q = torch.einsum("bsd,dhe->bshe", x, p["w_q"])
    k = torch.einsum("bsd,dhe->bshe", x, p["w_k"])
    v = torch.einsum("bsd,dhe->bshe", x, p["w_v"])
    if spec.qk_norm:
        q = rms_norm_headwise(p["q_norm"], q)
        k = rms_norm_headwise(p["k_norm"], k)
    return q, k, v


def attention_fwd(
    p: Dict,
    x: torch.Tensor,  # (B, S, d)
    spec: AttentionSpec,
    rope: Optional[RopeTable],
    positions: torch.Tensor,  # (S,)
) -> torch.Tensor:
    """Full-sequence (train / prefill) attention."""
    if spec.is_mla:
        raise _mla_not_ported()
    H, Hk, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    G = H // Hk
    q, k, v = _project_qkv(p, x, spec)
    if spec.rope and rope is not None:
        q = apply_rope(q, positions[None], rope.inv_freq, rope.rot)
        k = apply_rope(k, positions[None], rope.inv_freq, rope.rot)
    B, S = x.shape[0], x.shape[1]
    qg = q.reshape(B, S, Hk, G, D).permute(0, 2, 3, 1, 4)  # (B,Hk,G,S,D)
    kg = k.permute(0, 2, 1, 3)  # (B,Hk,S,D)
    vg = v.permute(0, 2, 1, 3)
    scale = spec.softmax_scale or (1.0 / D**0.5)
    out = _grouped_attention(qg, kg, vg, spec, positions, positions, scale)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(x.dtype)
    return torch.einsum("bshe,hed->bsd", out, p["w_o"])


# ---------------------------------------------------------------------------
# KV cache (ring buffer)
# ---------------------------------------------------------------------------


def init_cache(spec: AttentionSpec, batch: int, seq_len: int, dtype,
               device=None) -> Dict:
    """Cache sized for a context of ``seq_len`` (bounded by window/chunk)."""
    if spec.is_mla:
        raise _mla_not_ported()
    L = spec.cache_len(seq_len)
    shape = (batch, L, spec.num_kv_heads, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def _slot_positions(spec: AttentionSpec, L: int, index):
    """Absolute position held in each ring slot when writing at ``index``.

    Slot s holds the newest position p <= index with p == s (mod L);
    the slot being written now holds ``index`` itself. A (B,) ``index``
    gives (B, L) positions."""
    s = torch.arange(L, dtype=torch.int32, device=index.device)
    index = index[..., None]
    return index - torch.remainder(index - s, L)


def _slot_valid(spec: AttentionSpec, slot_pos, index):
    index = index[..., None]
    ok = (slot_pos >= 0) & (slot_pos <= index)
    if spec.kind == "sliding" and spec.window > 0:
        ok &= slot_pos > index - spec.window
    elif spec.kind == "chunked" and spec.window > 0:
        ok &= (slot_pos // spec.window) == (index // spec.window)
    return ok


def attention_decode(
    p: Dict,
    x: torch.Tensor,  # (B, 1, d)
    spec: AttentionSpec,
    rope: Optional[RopeTable],
    cache: Dict,
) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode with a ring-buffer cache update.

    Updates the cache IN PLACE: the new K/V row is written into
    ``cache["k"]``/``cache["v"]`` at slot ``index % L`` and ``cache["index"]``
    is incremented; the returned dict holds those same tensors. A caller
    that needs the old cache keeps a copy. The slot, the RoPE position and
    K5's ``valid_len`` are all computed on the device: no host sync.

    ``index`` is 0-d (every row at one position) or (B,) (the slot pool:
    each row at its own position, with its own RoPE angle, ring slot,
    ``valid_len`` and window mask, so a row's result depends on that row's
    cache alone)."""
    if spec.is_mla:
        raise _mla_not_ported()
    H, Hk, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    G = H // Hk
    B = x.shape[0]
    index = cache["index"]
    per_row = index.dim() == 1
    L = cache["k"].shape[1]
    q, k, v = _project_qkv(p, x, spec)
    pos = index[:, None] if per_row else index[None][None]  # (B or 1, 1)
    if spec.rope and rope is not None:
        q = apply_rope(q, pos, rope.inv_freq, rope.rot)
        k = apply_rope(k, pos, rope.inv_freq, rope.rot)
    if per_row:
        rows = torch.arange(B, device=index.device)
        slot = torch.remainder(index, L).long()
        cache["k"].index_put_((rows, slot), k[:, 0])
        cache["v"].index_put_((rows, slot), v[:, 0])
    else:
        slot = torch.remainder(index, L).reshape(1).long()
        cache["k"].index_copy_(1, slot, k)
        cache["v"].index_copy_(1, slot, v)
    k_cache, v_cache = cache["k"], cache["v"]
    qg = q.reshape(B, Hk, G, D)
    kg = k_cache.permute(0, 2, 1, 3)  # (B, Hk, L, D) views, no copy
    vg = v_cache.permute(0, 2, 1, 3)
    scale = spec.softmax_scale or (1.0 / D**0.5)
    if spec.kind == "full":
        # the ring mask of a full layer is the prefix 0 .. min(index+1, L)-1
        valid_len = torch.clamp(index + 1, max=L)
        out = kops.flash_decode(qg, kg, vg, valid_len, scale=scale)
    else:
        valid = _slot_valid(spec, _slot_positions(spec, L, index), index)
        if per_row:
            valid = valid[:, None, None]  # (B, 1, 1, L)
        s = torch.einsum("bhgd,bhld->bhgl", qg, kg).float() * scale
        s = torch.where(valid, s, -1e30)
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgl,bhld->bhgd", w.to(vg.dtype), vg)
    out = out.reshape(B, 1, H, D).to(x.dtype)
    y = torch.einsum("bshe,hed->bsd", out, p["w_o"])
    index.add_(1)
    return y, cache
