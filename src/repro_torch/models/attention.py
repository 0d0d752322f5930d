"""Attention layers: GQA/MHA with causal, sliding-window and chunked
masks, MLA (multi-head latent attention, deepseek-v2), bidirectional
(whisper's encoder) and cross attention; train/prefill forward and cached
single-token decode.

Port of ``repro.models.attention``, same names, parameter layouts
(``w_q`` (d_model, H, D), ``w_o`` (H, D, d_model); MLA's ``w_dq``,
``w_uq``, ``w_dkv``, ``w_k_rope``, ``w_uk``, ``w_uv``) and cache layouts
(``k``/``v`` (B, L, Hk, D) ring buffers, MLA's latent ``c_kv`` (B, L, r)
and ``k_rope`` (B, L, dr), each with a 0-d int32 ``index``; the serving
tier's slot pool gives each row its own index, a (B,) one).

Full-sequence attention goes through K4 (``kernels.flash_attention``)
when ``set_kernel_attention`` is on (the default here, the reference's
"TPU deployments" setting) and the shape meets the kernel's conditions;
otherwise it takes the reference's kernel-off route (``_attend_direct``
or the blocked online softmax ``_attend_flash_jnp``). In training the K4
route is differentiable through K4's autograd Function, whose backward is
a kernel too; the reference trains with its kernel off, so its gradient
there is autodiff of the direct route (the same function). MLA never
reaches K4: its query and key width D + dr is not its value width, as the
reference's kernel condition says. A bidirectional layer (``causal``
False) does not either: K4 is causal.

The decode step goes through K5 (``kernels.flash_decode``) wherever the
ring's valid slots are a prefix ``0 .. valid_len - 1``, which is what K5
masks. The route is picked on the host from the spec and the cache length
L alone (``_k5_valid_len``):

* ``full``: ``valid_len = min(index + 1, L)``;
* ``sliding`` with L <= window (every cache ``init_cache`` or a prefill
  makes: L = min(window, context)): slot s holds position
  ``index - ((index - s) mod L)``, inside ``(index - L, index]`` and so
  inside the window, so the valid slots are those already written,
  ``valid_len = min(index + 1, L)``;
* ``chunked`` with L == window: the valid slots are those of the current
  chunk, ``0 .. index mod W``, so ``valid_len = index mod W + 1``.

A ``chunked`` ring shorter than its chunk (L < W: a context below the
chunk) stops being a prefix once ``index >= L`` (the chunk's start can sit
anywhere in the wrapped ring), so that layer keeps the masked route
(``_slot_valid``), the one windowed decode route that K5 does not take.
MLA decode and cross attention are plain torch, as in the reference.

Under a mesh (``models/pshard.py``) each rank runs its own heads, with the
reference's strategy (``tp_route``): kv heads sharded over ``model`` where
they divide it (K4 at (B/dp, Hk/tp, G, S, D), K5 on the rank's kv heads);
else, where the query heads divide, kv repeated to MHA and the rank's heads
kept (K4 with G = 1); else context-parallel queries: the rank's S/tp query
rows against all S keys, the module's ``Sq != Sk`` route with the rows'
absolute positions (K4 takes equal lengths only); where S does not divide
the axis the rows are padded to a multiple of it, as GSPMD pads an uneven
split, and the padding is cut after the gather (whisper's 1500 frames at
model 16). MLA shards its heads over
``w_uq``, ``w_uk``, ``w_uv``. ``w_o`` is row-parallel, its partial sums
crossing in f32 (the reference's GSPMD widening) and summed over ``model``.
Decode under the context route runs replicated on every model rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AttentionSpec
from repro_torch.kernels import ops as kops
from repro_torch.models import pshard
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


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, d_model: int, spec: AttentionSpec,
                   dtype) -> Dict:
    H, Hk, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    p: Dict = {}
    if spec.is_mla:
        r, dr = spec.kv_lora, spec.rope_dim
        if spec.q_lora:
            p["w_dq"] = dense_init(gen, (d_model, spec.q_lora), 0, dtype)
            p["w_uq"] = dense_init(gen, (spec.q_lora, H, D + dr), 0, dtype)
        else:
            p["w_uq"] = dense_init(gen, (d_model, H, D + dr), 0, dtype)
        p["w_dkv"] = dense_init(gen, (d_model, r), 0, dtype)
        p["w_k_rope"] = dense_init(gen, (d_model, dr), 0, dtype)
        p["w_uk"] = dense_init(gen, (r, H, D), 0, dtype)
        p["w_uv"] = dense_init(gen, (r, H, D), 0, dtype)
        p["w_o"] = dense_init(gen, (H, D, d_model), 0, dtype)
    else:
        p["w_q"] = dense_init(gen, (d_model, H, D), 0, dtype)
        p["w_k"] = dense_init(gen, (d_model, Hk, D), 0, dtype)
        p["w_v"] = dense_init(gen, (d_model, Hk, D), 0, dtype)
        p["w_o"] = dense_init(gen, (H, D, d_model), 0, dtype)
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


def tp_route(spec: AttentionSpec, tp: int) -> Optional[str]:
    """How a layer splits over a ``model`` axis of ``tp`` ranks (None: not
    split): ``heads`` where the kv heads divide, ``repeat`` (kv repeated to
    MHA) where only the query heads divide, else ``context`` (the query
    sequence). MLA shards its heads, which must divide."""
    if tp == 1:
        return None
    H, Hk = spec.num_heads, spec.num_kv_heads
    if spec.is_mla:
        if H % tp:
            raise NotImplementedError(
                f"MLA attention: {H} heads do not split over a model axis of {tp}")
        return "heads"
    if Hk % tp == 0:
        return "heads"
    return "repeat" if H % tp == 0 else "context"


def sharded_dims(spec: AttentionSpec, tp: int) -> Dict:
    """The dims of each leaf's block the layer consumes as they lie over
    ``model`` (every other sharded dim is all-gathered at use)."""
    route = tp_route(spec, tp)
    if route in (None, "context"):
        return {}
    if spec.is_mla:
        return {"w_uq": (1,), "w_uk": (1,), "w_uv": (1,), "w_o": (0,)}
    keep = {"w_q": (1,), "w_o": (0,)}
    if route == "heads":
        keep.update(w_k=(1,), w_v=(1,))
    return keep


def _rank_heads(t, spec: AttentionSpec, dim: int):
    """kv heads (on ``dim``) repeated to MHA, this rank's query heads kept."""
    tp = pshard.axis_size("model")
    G = spec.num_heads // spec.num_kv_heads
    n = spec.num_heads // tp
    return t.repeat_interleave(G, dim=dim).narrow(dim, pshard.index("model") * n, n)


def _context_rows(q, positions=None):
    """The rank's block of query rows (dim 1) on the context route, and of
    their ``positions``: the rows padded (zeros; positions past the last,
    which every causal mask lets see all keys) to a multiple of the model
    axis where they do not divide it. ``_gathered_rows`` cuts the padding
    after the gather."""
    tp = pshard.axis_size("model")
    S = q.shape[1]
    pad = -S % tp
    if pad:
        if pshard.seq_shard():
            raise NotImplementedError(
                f"context-parallel attention: {S} positions do not split over {tp} "
                "with the sequence sharded")
        q = torch.cat([q, q.new_zeros((q.shape[0], pad) + tuple(q.shape[2:]))], dim=1)
        if positions is not None:
            positions = torch.cat([positions, positions[-1] + 1 + torch.arange(
                pad, dtype=positions.dtype, device=positions.device)])
    n = (S + pad) // tp
    start = pshard.index("model") * n
    q = q.narrow(1, start, n)
    return q, (None if positions is None else positions.narrow(0, start, n))


def _gathered_rows(y, S: int):
    """The context route's output rows gathered over ``model`` (the padding
    of ``_context_rows`` cut)."""
    y = pshard.leave_rows(y)
    return y if pshard.seq_shard() or y.shape[1] == S else y[:, :S]


def _row_parallel_out(out, w_o, dtype):
    """The rank's heads through its rows of ``w_o``: partial sums in f32,
    summed over ``model``, cast after the sum."""
    y = torch.einsum("bshe,hed->bsd", out.float(), w_o.float())
    return pshard.leave(y).to(dtype)


def attention_fwd(
    p: Dict,
    x: torch.Tensor,  # (B, S, d)
    spec: AttentionSpec,
    rope: Optional[RopeTable],
    positions: torch.Tensor,  # (S,)
) -> torch.Tensor:
    """Full-sequence (train / prefill) attention; under a mesh the rank's
    part (``tp_route``), the output summed over ``model``."""
    if spec.is_mla:
        return _mla_fwd(p, x, spec, rope, positions)
    route = tp_route(spec, pshard.axis_size("model"))
    if route is not None:
        x = pshard.enter(x, torch.float32)
    H, Hk, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    G = H // Hk
    q, k, v = _project_qkv(p, x, spec)
    if spec.rope and rope is not None:
        q = apply_rope(q, positions[None], rope.inv_freq, rope.rot)
        k = apply_rope(k, positions[None], rope.inv_freq, rope.rot)
    B, S = x.shape[0], x.shape[1]
    scale = spec.softmax_scale or (1.0 / D**0.5)
    q_pos = positions
    if route == "context":  # the rank's query rows against every key
        q, q_pos = _context_rows(q, positions)
    elif route == "repeat":
        k, v = _rank_heads(k, spec, 2), _rank_heads(v, spec, 2)
        G = 1
    Sq, Hq = q.shape[1], q.shape[2]
    qg = q.reshape(B, Sq, Hq // G, G, D).permute(0, 2, 3, 1, 4)  # (B,Hk,G,Sq,D)
    kg = k.permute(0, 2, 1, 3)  # (B,Hk,S,D)
    vg = v.permute(0, 2, 1, 3)
    out = _grouped_attention(qg, kg, vg, spec, q_pos, positions, scale)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(x.dtype)
    if route in ("heads", "repeat"):
        return _row_parallel_out(out, p["w_o"], x.dtype)
    y = torch.einsum("bshe,hed->bsd", out, p["w_o"])
    return y if route is None else _gathered_rows(y, S)


# ---------------------------------------------------------------------------
# KV cache (ring buffer)
# ---------------------------------------------------------------------------


def init_cache(spec: AttentionSpec, batch: int, seq_len: int, dtype,
               device=None) -> Dict:
    """Cache sized for a context of ``seq_len`` (bounded by window/chunk)."""
    L = spec.cache_len(seq_len)
    if spec.is_mla:
        return {
            "c_kv": torch.zeros((batch, L, spec.kv_lora), dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, L, spec.rope_dim), dtype=dtype, device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device),
        }
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


def _k5_valid_len(spec: AttentionSpec, L: int, index):
    """K5's ``valid_len`` (() or (B,), on the device) for a ring of L slots
    at ``index``, or None where the ring's valid slots are not a prefix
    (the masked route). The route depends on the spec and L alone."""
    if spec.kind == "full" or spec.window <= 0 or (
            spec.kind == "sliding" and L <= spec.window):
        return torch.clamp(index + 1, max=L)
    if spec.kind == "chunked" and L == spec.window:
        return torch.remainder(index, L) + 1
    return None


def _write_ring(cache: Dict, names, rows_new, index, per_row: bool) -> None:
    """Write each (B, 1, ...) new row into ``cache[name]`` (B, L, ...) at
    the ring slot ``index % L``, in place (one slot for a 0-d index, each
    row's own for a (B,) index)."""
    L = cache[names[0]].shape[1]
    if per_row:
        rows = torch.arange(index.shape[0], device=index.device)
        slot = torch.remainder(index, L).long()
        for name, new in zip(names, rows_new):
            cache[name].index_put_((rows, slot), new[:, 0])
    else:
        slot = torch.remainder(index, L).reshape(1).long()
        for name, new in zip(names, rows_new):
            cache[name].index_copy_(1, slot, new)


def attention_decode(
    p: Dict,
    x: torch.Tensor,  # (B, 1, d)
    spec: AttentionSpec,
    rope: Optional[RopeTable],
    cache: Dict,
    mla_absorb: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode with a ring-buffer cache update.

    Updates the cache IN PLACE: the new K/V row (MLA: latent and RoPE key)
    is written at slot ``index % L`` and ``cache["index"]`` is incremented;
    the returned dict holds those same tensors. A caller that needs the old
    cache keeps a copy. The slot, the RoPE position and K5's ``valid_len``
    are all computed on the device: no host sync.

    ``index`` is 0-d (every row at one position) or (B,) (the slot pool:
    each row at its own position, with its own RoPE angle, ring slot,
    ``valid_len`` and window mask, so a row's result depends on that row's
    cache alone). K5 takes every layer whose valid slots are a prefix
    (module docstring); a ``chunked`` ring shorter than its chunk keeps
    the masked route."""
    if spec.is_mla:
        return _mla_decode(p, x, spec, rope, cache, absorb=mla_absorb)
    route = tp_route(spec, pshard.axis_size("model"))
    if route == "context":  # one query row: every model rank runs it whole
        route = None
    if route is not None:
        x = pshard.enter(x)
    D = spec.head_dim
    B = x.shape[0]
    index = cache["index"]
    per_row = index.dim() == 1
    L = cache["k"].shape[1]
    q, k, v = _project_qkv(p, x, spec)
    pos = index[:, None] if per_row else index[None][None]  # (B or 1, 1)
    if spec.rope and rope is not None:
        q = apply_rope(q, pos, rope.inv_freq, rope.rot)
        k = apply_rope(k, pos, rope.inv_freq, rope.rot)
    _write_ring(cache, ("k", "v"), (k, v), index, per_row)
    kg = cache["k"].permute(0, 2, 1, 3)  # (B, Hk, L, D) views, no copy
    vg = cache["v"].permute(0, 2, 1, 3)
    if route == "repeat":
        kg, vg = _rank_heads(kg, spec, 1), _rank_heads(vg, spec, 1)
    Hq = q.shape[2]
    qg = q.reshape(B, kg.shape[1], Hq // kg.shape[1], D)
    scale = spec.softmax_scale or (1.0 / D**0.5)
    valid_len = _k5_valid_len(spec, L, index)
    if valid_len is not None:
        out = kops.flash_decode(qg, kg, vg, valid_len, scale=scale)
    else:
        valid = _slot_valid(spec, _slot_positions(spec, L, index), index)
        if per_row:
            valid = valid[:, None, None]  # (B, 1, 1, L)
        s = torch.einsum("bhgd,bhld->bhgl", qg, kg).float() * scale
        s = torch.where(valid, s, -1e30)
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgl,bhld->bhgd", w.to(vg.dtype), vg)
    out = out.reshape(B, 1, Hq, D).to(x.dtype)
    if route is None:
        y = torch.einsum("bshe,hed->bsd", out, p["w_o"])
    else:
        y = _row_parallel_out(out, p["w_o"], x.dtype)
    index.add_(1)
    return y, cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v2)
# ---------------------------------------------------------------------------


def _rope_one_head(t, pos, rope):
    """RoPE of a (B, S, dr) single shared head at positions ``pos``."""
    return apply_rope(t[:, :, None, :], pos, rope.inv_freq, rope.rot)[:, :, 0]


def _mla_q(p, x, spec, rope, pos):
    """(q_nope (B, S, H, D), q_rope (B, S, H, dr)); ``pos`` (1 or B, S)."""
    D = spec.head_dim
    if spec.q_lora:
        cq = x @ p["w_dq"]
        q = torch.einsum("bsr,rhe->bshe", cq, p["w_uq"])  # (B, S, H, D + dr)
    else:
        q = torch.einsum("bsd,dhe->bshe", x, p["w_uq"])
    q_nope, q_rope = q[..., :D], q[..., D:]
    if rope is not None:
        q_rope = apply_rope(q_rope, pos, rope.inv_freq, rope.rot)
    return q_nope, q_rope


def _mla_fwd(p, x, spec, rope, positions):
    """Prefill/train MLA: decompress K/V and run standard attention (MHA,
    G = 1). The key width D + dr differs from the value width D, so the
    grouped attention takes the kernel-off route (direct up to 2048
    tokens, the blocked online softmax above)."""
    sharded = tp_route(spec, pshard.axis_size("model")) is not None
    if sharded:
        x = pshard.enter(x, torch.float32)
    B, S, _ = x.shape
    H, D, dr = p["w_uk"].shape[1], spec.head_dim, spec.rope_dim  # the rank's heads
    q_nope, q_rope = _mla_q(p, x, spec, rope, positions[None])
    c_kv = x @ p["w_dkv"]
    k_rope = x @ p["w_k_rope"]  # single shared head
    if rope is not None:
        k_rope = _rope_one_head(k_rope, positions[None], rope)
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uk"])
    v = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, dr)], dim=-1)
    scale = spec.softmax_scale or (1.0 / (D + dr) ** 0.5)
    qg = q.permute(0, 2, 1, 3)[:, :, None]  # (B, H, 1, S, D + dr)
    kg = k.permute(0, 2, 1, 3)
    vg = v.permute(0, 2, 1, 3)
    out = _grouped_attention(qg, kg, vg, spec, positions, positions, scale)
    out = out[:, :, 0].permute(0, 2, 1, 3).to(x.dtype)  # (B, S, H, D)
    if sharded:
        return _row_parallel_out(out, p["w_o"], x.dtype)
    return torch.einsum("bshe,hed->bsd", out, p["w_o"])


def _mla_decode(p, x, spec, rope, cache, absorb: bool):
    """Cached decode against the compressed latent cache, in place.

    ``absorb=True`` scores the latent cache directly through q' = q W_uk
    per head and takes the output as (w c_kv) W_uv: O(L r) a head instead
    of decompressing O(L H D) keys and values every step. ``absorb=False``
    decompresses (the reference's roofline baseline). The valid slots are
    the prefix ``slot_pos >= 0 and <= index`` (MLA layers are ``full``),
    with a 0-d or a (B,) index."""
    sharded = tp_route(spec, pshard.axis_size("model")) is not None
    if sharded:
        x = pshard.enter(x)
    B = x.shape[0]
    D, dr = spec.head_dim, spec.rope_dim
    index = cache["index"]
    per_row = index.dim() == 1
    L = cache["c_kv"].shape[1]
    pos = index[:, None] if per_row else index[None][None]  # (B or 1, 1)
    q_nope, q_rope = _mla_q(p, x, spec, rope, pos)  # (B, 1, H, D), (B, 1, H, dr)
    c_new = x @ p["w_dkv"]
    kr_new = x @ p["w_k_rope"]
    if rope is not None:
        kr_new = _rope_one_head(kr_new, pos, rope)
    _write_ring(cache, ("c_kv", "k_rope"), (c_new, kr_new), index, per_row)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    slot_pos = _slot_positions(spec, L, index)
    valid = (slot_pos >= 0) & (slot_pos <= index[..., None])  # (L,) or (B, L)
    valid = valid[:, None, None] if per_row else valid  # against (B, H, 1, L)
    scale = spec.softmax_scale or (1.0 / (D + dr) ** 0.5)
    if absorb:
        qc = torch.einsum("bshe,rhe->bshr", q_nope, p["w_uk"])  # (B, 1, H, r)
        s = torch.einsum("bshr,blr->bhsl", qc, c_kv)
        s = s + torch.einsum("bshe,ble->bhsl", q_rope, k_rope)
        s = torch.where(valid, s.float() * scale, -1e30)
        w = torch.softmax(s, dim=-1)
        wc = torch.einsum("bhsl,blr->bshr", w.to(c_kv.dtype), c_kv)
        out = torch.einsum("bshr,rhe->bshe", wc, p["w_uv"])  # (B, 1, H, D)
    else:
        k_nope = torch.einsum("blr,rhe->blhe", c_kv, p["w_uk"])  # (B, L, H, D)
        v = torch.einsum("blr,rhe->blhe", c_kv, p["w_uv"])
        s = torch.einsum("bshe,blhe->bhsl", q_nope, k_nope)
        s = s + torch.einsum("bshe,ble->bhsl", q_rope, k_rope)
        s = torch.where(valid, s.float() * scale, -1e30)
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bhsl,blhe->bshe", w.to(v.dtype), v)
    if sharded:
        y = _row_parallel_out(out.to(x.dtype), p["w_o"], x.dtype)
    else:
        y = torch.einsum("bshe,hed->bsd", out.to(x.dtype), p["w_o"])
    index.add_(1)
    return y, cache


# ---------------------------------------------------------------------------
# Cross attention (whisper's decoder)
# ---------------------------------------------------------------------------


def init_cross_attention(gen: torch.Generator, d_model: int, spec: AttentionSpec,
                         dtype) -> Dict:
    return init_attention(gen, d_model, spec, dtype)


def _attend_unmasked(q, k, v, D):
    """q (B, S, Hk, G, D) over k/v (B, T, Hk, D), every key valid: scores
    in f32 over sqrt(D), as the reference's cross attention."""
    B, S, Hk, G, _ = q.shape
    s = torch.einsum("bshgd,bthd->bhgst", q, k).float() / D**0.5
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", w.to(v.dtype), v)
    return out.reshape(B, S, Hk * G, D)


def cross_route(spec: AttentionSpec, decode: bool = False) -> Optional[str]:
    """``tp_route`` of cross attention; a decode step's single query row
    runs a context-parallel layer whole on every rank (None)."""
    route = tp_route(spec, pshard.axis_size("model"))
    return None if (decode and route == "context") else route


def cross_attend(p, x, k, v, spec: AttentionSpec, route: Optional[str]):
    """x (B, S, d) against k/v (B, T, Hk', D), the rank's kv heads (or every
    head where they do not split), unmasked; under a mesh the rank's part
    summed over ``model`` (context route: the rank's rows gathered)."""
    H, Hk, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    q = torch.einsum("bsd,dhe->bshe", x, p["w_q"])
    S_x = q.shape[1]
    if route == "context":
        q = _context_rows(q)[0]
    elif route == "repeat":
        k, v = _rank_heads(k, spec, 2), _rank_heads(v, spec, 2)
    B, S, Hq = q.shape[0], q.shape[1], q.shape[2]
    out = _attend_unmasked(q.reshape(B, S, k.shape[2], Hq // k.shape[2], D), k, v, D)
    out = out.to(x.dtype)
    if route in ("heads", "repeat"):
        return _row_parallel_out(out, p["w_o"], x.dtype)
    y = torch.einsum("bshe,hed->bsd", out, p["w_o"])
    return y if route is None else _gathered_rows(y, S_x)


def cross_attention_fwd(p, x, kv_src, spec: AttentionSpec):
    """Decoder-to-encoder cross attention; kv_src (B, T, d); no mask, no
    RoPE, scale 1 / sqrt(D). Under a mesh both inputs enter the rank's part
    (``tp_route``: its heads, or its query rows)."""
    route = cross_route(spec)
    if route is not None:
        x = pshard.enter(x, torch.float32)
        kv_src = pshard.copy(kv_src, "model", torch.float32)
    k = torch.einsum("bsd,dhe->bshe", kv_src, p["w_k"])
    v = torch.einsum("bsd,dhe->bshe", kv_src, p["w_v"])
    return cross_attend(p, x, k, v, spec, route)
