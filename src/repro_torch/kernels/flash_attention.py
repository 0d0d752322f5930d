"""K4 on Hopper: causal GQA flash attention (full, sliding or chunked
masks), forward and backward.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (``_flash_kernel``). The CUDA source is
``src/repro_torch/csrc/flash_attention.cu``. A CTA's rows pack all G query
heads of one kv head (row r is position r // G of head r % G), so each K/V
tile is read once for all G heads, and key tiles wholly outside the causal /
window / chunk mask of every row are skipped. f32 online softmax with the
finite -1e30 sentinel, p rounded to the value dtype before P.V, l floored
at 1e-30, as the reference.

- bf16: a warp-specialised kernel for ``sm_90a``. One producer thread loads
  each output tile's Q once and K/V in 128-key tiles (64 at D = 128) by TMA
  through a ring of mbarrier-guarded stages; two consumer warpgroups of 64
  rows run ``wgmma`` for S = Q K^T (both operands in shared memory) and
  O += P V (P from registers), taking turns so that one's softmax overlaps
  the other's products. A CTA holds ``128 // G`` whole positions
  (``tile_rows``), so any G up to 128 works. The grid is persistent (one
  CTA per SM), walking output tiles longest first.
- f32: plain FMA in 64-row tiles (the f32 tolerance of 2e-5 rules out TF32).

Bound on the H100: ``4 * B * Hk * G * D`` flops per causal (query, key)
pair against reading q, k, v and writing the output once; at the serving
prefill shape (B, Hk, G, S, D) = (4, 4, 8, 2048, 64) in bf16 that is
68.7 GFLOP (69 us at 989 TFLOP/s) against 75 MB (22 us at 3.35 TB/s), so
it is bound by operations.

The backward (``csrc/flash_attention_bwd.cu``) replaces no TPU kernel: the
reference's Pallas kernel has no VJP and the reference trains with it
switched off. The port trains through K4, so its gradient is a kernel too,
recomputing P from the forward's log-sum-exp ``lse``. bf16 is three
kernels for ``sm_90a``: a pre-pass writing ``D = rowsum(dO * O)`` and the
lse in log2 units to a workspace, a dK/dV kernel (a work item is 128 keys
of one kv head, walking every query head of it and every query tile that
sees the keys in a fixed order, so the GQA sum needs no atomics) and a dQ
kernel (a work item is 128 queries of one head), both persistent,
warp-specialised and on ``wgmma`` with TMA rings, as the forward. f32 is
plain FMA. ``bwd_plan`` is the bf16 route's schedule (tile sizes, the work
items longest first, grids on the card's SMs, shared memory, workspace):
the kernels take its order and grids. Bound: 10 D flops per head per
causal pair (2.5 times the forward's).

``flash_attention(q, k, v, scale=, kind=, window=, block_q=, block_k=)`` is
the wrapper, with the reference's signature. Without autograd (and outside
``torch.func`` transforms) a CPU tensor goes to the plain version
``flash_attention_plain`` and a CUDA tensor to the forward kernel without
``lse``, as serving runs it. When a gradient is wanted, or under
``torch.func.vmap``/``grad``, the call goes through ``Attention``, an
``autograd.Function`` whose forward runs the kernel with ``lse`` and whose
backward runs ``AttentionBwd``, a second Function around the backward
kernel; each has a ``vmap`` rule that folds the vmapped dimension into B.
On the CPU both Functions take their plain versions (``flash_attention_plain``
with ``return_lse=True`` and ``flash_attention_bwd_plain``); a CUDA tensor
reaches only the kernels, or raises on shapes they do not take.
``block_q``/``block_k`` are checked as the reference checks them (S must
divide into both); the kernels tile by their own sizes. ``launches`` counts
the forward kernel's calls, ``bwd_launches`` the backward's.

A meta tensor (the dry-run, ``launch.dryrun``) takes a third route: the
kernel route's checks (all but the pointers' alignment), so a shape the
card refuses raises the same message, and outputs of the kernel's shapes,
layouts and dtypes with nothing computed. It never reaches the plain
version, and it counts ``meta_launches``/``meta_bwd_launches``, never
``launches``/``bwd_launches``. On the card and on meta alike each call
reports ``cost`` through ``kernels._report``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _report

launches = 0  # forward kernel calls
bwd_launches = 0  # backward kernel calls
meta_launches = 0  # forward calls on the meta device (nothing launched)
meta_bwd_launches = 0  # backward calls on the meta device
NEG_INF = -1e30
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 512
KINDS = {"full": 0, "sliding": 1, "chunked": 2}
HEAD_DIMS = (32, 64, 128)  # head dims the kernel is built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CTA_ROWS = 128  # rows of a bf16 CTA: two consumer warpgroups of 64
ENCODE_ERROR = 1000  # the launcher returns 1000 + CUresult when a tensor map fails
LOG2E = 1.4426950408889634


def tile_rows(G: int) -> tuple:
    """(positions, rows) of one bf16 CTA at G query heads per kv head:
    ``128 // G`` whole positions, each with all G heads; rows past
    ``positions * G`` are padding, computed and never stored."""
    if not 1 <= G <= CTA_ROWS:
        raise ValueError(f"the bf16 K4 kernel takes 1 <= G <= {CTA_ROWS} query heads "
                         f"per kv head, got {G}")
    P = CTA_ROWS // G
    return P, P * G


def _mask(S, kind, window, device):
    """(S, S) boolean: query position (row) may attend to key position."""
    pos = torch.arange(S, device=device)
    qp, kp = pos[:, None], pos[None, :]
    mask = kp <= qp
    if kind == "sliding" and window > 0:
        mask &= kp > qp - window
    elif kind == "chunked" and window > 0:
        mask &= (kp // window) == (qp // window)
    return mask


def allowed_pairs(S: int, kind: str = "full", window: int = 0) -> int:
    """The causal (query, key) pairs the mask allows at S positions."""
    if kind == "sliding" and window > 0:
        w = min(window, S)
        return w * (w + 1) // 2 + (S - w) * w
    if kind == "chunked" and window > 0:
        n, r = divmod(S, window)
        return n * window * (window + 1) // 2 + r * (r + 1) // 2
    return S * (S + 1) // 2


def cost(B: int, Hk: int, G: int, S: int, D: int, dtype, kind: str = "full",
         window: int = 0, backward: bool = False, with_lse: bool = False) -> tuple:
    """(FLOPs, bytes read, bytes written) of one call at (B, Hk, G, S, D):
    the work the function needs, whatever computes it. Forward: ``4 D``
    flops per head per allowed pair (S = Q K^T and P V), q, k and v read and
    the output written once (and the f32 lse written, ``with_lse``).
    Backward: ``10 D`` (S and dP recomputed, dV, dQ and dK), q, k, v, the
    output, its gradient and the lse read, dq, dk, dv written once. The
    kernel's bound divides the FLOPs by the bf16 peak (f32: the FMA peak)
    and the bytes, read and written, by HBM's rate."""
    es = dtype.itemsize
    pairs = allowed_pairs(S, kind, window)
    q_n, kv_n, lse_n = B * Hk * G * S * D, B * Hk * S * D, B * Hk * G * S
    if backward:
        return (10 * B * Hk * G * D * pairs, (3 * q_n + 2 * kv_n) * es + lse_n * 4,
                (q_n + 2 * kv_n) * es)
    return (4 * B * Hk * G * D * pairs, (q_n + 2 * kv_n) * es,
            q_n * es + (lse_n * 4 if with_lse else 0))


def flash_attention_plain(q, k, v, *, scale, kind="full", window=0, return_lse=False):
    """The plain version: the direct masked softmax of
    ``repro.kernels.ref.flash_attention_ref``. q (B, Hk, G, S, D), k/v
    (B, Hk, S, D); scores in f32, the softmax weights cast to v's dtype.
    With ``return_lse``, also each row's f32 log-sum-exp (B, Hk, G, S) of
    the scaled, masked scores, as the kernel writes it for the backward."""
    mask = _mask(q.shape[3], kind, window, q.device)
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, k).float() * scale
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w.to(v.dtype), v)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def flash_attention_bwd_plain(q, k, v, out, lse, dout, scale, kind="full", window=0):
    """The backward's plain version, as explicit formulas in f32 from the
    inputs (P and dS rounded to q's dtype where the kernel rounds them):
    P = exp(s * scale - lse) on allowed pairs, dV = P^T dO, dP = dO V^T,
    D = rowsum(dO * O), dS = P * (dP - D), dQ = scale dS K,
    dK = scale dS^T Q. Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    mask = _mask(q.shape[3], kind, window, q.device)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(v.dtype).float(), dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    delta = (dof * out.float()).sum(-1)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _launcher():
    """The built library's ``flash_attention_launch``, typed (built at
    first use)."""
    from repro_torch.kernels.build import library

    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_launcher():
    """The built library's ``flash_attention_bwd_launch``, typed; its tile
    sizes checked against ``bwd_plan``'s for every head dim."""
    from repro_torch.kernels.build import library

    lib = library("flash_attention_bwd")
    cfg = lib.flash_attention_bwd_config
    cfg.argtypes = [ctypes.c_int, ctypes.c_void_p]
    cfg.restype = ctypes.c_int
    for D in HEAD_DIMS:
        out = (ctypes.c_int * 9)()
        if cfg(D, out) != 0 or tuple(out) != _bwd_tiles(D):
            raise RuntimeError(f"csrc/flash_attention_bwd.cu's tiles at D={D} are "
                               f"{tuple(out)}, bwd_plan's {_bwd_tiles(D)}")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# --- the bf16 backward's schedule (csrc/flash_attention_bwd.cu) -------------

BWD_KEYS = 128  # keys a dK/dV work item: 64 a consumer warpgroup
BWD_ROWS = 128  # queries a dQ work item: 64 a consumer warpgroup
BWD_PAD = 128  # the workspace's rows: S rounded up to this


def _round1024(x: int) -> int:
    return -(-x // 1024) * 1024


@functools.cache
def _bwd_tiles(D: int) -> tuple:
    """``BwdCfg<D>`` of the CUDA source, in ``flash_attention_bwd_config``'s
    order: (dK/dV keys, queries a step, stages, shared bytes, dQ queries,
    keys a step, stages, shared bytes, row padding)."""
    bm = 32 if D == 128 else 64
    bn = 128 if D == 64 else 64  # keys a step of the dQ walk
    kv_stages = {32: 6, 64: 5, 128: 4}[D]
    q_stages = {32: 8, 64: 4, 128: 4}[D]
    kv_bytes = BWD_KEYS * D * 2  # K (or V)
    kv_step = _round1024(2 * bm * D * 2 + 2 * bm * 4)  # Q, dO, lse, Dl rows
    kv_smem = 2 * kv_bytes + kv_stages * kv_step + 8 * (2 + 2 * kv_stages) + 1024
    q_step = 2 * bn * D * 2  # K, V
    q_smem = 2 * BWD_ROWS * D * 2 + q_stages * q_step + 8 * (2 + 2 * q_stages) + 1024
    return (BWD_KEYS, bm, kv_stages, kv_smem, BWD_ROWS, bn, q_stages, q_smem, BWD_PAD)


def _first_key(q: int, kind: int, w: int) -> int:
    """The first key position q may attend to (kind 0 when w is 0)."""
    if kind == 1:
        return max(0, q - w + 1)
    if kind == 2:
        return q // w * w
    return 0


def _last_query(k: int, S: int, kind: int, w: int) -> int:
    """The last query position (below S) that may attend to key k."""
    if kind == 1:
        return min(S - 1, k + w - 1)
    if kind == 2:
        return min(S - 1, (k // w + 1) * w - 1)
    return S - 1


class BwdPlan(NamedTuple):
    """One bf16 backward call's schedule. ``kv_order`` lists the key tiles
    (of ``kv_keys``) and ``q_order`` the query tiles (of ``q_rows``) longest
    walk first; work item t of the dK/dV kernel is key tile
    ``kv_order[t // (B Hk)]`` of (batch, kv head) ``t % (B Hk)``, of the dQ
    kernel query tile ``q_order[t // (B Hk G)]`` of row ``t % (B Hk G)`` of
    lse; a persistent CTA c of ``grid`` takes item ``r grid + c`` in even
    rounds r and ``r grid + grid - 1 - c`` in odd ones."""
    B: int
    Hk: int
    G: int
    S: int
    D: int
    kind: int  # 0 full (or a window of 0), 1 sliding, 2 chunked
    window: int
    kv_keys: int  # keys a dK/dV work item, 64 a consumer warpgroup
    kv_queries: int  # queries a step of its walk
    kv_stages: int
    kv_smem: int  # dynamic shared bytes a CTA
    q_rows: int  # queries a dQ work item, 64 a consumer warpgroup
    q_keys: int  # keys a step of its walk
    q_stages: int
    q_smem: int
    s_pad: int  # the workspace's rows: S rounded up to 128
    kv_order: tuple
    q_order: tuple
    kv_items: int
    q_items: int
    kv_grid: int  # persistent CTAs a kernel: min(its items, the card's SMs)
    q_grid: int
    workspace_bytes: int  # lse * log2(e) and D, f32 (B Hk G, s_pad) each
    launches: int  # kernels a call: the pre-pass, dK/dV, dQ


def kv_walk(plan: BwdPlan, kt: int) -> range:
    """The first query of each query tile of key tile ``kt``'s walk, in the
    kernel's order: from the last tile that sees its keys down, each taken
    for every query head g in turn (G steps a tile)."""
    k0, bm = kt * plan.kv_keys, plan.kv_queries
    q_last = _last_query(min(k0 + plan.kv_keys - 1, plan.S - 1), plan.S, plan.kind,
                         plan.window)
    return range(q_last // bm * bm, k0 - 1, -bm)


def dq_walk(plan: BwdPlan, qt: int) -> range:
    """The first key of each step of query tile ``qt``'s walk."""
    q0, bn = qt * plan.q_rows, plan.q_keys
    k_first = _first_key(q0, plan.kind, plan.window) // bn * bn
    k_last = min(q0 + plan.q_rows - 1, plan.S - 1)
    return range(k_first, k_last // bn * bn + 1, bn)


@functools.lru_cache(maxsize=256)
def bwd_plan(B: int, Hk: int, G: int, S: int, D: int, kind: str = "full", window: int = 0,
             *, sms: int) -> BwdPlan:
    """The bf16 backward's schedule at (B, Hk, G, S, D) under a mask, on a
    card of ``sms`` SMs (one persistent CTA per SM, fewer when there are
    fewer work items)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"the K4 backward takes head dims {HEAD_DIMS}, got {D}")
    kn, bm, kv_stages, kv_smem, qn, bn, q_stages, q_smem, pad = _bwd_tiles(D)
    kd = KINDS[kind] if window > 0 else 0
    s_pad = -(-S // pad) * pad
    n_t = s_pad // pad
    base = BwdPlan(B, Hk, G, S, D, kd, int(window), kn, bm, kv_stages, kv_smem, qn, bn,
                   q_stages, q_smem, s_pad, (), (), B * Hk * n_t, B * Hk * G * n_t, 0, 0,
                   2 * B * Hk * G * s_pad * 4, 3)
    kv_len = [len(kv_walk(base, t)) for t in range(n_t)]
    q_len = [len(dq_walk(base, t)) for t in range(n_t)]
    return base._replace(
        kv_order=tuple(sorted(range(n_t), key=lambda t: (-kv_len[t], t))),
        q_order=tuple(sorted(range(n_t), key=lambda t: (-q_len[t], t))),
        kv_grid=min(base.kv_items, sms), q_grid=min(base.q_items, sms))


@functools.lru_cache(maxsize=64)
def _order_on(order: tuple, device: torch.device) -> torch.Tensor:
    """A plan's tile order as an int32 tensor on ``device``, made once per
    schedule (the kernels read it; no call copies it again)."""
    return torch.tensor(order, dtype=torch.int32, device=device)


def _check(q, k, v, kind, block_q, block_k):
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q (B, Hk, G, S, D) and k/v (B, Hk, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hk, G, S, D = q.shape
    if tuple(k.shape) != (B, Hk, S, D) or tuple(v.shape) != (B, Hk, S, D):
        raise ValueError(f"k/v must be {(B, Hk, S, D)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on cpu, cuda or meta, got {q.device}")
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    bq, bk = min(block_q, S), min(block_k, S)
    if S % bq or S % bk:
        raise ValueError(f"S={S} must divide into both block sizes ({bq}, {bk})")


def _aligned(t) -> bool:
    """Rows a 16-byte load (TMA, ldmatrix staging) can take: a 16-byte
    aligned base and every stride but the last a multiple of 8 elements (a
    meta tensor has no base: its strides alone)."""
    return (t.is_meta or t.data_ptr() % 16 == 0) and all(s % 8 == 0 for s in t.stride()[:-1])


def _check_kernel(q, k, v, scale):
    """What the CUDA kernels take beyond the reference's conditions (on a
    meta tensor, all but the pointers' alignment)."""
    D = q.shape[-1]
    if q.dtype not in DTYPES:
        raise ValueError(f"the K4 kernel takes float32 or bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the K4 kernel takes head dims {HEAD_DIMS}, got {D}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous in the head dim")
    if q.dtype == torch.bfloat16:  # TMA: 16-byte aligned base and strides
        if not all(_aligned(t) for t in (q, k, v)):
            raise ValueError("bf16 q, k and v need 16-byte aligned rows")
        tile_rows(q.shape[2])
        if not scale > 0:  # it takes the row max of the unscaled scores
            raise ValueError(f"the bf16 K4 kernel takes a positive scale, got {scale}")


def _err(name, err):
    if err >= ENCODE_ERROR:
        raise RuntimeError(f"{name}: a TMA tensor map could not be encoded "
                           f"(CUresult {err - ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _forward(q, k, v, scale, kind, window, with_lse):
    """(out, lse or None): the plain version on the CPU, else the kernel (on
    meta, its outputs' shapes)."""
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_plain(q, k, v, scale=scale, kind=kind, window=window,
                                         return_lse=True)
        return flash_attention_plain(q, k, v, scale=scale, kind=kind, window=window), None
    _check_kernel(q, k, v, scale)
    B, Hk, G, S, D = q.shape
    with _report.call("flash_attention", lambda: cost(
            B, Hk, G, S, D, q.dtype, kind, window, with_lse=with_lse)):
        return _forward_route(q, k, v, scale, kind, window, with_lse)


def _forward_route(q, k, v, scale, kind, window, with_lse):
    global launches, meta_launches
    B, Hk, G, S, D = q.shape
    # written in (B, S, Hk, G, D) order, so the model's move back to
    # (B, S, H, D) is a free view
    out = torch.empty((B, S, Hk, G, D), dtype=q.dtype,
                      device=q.device).permute(0, 2, 3, 1, 4)
    lse = (torch.empty((B, Hk, G, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.is_meta:
        meta_launches += 1
        return out, lse
    strides = (ctypes.c_longlong * 14)(
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *out.stride()[:4])
    fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None,
                 B, Hk, G, S, D, strides, float(scale), KINDS[kind], int(window),
                 DTYPES[q.dtype], stream)
    _err("flash_attention", err)
    launches += 1
    return out, lse


def _backward(q, k, v, out, lse, dout, scale, kind, window):
    """(dq, dk, dv): the plain version on the CPU, else the backward kernel
    (on meta, its outputs' shapes)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, scale, kind, window)
    _check_kernel(q, k, v, scale)
    if dout.dtype != q.dtype or out.dtype != q.dtype:
        raise ValueError(f"out and dout must be {q.dtype}, got {out.dtype}, {dout.dtype}")
    B, Hk, G, S, D = q.shape
    with _report.call("flash_attention_bwd", lambda: cost(
            B, Hk, G, S, D, q.dtype, kind, window, backward=True)):
        return _backward_route(q, k, v, out, lse, dout, scale, kind, window)


def _backward_route(q, k, v, out, lse, dout, scale, kind, window):
    global bwd_launches, meta_bwd_launches
    B, Hk, G, S, D = q.shape
    # in the model's layouts: dq as q's (B, S, H, D), dk/dv as (B, S, Hk, D)
    dq = torch.empty((B, S, Hk, G, D), dtype=q.dtype,
                     device=q.device).permute(0, 2, 3, 1, 4)
    dk, dv = (torch.empty((B, S, Hk, D), dtype=t.dtype, device=q.device).permute(0, 2, 1, 3)
              for t in (k, v))
    if q.is_meta:
        meta_bwd_launches += 1
        return dq, dk, dv
    # out and dout are read by 16-byte loads and dout by TMA (their layouts
    # are whatever autograd hands back; the model's are aligned)
    out, dout = (t if t.stride(-1) == 1 and _aligned(t) and min(t.stride()) > 0
                 else t.contiguous() for t in (out, dout))
    lse = lse.contiguous()
    if q.dtype == torch.bfloat16:
        plan = bwd_plan(B, Hk, G, S, D, kind, int(window),
                        sms=torch.cuda.get_device_properties(q.device).multi_processor_count)
        ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32, device=q.device)
        order = _order_on(plan.kv_order + plan.q_order, q.device).data_ptr()
        grids = plan.kv_grid, plan.q_grid
    else:  # the FMA route: D = rowsum(dO * O) of lse's shape
        ws = torch.empty((B, Hk, G, S), dtype=torch.float32, device=q.device)
        order, grids = None, (0, 0)
    strides = (ctypes.c_longlong * 28)(
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *out.stride()[:4],
        *dout.stride()[:4], *dq.stride()[:4], *dk.stride()[:3], *dv.stride()[:3])
    fn = _bwd_launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), ws.data_ptr(), order, *grids, dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), B, Hk, G, S, D, strides, float(scale),
                 KINDS[kind], int(window), DTYPES[q.dtype], stream)
    _err("flash_attention_bwd", err)
    bwd_launches += 1
    return dq, dk, dv


def flash_attention_with_lse(q, k, v, *, scale, kind="full", window=0):
    """(out, lse): the forward with each row's f32 log-sum-exp
    (B, Hk, G, S), outside autograd; the kernel on a CUDA tensor (one
    counted launch), the plain version on a CPU tensor."""
    _check(q, k, v, kind, q.shape[3], q.shape[3])
    return _forward(q, k, v, scale, kind, window, with_lse=True)


def flash_attention_bwd(q, k, v, out, lse, dout, *, scale, kind="full", window=0):
    """(dq, dk, dv) from the forward's ``out`` and ``lse`` and the output
    gradient ``dout``, outside autograd; the backward kernel on a CUDA
    tensor (one counted launch of its three kernels), the plain version on
    a CPU tensor."""
    _check(q, k, v, kind, q.shape[3], q.shape[3])
    return _backward(q, k, v, out, lse, dout, scale, kind, window)


def _fold(x, d, n):
    """x with its vmapped dim ``d`` (None: not vmapped, so expanded to ``n``)
    folded into the leading batch dim."""
    x = x.expand(n, *x.shape) if d is None else x.movedim(d, 0)
    return x.reshape((n * x.shape[1],) + x.shape[2:])


def _unfold(x, n):
    return x.reshape((n, x.shape[0] // n) + x.shape[1:])


class Attention(torch.autograd.Function):
    """K4's forward with ``lse``, differentiable through ``AttentionBwd``;
    returns (out, lse), lse not differentiable."""

    @staticmethod
    def forward(q, k, v, scale, kind, window):
        return _forward(q, k, v, scale, kind, window, with_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale, kind, window = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (scale, kind, window)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = AttentionBwd.apply(q, k, v, out, lse, dout, *ctx.attrs)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, scale, kind, window):
        n = info.batch_size
        q, k, v = (_fold(x, d, n) for x, d in zip((q, k, v), in_dims[:3]))
        out, lse = Attention.apply(q, k, v, scale, kind, window)
        return (_unfold(out, n), _unfold(lse, n)), (0, 0)


class AttentionBwd(torch.autograd.Function):
    """K4's backward: (dq, dk, dv) from q, k, v, out, lse and dout. Not
    differentiable itself."""

    @staticmethod
    def forward(q, k, v, out, lse, dout, scale, kind, window):
        return _backward(q, k, v, out, lse, dout, scale, kind, window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("K4's backward has no backward of its own")

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, dout, scale, kind, window):
        n = info.batch_size
        args = (_fold(x, d, n) for x, d in zip((q, k, v, out, lse, dout), in_dims[:6]))
        grads = AttentionBwd.apply(*args, scale, kind, window)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def under_torch_func() -> bool:
    """Is a ``torch.func`` transform (``grad``, ``vmap``) active?"""
    return torch._C._functorch.maybe_current_level() is not None


def _tracked(*ts) -> bool:
    """Is a gradient wanted, or is a ``torch.func`` transform active (whose
    batched or tracked tensors only the Functions take)?"""
    return under_torch_func() or (torch.is_grad_enabled()
                                  and any(t.requires_grad for t in ts))


def flash_attention(q, k, v, *, scale, kind="full", window=0,
                    block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K):
    """(B, Hk, G, S, D) causal attention of q over k/v, in q's dtype."""
    _check(q, k, v, kind, block_q or DEFAULT_BLOCK_Q, block_k or DEFAULT_BLOCK_K)
    if _tracked(q, k, v):
        return Attention.apply(q, k, v, float(scale), kind, int(window))[0]
    return _forward(q, k, v, scale, kind, window, with_lse=False)[0]
