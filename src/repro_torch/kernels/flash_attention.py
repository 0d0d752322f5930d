"""K4 on Hopper: causal GQA flash attention forward (full, sliding or
chunked masks).

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

``flash_attention(q, k, v, scale=, kind=, window=, block_q=, block_k=)`` is
the wrapper, with the reference's signature: a CPU tensor goes to the plain
version ``flash_attention_plain`` (differentiable), a CUDA tensor to the
kernel, which raises under autograd (the reference kernel has no VJP) and
on shapes it does not take. ``block_q``/``block_k`` are checked as the
reference checks them (S must divide into both); the kernel tiles by its
own sizes. ``launches`` counts the kernel calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

launches = 0  # kernel calls
NEG_INF = -1e30
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 512
KINDS = {"full": 0, "sliding": 1, "chunked": 2}
HEAD_DIMS = (32, 64, 128)  # head dims the kernel is built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CTA_ROWS = 128  # rows of a bf16 CTA: two consumer warpgroups of 64
ENCODE_ERROR = 1000  # the launcher returns 1000 + CUresult when a tensor map fails


def tile_rows(G: int) -> tuple:
    """(positions, rows) of one bf16 CTA at G query heads per kv head:
    ``128 // G`` whole positions, each with all G heads; rows past
    ``positions * G`` are padding, computed and never stored."""
    if not 1 <= G <= CTA_ROWS:
        raise ValueError(f"the bf16 K4 kernel takes 1 <= G <= {CTA_ROWS} query heads "
                         f"per kv head, got {G}")
    P = CTA_ROWS // G
    return P, P * G


def flash_attention_plain(q, k, v, *, scale, kind="full", window=0):
    """The plain version: the direct masked softmax of
    ``repro.kernels.ref.flash_attention_ref``. q (B, Hk, G, S, D), k/v
    (B, Hk, S, D); scores in f32, the softmax weights cast to v's dtype."""
    S = q.shape[3]
    pos = torch.arange(S, device=q.device)
    qp, kp = pos[:, None], pos[None, :]
    mask = kp <= qp
    if kind == "sliding" and window > 0:
        mask &= kp > qp - window
    elif kind == "chunked" and window > 0:
        mask &= (kp // window) == (qp // window)
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, k).float() * scale
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", w.to(v.dtype), v)


@functools.cache
def _launcher():
    """The built library's ``flash_attention_launch``, typed (built at
    first use)."""
    from repro_torch.kernels.build import library

    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    bq, bk = min(block_q, S), min(block_k, S)
    if S % bq or S % bk:
        raise ValueError(f"S={S} must divide into both block sizes ({bq}, {bk})")


def _check_kernel(q, k, v, scale):
    """What the CUDA kernel takes beyond the reference's conditions."""
    D = q.shape[-1]
    if q.dtype not in DTYPES:
        raise ValueError(f"the K4 kernel takes float32 or bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the K4 kernel takes head dims {HEAD_DIMS}, got {D}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous in the head dim")
    if q.dtype == torch.bfloat16:  # TMA: 16-byte aligned base and strides
        if any(t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1])
               for t in (q, k, v)):
            raise ValueError("bf16 q, k and v need 16-byte aligned rows")
        tile_rows(q.shape[2])
        if not scale > 0:  # it takes the row max of the unscaled scores
            raise ValueError(f"the bf16 K4 kernel takes a positive scale, got {scale}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the K4 kernel has no backward (the reference's Pallas kernel has "
            "no VJP either); run it under torch.no_grad()")


def flash_attention(q, k, v, *, scale, kind="full", window=0,
                    block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K):
    """(B, Hk, G, S, D) causal attention of q over k/v, in q's dtype."""
    global launches
    _check(q, k, v, kind, block_q or DEFAULT_BLOCK_Q, block_k or DEFAULT_BLOCK_K)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, kind=kind, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, got {q.device}")
    _check_kernel(q, k, v, scale)
    B, Hk, G, S, D = q.shape
    # written in (B, S, Hk, G, D) order, so the model's move back to
    # (B, S, H, D) is a free view
    out = torch.empty((B, S, Hk, G, D), dtype=q.dtype,
                      device=q.device).permute(0, 2, 3, 1, 4)
    strides = (ctypes.c_longlong * 14)(
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *out.stride()[:4])
    fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Hk, G, S, D, strides, float(scale), KINDS[kind], int(window),
                 DTYPES[q.dtype], stream)
    if err >= ENCODE_ERROR:
        raise RuntimeError(f"flash_attention: a TMA tensor map could not be encoded "
                           f"(CUresult {err - ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out
