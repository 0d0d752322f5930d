"""K5 on Hopper: one query token per (batch, kv head), with its G grouped
heads, against a KV cache whose slots at or past ``valid_len`` are masked.

Replaces the TPU kernel ``src/repro/kernels/flash_decode.py::flash_decode``
(``_decode_kernel``). The CUDA source is
``src/repro_torch/csrc/flash_decode.cu``: one CTA of 8 warps per (batch,
kv head, up to 8 query heads) walks only the valid slots, 16 bytes of a
K/V row per lane, the G query heads in registers, an f32 online softmax
per slot group merged by shuffles and through shared memory at the end.
``valid_len`` (0-d or (B,) int32) is read on the device, so a decode step
needs no host sync. The cache is read through strides, so the model's
(B, L, Hk, D) ring cache goes in as a transposed view with no copy, and
the ragged tail is masked in the kernel, with no padding to ``block_l``.

Bound on the H100: it must read the valid K and V once; at the serving
decode shape (B, Hk, G, L, D) = (8, 4, 8, 640, 64) in bf16 with the cache
full that is 5.2 MB, 1.6 us at 3.35 TB/s, so it is memory-bound, and in
practice bound by the launch. B * Hk = 32 CTAs fill 32 of the 132 SMs: a
split over L (ROADMAP) is the next step.

``flash_decode(q, k, v, valid_len, scale=, block_l=)`` is the wrapper, with
the reference's signature: a CPU tensor goes to the plain version
``flash_decode_plain``, a CUDA tensor to the kernel, or the wrapper raises.
``block_l`` is checked but does not change the result (the reference pads
to it). ``launches`` counts the kernel calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

launches = 0  # kernel calls
NEG_INF = -1e30
DEFAULT_BLOCK_L = 1024
HEAD_DIMS = (32, 64, 128)  # head dims the kernel is built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _valid_len(valid_len, B, device) -> torch.Tensor:
    vl = torch.as_tensor(valid_len, dtype=torch.int32, device=device)
    if vl.dim() > 1 or (vl.dim() == 1 and vl.shape[0] != B):
        raise ValueError(f"valid_len must be () or ({B},), got {tuple(vl.shape)}")
    return vl


def flash_decode_plain(q, k, v, valid_len, *, scale):
    """The plain version: ``repro.kernels.ref.flash_decode_ref``. q
    (B, Hk, G, D), k/v (B, Hk, L, D); slots at or past ``valid_len`` get
    the -1e30 sentinel; scores in f32, weights cast to v's dtype."""
    B, L = q.shape[0], k.shape[2]
    s = torch.einsum("bhgd,bhld->bhgl", q, k).float() * scale
    vl = _valid_len(valid_len, B, q.device).broadcast_to((B,))
    valid = torch.arange(L, device=q.device)[None] < vl[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgl,bhld->bhgd", w.to(v.dtype), v)


@functools.cache
def _launcher():
    """The built library's ``flash_decode_launch``, typed (built at first
    use)."""
    from repro_torch.kernels.build import library

    fn = library("flash_decode").flash_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                             ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, block_l):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q (B, Hk, G, D) and k/v (B, Hk, L, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hk, G, D = q.shape
    L = k.shape[2]
    if tuple(k.shape) != (B, Hk, L, D) or tuple(v.shape) != (B, Hk, L, D):
        raise ValueError(f"k/v must be {(B, Hk, L, D)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if block_l <= 0:
        raise ValueError(f"block_l must be positive, got {block_l}")


def _check_kernel(q, k, v):
    """What the CUDA kernel takes: 16-byte loads of each row."""
    if q.dtype not in DTYPES:
        raise ValueError(f"the K5 kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the K5 kernel takes head dims {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError("q, k and v need 16-byte aligned rows, contiguous "
                             "in the head dim")


def flash_decode(q, k, v, valid_len, *, scale, block_l=DEFAULT_BLOCK_L):
    """(B, Hk, G, D) attention of one token's queries over the cache."""
    global launches
    _check(q, k, v, block_l or DEFAULT_BLOCK_L)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, valid_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cpu or cuda, got {q.device}")
    _check_kernel(q, k, v)
    B, Hk, G, D = q.shape
    L = k.shape[2]
    vl = _valid_len(valid_len, B, q.device)
    out = torch.empty((B, Hk, G, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), vl.data_ptr(),
                 1 if vl.dim() == 1 else 0, out.data_ptr(), B, Hk, G, L, D,
                 strides, float(scale), DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    launches += 1
    return out
