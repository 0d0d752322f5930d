"""K5 on Hopper: one query token per (batch, kv head), with its G grouped
heads, against a KV cache whose slots at or past ``valid_len`` are masked.

Replaces the TPU kernel ``src/repro/kernels/flash_decode.py::flash_decode``
(``_decode_kernel``). The CUDA source is
``src/repro_torch/csrc/flash_decode.cu``: each (batch, kv head, up to 8
query heads) is a thread-block cluster of up to 8 CTAs, and CTA r takes
the slots ``[r * split, (r + 1) * split)`` of ``plan_splits(L)``. A CTA
brings its valid K and V rows into shared memory with every load in
flight, takes the softmax of its G x slots scores as a block (one max, one
exp a score), and the CTAs' partials are merged in rank order through
distributed shared memory: one launch, no workspace, no atomics. The
split depends on L alone, so a row's result depends on that row alone.
``valid_len`` (0-d or (B,) int32) is read on the device, so a decode step
needs no host sync; the cache is read through strides, so the model's
(B, L, Hk, D) ring cache goes in as a transposed view with no copy.

Bound on the H100: it must read the valid K and V once; at the serving
decode shape (B, Hk, G, L, D) = (8, 4, 8, 640, 64) in bf16 with the cache
full that is 5.3 MB, 1.6 us at 3.35 TB/s, so it is memory-bound, and at
this size bound in practice by the latency of one pass and the launch.
The split puts 8 x 32 = 256 CTAs on the 132 SMs, 80 slots each.

``flash_decode(q, k, v, valid_len, scale=, block_l=)`` is the wrapper, with
the reference's signature: a CPU tensor goes to the plain version
``flash_decode_plain``, a CUDA tensor to the kernel, or the wrapper raises.
``block_l`` is checked but does not change the result (the reference pads
to it). ``launches`` counts the kernel calls.

A meta tensor (the dry-run) takes a third route: the kernel route's checks
(all but the pointers' alignment) and an output of the kernel's shape, with
nothing computed; it never reaches the plain version and counts
``meta_launches``, never ``launches``. On the card and on meta alike each
call reports ``cost`` through ``kernels._report``, at the whole cache:
``valid_len`` lives on the device, and reading it would cost a decode step
a host sync.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Tuple

import torch

from repro_torch.kernels import _report

launches = 0  # kernel calls
meta_launches = 0  # calls on the meta device (nothing launched)
NEG_INF = -1e30
DEFAULT_BLOCK_L = 1024
HEAD_DIMS = (32, 64, 128)  # head dims the kernel is built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SPLITS = 8  # CTAs of a cluster: the portable cluster size
MIN_SPLIT = 16  # slots a split takes at least
# the launch's 18 int64 parameters: B, Hk, G, L, D, nsplit, split, the
# valid_len stride, dtype, then the strides of q, k and v (3 each)
_PARAMS = struct.Struct("18q")


@functools.lru_cache(maxsize=None)
def plan_splits(L: int) -> Tuple[int, int]:
    """(nsplit, split) for a cache of L slots: split r takes the slots
    ``[r * split, min((r + 1) * split, L))``. From L alone (never the batch
    or ``valid_len``); 1 to ``MAX_SPLITS`` splits, none empty, together
    covering ``[0, L)`` once."""
    if L <= 0:
        raise ValueError(f"the cache needs a slot, got L={L}")
    split = max(MIN_SPLIT, -(-L // MAX_SPLITS))
    return -(-L // split), split


def cost(B: int, Hk: int, G: int, L: int, D: int, dtype, valid_rows=None) -> tuple:
    """(FLOPs, bytes read, bytes written) of one call: ``4 D`` flops per
    query head per valid slot (q.K and the weighted V), the valid K and V
    rows and q read once, the output written once. ``valid_rows``: the
    valid slots summed over the batch (default every slot of every row,
    ``B * L``). The kernel's bound divides the bytes by HBM's rate (the
    FLOPs by the bf16 peak)."""
    rows = B * L if valid_rows is None else int(valid_rows)
    q_n = B * Hk * G * D
    return 4 * rows * Hk * G * D, (2 * rows * Hk * D + q_n) * dtype.itemsize, q_n * dtype.itemsize


def _valid_len(valid_len, B, device) -> torch.Tensor:
    if (isinstance(valid_len, torch.Tensor) and valid_len.dtype == torch.int32
            and valid_len.device == device):
        vl = valid_len
    else:
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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_char_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, block_l):
    qs, ks, vs = q.shape, k.shape, v.shape
    if len(qs) != 4 or len(ks) != 4 or len(vs) != 4:
        raise ValueError(f"expected q (B, Hk, G, D) and k/v (B, Hk, L, D), got "
                         f"{tuple(qs)}, {tuple(ks)}, {tuple(vs)}")
    want = (qs[0], qs[1], ks[2], qs[3])  # (B, Hk, L, D)
    if ks != want or vs != want:
        raise ValueError(f"k/v must be {want}, got {tuple(ks)}, {tuple(vs)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if block_l <= 0:
        raise ValueError(f"block_l must be positive, got {block_l}")


def _check_kernel(q, k, v):
    """What the CUDA kernel takes: 16-byte loads of each row (on a meta
    tensor, the strides alone)."""
    if q.dtype not in DTYPES:
        raise ValueError(f"the K5 kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the K5 kernel takes head dims {HEAD_DIMS}, got "
                         f"{q.shape[3]}")
    vec = 16 // q.element_size()
    for t in (q, k, v):
        st = t.stride()
        if (st[3] != 1 or (not t.is_meta and t.data_ptr() % 16) or st[0] % vec
                or st[1] % vec or st[2] % vec):
            raise ValueError("q, k and v need 16-byte aligned rows, contiguous "
                             "in the head dim")


def flash_decode(q, k, v, valid_len, *, scale, block_l=DEFAULT_BLOCK_L):
    """(B, Hk, G, D) attention of one token's queries over the cache."""
    _check(q, k, v, block_l or DEFAULT_BLOCK_L)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, valid_len, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_decode runs on cpu, cuda or meta, got {q.device}")
    _check_kernel(q, k, v)
    B, Hk, G, D = q.shape
    L = k.shape[2]
    with _report.call("flash_decode", lambda: cost(B, Hk, G, L, D, q.dtype)):
        return _route(q, k, v, valid_len, scale)


def _route(q, k, v, valid_len, scale):
    global launches, meta_launches
    B, Hk, G, D = q.shape
    L = k.shape[2]
    vl = _valid_len(valid_len, B, q.device)
    nsplit, split = plan_splits(L)
    out = torch.empty((B, Hk, G, D), dtype=q.dtype, device=q.device)
    if q.is_meta:
        meta_launches += 1
        return out
    params = _PARAMS.pack(B, Hk, G, L, D, nsplit, split, 1 if vl.dim() == 1 else 0,
                          DTYPES[q.dtype], *q.stride()[:3], *k.stride()[:3],
                          *v.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), vl.data_ptr(), out.data_ptr(),
            params, float(scale))
    fn = _launcher()
    # the raw stream handle: a decode step makes one call a layer, and the
    # public torch.cuda.current_stream builds a Stream object each time
    index = q.device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(q.device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    launches += 1
    return out
