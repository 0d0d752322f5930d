"""K6 on Hopper: the Mamba2 SSD chunked scan.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py::ssd_scan``
(``_ssd_kernel``), and computes the function of the reference model's
``models/ssm.py::ssd_chunked``: y (B, S, nh, hd) **f32** and the final
(B, nh, hd, ds) f32 state, from an optional ``h0`` (zeros if None). The
Pallas kernel writes y in x's dtype and no state; the port's model needs
the state for its prefill cache and adds ``D * x`` in f32 before it casts,
so the kernel writes both in f32 (``ops.ssd_scan`` casts y to x's dtype,
as the Pallas entry does).

The CUDA source is ``src/repro_torch/csrc/ssd_scan.cu``. bf16 x, B and C
with chunks of at most 256 (the model's route) take the chunked SSD
decomposition in ``PHASES`` kernels from one C call: CB^T once per (batch,
chunk) for all heads; each chunk's own state; the state passed over the
chunks in order; each chunk's output, 1024 CTAs at the main shape. Every
product is a bf16 tensor-core product with f32 accumulators; its f32
operand goes in as ``BF16_TERMS`` bf16 terms (hi + lo), which holds the
f32 tolerance of 1e-4 where one term does not. f32 inputs (and longer
bf16 chunks) take the f32 FMA kernel: one CTA per (batch, head) walking
the chunks. x, B and C are read through strides, so the model's slices of
its conv output go in with no copy. The wrapper allocates the tensor-core
route's workspace (chunk states, the entering states as bf16 terms, CB^T,
chunk totals) with ``torch.empty``.

Bound on the H100 at mamba2-370m's prefill shape (B, S, nh, hd, ds) =
(4, 2048, 32, 64, 128), chunk 256, bf16: 26 GFLOP of tensor-core work (the
three products per (batch, head, chunk) once per term, and CB^T; 26 us at
989 TFLOP/s) against 110 MB of inputs and outputs (33 us at 3.35 TB/s):
bound by bytes; the schedule's 151 MB of workspace traffic makes it 78 us.
The FMA route's schedule at that shape needs 21.5 GFLOP of f32 FMA work
(0.32 ms at 67 TFLOP/s).

``ssd_scan(x, dt, A, B_, C_, chunk, h0=None)`` is the wrapper: a CPU tensor
goes to the plain version ``ssd_chunked_plain`` (differentiable), a CUDA
tensor to the kernel, which raises under autograd (K6's backward is
ROADMAP queue 1's slice G2b) and on shapes it does not take. ``launches`` counts the
kernel calls (one a call, whatever the number of phases).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

launches = 0  # kernel calls
# (head_dim, d_state) pairs the kernel is built for
SHAPES = ((32, 16), (32, 64), (32, 128), (64, 16), (64, 64), (64, 128))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PHASES = 4  # kernels of the bf16 tensor-core route, from one C call
BF16_TERMS = 2  # bf16 terms each f32 operand of that route is split into


def ssd_chunked_plain(x, dt, A, B_, C_, chunk: int,
                      h0: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``repro.models.ssm.ssd_chunked`` on torch
    tensors. x (B, S, nh, hd), dt (B, S, nh) post-softplus, A (nh,)
    negative, B_/C_ (B, S, ds); chunks of L = min(chunk, S) in order, the
    state carried in f32. Returns (y (B, S, nh, hd) f32, h_final
    (B, nh, hd, ds) f32)."""
    Bb, S, nh, hd = x.shape
    ds = B_.shape[-1]
    L = min(chunk, S)
    nc = S // L
    xr = x.reshape(Bb, nc, L, nh, hd)
    dtr = dt.reshape(Bb, nc, L, nh)
    Br = B_.reshape(Bb, nc, L, ds)
    Cr = C_.reshape(Bb, nc, L, ds)
    h = (torch.zeros((Bb, nh, hd, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        xc, dtc = xr[:, c].float(), dtr[:, c]
        Bc, Cc = Br[:, c].float(), Cr[:, c].float()
        cs = torch.cumsum(dtc.float() * A, dim=1)  # (B, L, nh), inclusive
        total = cs[:, -1]  # (B, nh)
        # intra-chunk (dual, attention-like) term
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)
        decay = torch.exp(cs[:, :, None, :] - cs[:, None, :, :])  # (B, i, j, nh)
        scores = cb[..., None] * decay * dtc[:, None, :, :]
        scores = torch.where(mask[None, :, :, None], scores, 0.0)
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, xc)
        # inter-chunk term from the carried state
        y_inter = torch.exp(cs)[..., None] * torch.einsum("bin,bhpn->bihp", Cc, h)
        # state update
        w = torch.exp(total[:, None, :] - cs) * dtc  # (B, L, nh)
        h_chunk = torch.einsum("blh,blhp,bln->bhpn", w, xc, Bc)
        h = torch.exp(total)[:, :, None, None] * h + h_chunk
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1).reshape(Bb, S, nh, hd), h


@functools.cache
def _launcher():
    """The built library's ``ssd_scan_launch`` and ``ssd_scan_workspace``,
    typed (built at first use)."""
    from repro_torch.kernels.build import library

    lib = library("ssd_scan")
    fn = lib.ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = lib.ssd_scan_workspace
    ws.argtypes = [ctypes.c_int] * 7
    ws.restype = ctypes.c_longlong
    return fn, ws


def _check(x, dt, A, B_, C_, chunk, h0):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_.dim() != 3 or C_.dim() != 3:
        raise ValueError(
            f"expected x (B, S, nh, hd), dt (B, S, nh), A (nh,), B_/C_ (B, S, ds); got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
            f"{tuple(B_.shape)}, {tuple(C_.shape)}")
    Bb, S, nh, hd = x.shape
    ds = B_.shape[-1]
    if (tuple(dt.shape) != (Bb, S, nh) or tuple(A.shape) != (nh,)
            or tuple(B_.shape) != (Bb, S, ds) or tuple(C_.shape) != (Bb, S, ds)):
        raise ValueError("dt, A, B_ and C_ do not match x's (B, S, nh)")
    L = min(chunk, S)
    if L <= 0 or S % L:
        raise ValueError(f"S={S} must divide into chunks of {L}")
    if h0 is not None and tuple(h0.shape) != (Bb, nh, hd, ds):
        raise ValueError(f"h0 must be {(Bb, nh, hd, ds)}, got {tuple(h0.shape)}")
    if len({t.device for t in (x, dt, A, B_, C_)}) != 1:
        raise ValueError("x, dt, A, B_ and C_ must be on one device")


def _check_kernel(x, dt, A, B_, C_, h0):
    """What the CUDA kernel takes beyond the reference's conditions."""
    hd, ds = x.shape[-1], B_.shape[-1]
    if not (x.dtype == B_.dtype == C_.dtype) or x.dtype not in DTYPES:
        raise ValueError(f"the K6 kernel takes x, B_ and C_ all float32 or all "
                         f"bfloat16, got {x.dtype}, {B_.dtype}, {C_.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if (hd, ds) not in SHAPES:
        raise ValueError(f"the K6 kernel takes (head_dim, d_state) in {SHAPES}, "
                         f"got {(hd, ds)}")
    if any(t.stride(-1) != 1 for t in (x, B_, C_)):
        raise ValueError("x, B_ and C_ must be contiguous in their last dim")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B_, C_) + ((h0,) if h0 is not None else ())):
        raise RuntimeError(
            "the K6 kernel has no backward yet: Mamba2 training on the GPU "
            "arrives with ROADMAP queue 1, slice G2b (K6's backward); run it "
            "under torch.no_grad()")


def ssd_scan(x, dt, A, B_, C_, chunk: int = 256,
             h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, nh, hd) f32, h_final (B, nh, hd, ds) f32) of the chunked
    scan, from ``h0`` or a zero state."""
    global launches
    _check(x, dt, A, B_, C_, chunk, h0)
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, A, B_, C_, chunk, h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, got {x.device}")
    Bb, S, nh, hd = x.shape
    ds = B_.shape[-1]
    L = min(chunk, S)  # a chunk too long for shared memory fails the launch
    _check_kernel(x, dt, A, B_, C_, h0)
    A = A.contiguous()
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
        if h0.data_ptr() % 16:  # the state pass reads it 16 bytes at a time
            h0 = h0.clone()
    y = torch.empty((Bb, S, nh, hd), dtype=torch.float32, device=x.device)
    h_final = torch.empty((Bb, nh, hd, ds), dtype=torch.float32, device=x.device)
    row_strides = x.stride()[:3] + B_.stride()[:2] + C_.stride()[:2]
    strides = (ctypes.c_longlong * 10)(*row_strides, *dt.stride())
    # every row of x, B and C 16-byte aligned: 16-byte loads
    vec = all(t.data_ptr() % 16 == 0 for t in (x, B_, C_)) and all(
        s % (16 // x.element_size()) == 0 for s in row_strides)
    fn, workspace = _launcher()
    n_ws = workspace(Bb, S, nh, hd, ds, L, DTYPES[x.dtype])
    ws = torch.empty((n_ws,), dtype=torch.float32, device=x.device) if n_ws else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
                 C_.data_ptr(), h0.data_ptr() if h0 is not None else None,
                 y.data_ptr(), h_final.data_ptr(),
                 ws.data_ptr() if ws is not None else None, Bb, S, nh, hd, ds, L,
                 strides, DTYPES[x.dtype], int(vec), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    launches += 1
    return y, h_final
