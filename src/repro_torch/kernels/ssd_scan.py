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

The backward (``csrc/ssd_scan_bwd.cu``) replaces no TPU kernel: the
reference differentiates its jnp ``ssd_chunked`` with ``jax.grad`` and its
Pallas kernel has no VJP. Given the state entering each chunk (``h_in``,
which the forward writes in f32 when a gradient is wanted) it computes dx,
ddt, dA, dB, dC and dh0 with no float atomics. bf16 inputs with chunks of
at most 256 and d_state of at least 64 (``tc_route``) take seven kernels on
``wgmma``: CB once per (batch, chunk); a pre-pass (the warp-scan cumsum,
dy's two bf16 planes, each chunk's own state term); the state gradient
passed over the chunks in reverse (dH_out's and h_in's planes); a j-side
and an i-side kernel, persistent and warp-specialised, fed by TMA and bulk
copies through mbarrier rings, whose work items are (batch, chunk, 64-row
block, group of heads) in the order of ``bwd_plan``; a tail and the sums
over the head groups. Each f32 operand goes in as two bf16 terms
(``BWD_TERMS``). f32 inputs and the other bf16 shapes take the f32 FMA
route (four kernels). Every ``exp`` takes a difference masked to <= 0
first: the reference's ``jax.grad`` of ``ssd_chunked`` gives NaN in ddt and
dA once sum dt |A| over a chunk passes about 88, the backward stays
finite. ``ssd_chunked_bwd_plain`` is its plain version.

``ssd_scan(x, dt, A, B_, C_, chunk, h0=None)`` is the wrapper. Without
autograd (and outside ``torch.func`` transforms) a CPU tensor goes to the
plain version ``ssd_chunked_plain`` and a CUDA tensor to the forward kernel
without ``h_in``, as serving runs it. When a gradient is wanted, or under
``torch.func.vmap``/``grad``, the call goes through ``SSDScan``, an
``autograd.Function`` whose forward saves ``h_in`` and whose backward runs
``SSDScanBwd`` around the backward kernel; each has a ``vmap`` rule that
folds the vmapped dimension into B (a vmapped A becomes one row per batch
row, read through a batch stride). On the CPU both take their plain
versions; a CUDA tensor reaches only the kernels, or raises on shapes they
do not take. ``launches`` counts the forward kernel's calls (one a call,
whatever the number of phases), ``bwd_launches`` the backward's (one a
call, whatever the number of kernels).

A meta tensor (the dry-run) takes a third route: the kernel route's checks
and outputs of the kernel's shapes and dtypes (y and the state in f32,
``h_in`` where the forward writes it; no workspace), with nothing
computed; it never reaches the plain version and counts
``meta_launches``/``meta_bwd_launches``, never ``launches``/
``bwd_launches``. On the card and on meta alike each call reports ``cost``
through ``kernels._report``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import _fold, _order_on, _tracked, _unfold
from repro_torch.kernels import _report

launches = 0  # forward kernel calls
bwd_launches = 0  # backward kernel calls
meta_launches = 0  # forward calls on the meta device (nothing launched)
meta_bwd_launches = 0  # backward calls on the meta device
# (head_dim, d_state) pairs the kernel is built for
SHAPES = ((32, 16), (32, 64), (32, 128), (64, 16), (64, 64), (64, 128))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PHASES = 4  # kernels of the bf16 tensor-core route, from one C call
BF16_TERMS = 2  # bf16 terms each f32 operand of that route is split into
BWD_TERMS = 2  # the same, on the backward's tensor-core route


def _wide(t):
    """t in f32, or f64 where it is f64 (the plain versions run in either)."""
    return t.to(_wide_dtype(t))


def _wide_dtype(t):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _rows(A, Bb):
    """A as one (B, nh) row per batch row (a view)."""
    return A if A.dim() == 2 else A[None].expand(Bb, A.shape[0])


def ssd_chunked_plain(x, dt, A, B_, C_, chunk: int,
                      h0: Optional[torch.Tensor] = None, return_h_in: bool = False):
    """The plain version: ``repro.models.ssm.ssd_chunked`` on torch
    tensors. x (B, S, nh, hd), dt (B, S, nh) post-softplus, A (nh,) (or
    one (B, nh) row per batch row) negative, B_/C_ (B, S, ds); chunks of
    L = min(chunk, S) in order, the state carried in f32. Returns (y
    (B, S, nh, hd) f32, h_final (B, nh, hd, ds) f32), and with
    ``return_h_in`` the state entering each chunk (B, nh, nc, hd, ds) f32
    third."""
    Bb, S, nh, hd = x.shape
    ds = B_.shape[-1]
    L = min(chunk, S)
    nc = S // L
    xr = x.reshape(Bb, nc, L, nh, hd)
    dtr = dt.reshape(Bb, nc, L, nh)
    Br = B_.reshape(Bb, nc, L, ds)
    Cr = C_.reshape(Bb, nc, L, ds)
    a = A if A.dim() == 1 else A[:, None, :]
    h = (torch.zeros((Bb, nh, hd, ds), dtype=_wide_dtype(x), device=x.device)
         if h0 is None else h0)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    ys, h_in = [], []
    for c in range(nc):
        h_in.append(h)
        xc, dtc = _wide(xr[:, c]), dtr[:, c]
        Bc, Cc = _wide(Br[:, c]), _wide(Cr[:, c])
        cs = torch.cumsum(_wide(dtc) * a, dim=1)  # (B, L, nh), inclusive
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
    y = torch.stack(ys, dim=1).reshape(Bb, S, nh, hd)
    if return_h_in:
        return y, h, _wide(torch.stack(h_in, dim=2))
    return y, h


def ssd_chunked_bwd_plain(x, dt, A, B_, C_, chunk: int, h_in, dy, dh_final=None):
    """The plain backward of ``ssd_chunked_plain``, chunk by chunk in
    reverse: ``h_in`` (B, nh, nc, hd, ds) f32 holds the state entering each
    chunk, ``dy`` (B, S, nh, hd) and ``dh_final`` (B, nh, hd, ds, or None:
    zeros) the output gradients. Returns (dx, ddt, dA, dB, dC, dh0), all
    f32, dA of A's shape. Per chunk, with cs the cumsum of dt * A, T its
    last entry, M_ij = C_i.B_j exp(cs_i - cs_j) dt_j (j <= i) and
    w_j = exp(T - cs_j) dt_j: dx_j = sum_i M_ij dy_i + w_j dH B_j, dB_j and
    dC_i through P_ij = dy_i.x_j exp(cs_i - cs_j) dt_j, d cs from
    dy_i.x_j M_ij and the state terms, ddt = its direct part + A times the
    reverse cumsum dl of d cs, dA = sum dt dl. Every ``exp`` takes a
    difference masked to <= 0 first, so no 0 * inf enters a gradient (the
    reference's ``jax.grad`` of ``ssd_chunked`` masks after its ``exp``)."""
    Bb, S, nh, hd = x.shape
    ds = B_.shape[-1]
    L = min(chunk, S)
    nc = S // L
    xr = x.reshape(Bb, nc, L, nh, hd)
    dtr = dt.reshape(Bb, nc, L, nh)
    Br = B_.reshape(Bb, nc, L, ds)
    Cr = C_.reshape(Bb, nc, L, ds)
    dyr = dy.reshape(Bb, nc, L, nh, hd)
    a = _wide(_rows(A, Bb))[:, None, :]  # (B, 1, nh)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))[None, :, :, None]
    dH = (torch.zeros((Bb, nh, hd, ds), dtype=_wide_dtype(x), device=x.device)
          if dh_final is None else _wide(dh_final))
    dxs, ddts, dBs, dCs = [], [], [], []
    dA = torch.zeros((Bb, nh), dtype=_wide_dtype(x), device=x.device)
    for c in reversed(range(nc)):
        xc, dtc, dyc = _wide(xr[:, c]), _wide(dtr[:, c]), _wide(dyr[:, c])
        Bc, Cc = _wide(Br[:, c]), _wide(Cr[:, c])
        hc = h_in[:, :, c]
        cs = torch.cumsum(dtc * a, dim=1)  # (B, L, nh)
        total = cs[:, -1]  # (B, nh)
        diff = cs[:, :, None, :] - cs[:, None, :, :]  # (B, i, j, nh)
        decay = torch.exp(torch.where(mask, diff, -torch.inf))  # 0 above the diagonal
        ecs = torch.exp(cs)
        e_t = torch.exp(total[:, None, :] - cs)
        w = e_t * dtc
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)[..., None]
        dM = torch.einsum("bihp,bjhp->bijh", dyc, xc)
        M = cb * decay * dtc[:, None]
        P = dM * decay * dtc[:, None]
        Q = dM * cb * decay  # ddt's direct part, before the sum over i
        G = Q * dtc[:, None]  # dM M
        V = torch.einsum("bjn,bhpn->bjhp", Bc, dH)  # dH B_j
        Wx = torch.einsum("bjhp,bhpn->bjhn", xc, dH)  # dH^T x_j
        R = torch.einsum("bihp,bhpn->bihn", dyc, hc)  # h_in^T dy_i
        u = torch.einsum("bjhn,bjn->bjh", Wx, Bc)
        dxs.append(torch.einsum("bijh,bihp->bjhp", M, dyc) + w[..., None] * V)
        dBs.append(torch.einsum("bijh,bin->bjn", P, Cc)
                   + torch.einsum("bjh,bjhn->bjn", w, Wx))
        dCs.append(torch.einsum("bijh,bjn->bin", P, Bc)
                   + torch.einsum("bih,bihn->bin", ecs, R))
        dcs = G.sum(2) - G.sum(1) + ecs * torch.einsum("bihn,bin->bih", R, Cc) - w * u
        last = torch.exp(total) * (dH * hc).sum((-2, -1)) + (w * u).sum(1)
        dcs = torch.cat([dcs[:, :-1], dcs[:, -1:] + last[:, None]], dim=1)
        dl = torch.flip(torch.cumsum(torch.flip(dcs, (1,)), 1), (1,))
        ddts.append(Q.sum(1) + e_t * u + a * dl)
        dA = dA + (dtc * dl).sum(1)
        dH = torch.exp(total)[:, :, None, None] * dH + torch.einsum(
            "bih,bihp,bin->bhpn", ecs, dyc, Cc)
    cat = lambda ts: torch.cat(ts[::-1], dim=1)  # noqa: E731
    return (cat(dxs), cat(ddts), dA if A.dim() == 2 else dA.sum(0), cat(dBs), cat(dCs), dH)


@functools.cache
def _launcher():
    """The built library's ``ssd_scan_launch`` and ``ssd_scan_workspace``,
    typed (built at first use)."""
    from repro_torch.kernels.build import library

    lib = library("ssd_scan")
    fn = lib.ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = lib.ssd_scan_workspace
    ws.argtypes = [ctypes.c_int] * 7
    ws.restype = ctypes.c_longlong
    return fn, ws


@functools.cache
def _bwd_launcher():
    """The built library's ``ssd_scan_bwd_launch`` and
    ``ssd_scan_bwd_workspace``, typed (built at first use); the tensor-core
    route's shared memory checked against ``bwd_plan``'s for every shape."""
    from repro_torch.kernels.build import library

    lib = library("ssd_scan_bwd")
    cfg = lib.ssd_scan_bwd_config
    cfg.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    cfg.restype = ctypes.c_int
    for hd, ds in SHAPES:
        if ds >= 64:
            out = (ctypes.c_int * 4)()
            if cfg(hd, ds, out) != 0 or tuple(out) != _bwd_smem(hd, ds):
                raise RuntimeError(f"csrc/ssd_scan_bwd.cu's shared memory at {(hd, ds)} is "
                                   f"{tuple(out)}, bwd_plan's {_bwd_smem(hd, ds)}")
    fn = lib.ssd_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = lib.ssd_scan_bwd_workspace
    ws.argtypes = [ctypes.c_int] * 8
    ws.restype = ctypes.c_longlong
    return fn, ws


# --- the bf16 backward's schedule (csrc/ssd_scan_bwd.cu's tensor-core route) --

BWD_BLOCK = 64  # rows of a j or i block
BWD_GROUP = 8  # heads of a work item (all of them where there are fewer)
BWD_STAGES = 2  # ring slots of the j-side and i-side kernels
TC_MAX_CHUNK = 256


def tc_route(dtype, ds: int, L: int) -> bool:
    """Whether the backward takes the tensor-core route: bf16 inputs,
    d_state of at least 64, chunks of at most 256."""
    return dtype == torch.bfloat16 and ds >= 64 and L <= TC_MAX_CHUNK


def cost(B: int, S: int, nh: int, hd: int, ds: int, L: int, dtype, backward: bool = False,
         a_rows: bool = False, h0: bool = False, h_in: bool = False,
         dh_final: bool = False) -> tuple:
    """(FLOPs, bytes read, bytes written) of one call at x (B, S, nh, hd),
    B_/C_ (B, S, ds), chunks of L, with the route's FLOPs: the tensor-core
    route's against the bf16 peak, the FMA route's against the f32 peak.

    Forward, bf16 with L <= 256: CB^T once per (batch, chunk), exact in
    bf16, then per (batch, head, chunk) the chunk state, C h_in^T and the
    causal scores times x, each once per bf16 term (``BF16_TERMS``) of its
    f32 operand; f32 (the FMA kernel): the scores once per head. Bytes: x,
    B_, C_, dt and A read, y and h_final written in f32 (h0 read and the
    entering states ``h_in`` written where given).

    Backward, bf16 on ``tc_route``: the flops the scan's gradient needs
    (CB once per (batch, chunk), and per (batch, head, chunk) the causal
    pairs' products and eight state products); the FMA route: f32 FMA on
    whole 64 x 64 block pairs, CB per head. Bytes: x, B_, C_, dt, A, h_in
    and dy (f32) read, dx, dB, dC, ddt, dA (a row per batch row) and dh0
    written (dh_final read where given)."""
    es, f4 = dtype.itemsize, 4
    nc, pairs = S // L, L * (L + 1) // 2
    x_n, bc_n, dt_n = B * S * nh * hd, B * S * ds, B * S * nh
    state, states = B * nh * hd * ds, B * nh * nc * hd * ds
    a_n = B * nh if a_rows else nh
    if not backward:
        if dtype == torch.bfloat16 and L <= TC_MAX_CHUNK:
            flops = B * nc * 2 * pairs * ds + BF16_TERMS * B * nh * nc * (
                4 * L * hd * ds + 2 * pairs * hd)
        else:
            flops = B * nh * nc * (2 * pairs * (ds + hd) + 4 * L * hd * ds)
        return (flops, (x_n + 2 * bc_n) * es + (dt_n + a_n + (state if h0 else 0)) * f4,
                (x_n + state + (states if h_in else 0)) * f4)
    if tc_route(dtype, ds, L):
        flops = B * nc * pairs * 2 * ds + B * nh * nc * (
            pairs * 2 * (2 * ds + 2 * hd) + 8 * L * hd * ds)
    else:
        nb = -(-L // BWD_BLOCK)
        flops = B * nh * nc * (8 * L * hd * ds + nb * (nb + 1) // 2 * BWD_BLOCK * BWD_BLOCK
                               * 2 * (3 * ds + 2 * hd))
    read = (x_n + 2 * bc_n) * es + (dt_n + a_n + states + x_n + (state if dh_final else 0)) * f4
    return flops, read, (x_n + 2 * bc_n) * es + (dt_n + B * nh + state) * f4


def _round1024(n: int) -> int:
    return -(-n // 1024) * 1024


@functools.cache
def _bwd_smem(hd: int, ds: int) -> tuple:
    """``TcCfg<hd, ds>`` of the CUDA source in ``ssd_scan_bwd_config``'s
    order: (j-side bytes, i-side bytes, pre-pass bytes, ring slots)."""
    x, bc, st, cb, rows = 64 * hd * 2, 64 * ds * 2, hd * ds * 2, 64 * 64 * 4, 64 * 4
    bars = 8 * (8 + 2 * BWD_STAGES) + 1024  # mbarriers and the 1024-byte alignment slack
    j_slot = _round1024(max(bc + cb + 4 * x + 2 * rows, 4 * st))
    j_smem = 2 * bc + 2 * _round1024(2 * x) + BWD_STAGES * j_slot + bars
    i_slot = _round1024(max(bc + cb + 2 * x + 4 * rows, 4 * st))
    i_smem = 2 * bc + 2 * _round1024(4 * x) + BWD_STAGES * i_slot + bars
    prep_smem = bc + 2 * x + 4 * (2 * 256 + 8) + 1024
    return (j_smem, i_smem, prep_smem, BWD_STAGES)


def bwd_workspace_floats(B: int, S: int, nh: int, hd: int, ds: int, L: int,
                         group: int) -> int:
    """``ssd_scan_bwd_workspace`` of the tensor-core route, in floats: the
    chunks' own state terms; their totals and dA parts; cs and dt; dy's bf16
    planes;
    dH_out's and h_in's; CB once per (batch, chunk); <dH_out, h_in>'s warp
    partials; d cs's row and column parts, ddt's direct part and w u; the
    head groups' dB and dC. Each region is whole KB."""
    nc, lp, ldc = S // L, -(-L // BWD_BLOCK) * BWD_BLOCK, (L + 3) // 4 * 4
    bhc, ng = B * nh * nc, -(-nh // group)
    sizes = [bhc * hd * ds, bhc, bhc, bhc * lp, bhc * lp, bhc * lp * hd, bhc * hd * ds,
             bhc * hd * ds, B * nc * L * ldc, bhc * hd * ds // 128] + [B * nh * S] * 4 + [
        ng * B * S * ds] * 2
    return sum(-(-n // 256) * 256 for n in sizes)


class SSDBwdPlan(NamedTuple):
    B: int
    S: int
    nh: int
    hd: int
    ds: int
    L: int
    chunks: int
    blocks: int  # 64-row blocks a chunk
    group: int  # heads a work item, in pairs (one a consumer warpgroup)
    groups: int
    j_order: tuple  # j blocks, longest walk (most i blocks) first
    i_order: tuple  # i blocks, longest walk (most j blocks) first
    items: int  # work items of each main kernel: (b, chunk, block, group)
    j_grid: int  # persistent CTAs: min(items, the card's SMs)
    i_grid: int
    j_smem: int
    i_smem: int
    prep_smem: int
    stages: int
    workspace_bytes: int
    launches: int  # kernels a call: CB, pre-pass, pass, j side, i side, tail, sums


def bwd_item(plan: SSDBwdPlan, t: int, side: str) -> tuple:
    """(b, chunk, block, group) of work item t of the "j" or "i" kernel, as
    the kernels decode it: the block from the plan's order, then (b, chunk,
    group) with the group fastest."""
    order = plan.j_order if side == "j" else plan.i_order
    per = plan.B * plan.chunks * plan.groups
    rest = t % per
    bc = rest // plan.groups
    return bc // plan.chunks, bc % plan.chunks, order[t // per], rest % plan.groups


def bwd_walk(plan: SSDBwdPlan, t: int, side: str) -> list:
    """The (b, chunk, head, i block, j block) pairs work item t visits, in
    order: its heads in turn, each walking i blocks from j's (j side) or j
    blocks up to i's (i side)."""
    b, c, blk, g = bwd_item(plan, t, side)
    heads = range(g * plan.group, min(plan.nh, (g + 1) * plan.group))
    if side == "j":
        return [(b, c, h, ib, blk) for h in heads for ib in range(blk, plan.blocks)]
    return [(b, c, h, blk, jb) for h in heads for jb in range(blk + 1)]


@functools.lru_cache(maxsize=256)
def bwd_plan(B: int, S: int, nh: int, hd: int, ds: int, L: int, *, sms: int) -> SSDBwdPlan:
    """The tensor-core backward's schedule at (B, S, nh, hd, ds), chunks of
    L, on a card of ``sms`` SMs (one persistent CTA per SM, fewer when
    there are fewer work items). The head-group size depends on nh alone,
    so a cohort folded into B sums its heads as each client's call does."""
    if (hd, ds) not in SHAPES or ds < 64 or not 0 < L <= TC_MAX_CHUNK or S % L:
        raise ValueError(f"no tensor-core backward at (hd, ds, L, S) = {(hd, ds, L, S)}")
    nc, nb = S // L, -(-L // BWD_BLOCK)
    group = min(nh, BWD_GROUP)
    groups = -(-nh // group)
    items = B * nc * nb * groups
    j_smem, i_smem, prep_smem, stages = _bwd_smem(hd, ds)
    return SSDBwdPlan(
        B, S, nh, hd, ds, L, nc, nb, group, groups,
        j_order=tuple(sorted(range(nb), key=lambda j: (-(nb - j), j))),
        i_order=tuple(sorted(range(nb), key=lambda i: (-(i + 1), i))),
        items=items, j_grid=min(items, sms), i_grid=min(items, sms), j_smem=j_smem,
        i_smem=i_smem, prep_smem=prep_smem, stages=stages,
        workspace_bytes=4 * bwd_workspace_floats(B, S, nh, hd, ds, L, group), launches=7)


def _check(x, dt, A, B_, C_, chunk, h0):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() not in (1, 2) or B_.dim() != 3 or C_.dim() != 3:
        raise ValueError(
            f"expected x (B, S, nh, hd), dt (B, S, nh), A (nh,), B_/C_ (B, S, ds); got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
            f"{tuple(B_.shape)}, {tuple(C_.shape)}")
    Bb, S, nh, hd = x.shape
    ds = B_.shape[-1]
    if (tuple(dt.shape) != (Bb, S, nh) or tuple(A.shape) not in ((nh,), (Bb, nh))
            or tuple(B_.shape) != (Bb, S, ds) or tuple(C_.shape) != (Bb, S, ds)):
        raise ValueError("dt, A, B_ and C_ do not match x's (B, S, nh)")
    L = min(chunk, S)
    if L <= 0 or S % L:
        raise ValueError(f"S={S} must divide into chunks of {L}")
    if h0 is not None and tuple(h0.shape) != (Bb, nh, hd, ds):
        raise ValueError(f"h0 must be {(Bb, nh, hd, ds)}, got {tuple(h0.shape)}")
    if len({t.device for t in (x, dt, A, B_, C_)}) != 1:
        raise ValueError("x, dt, A, B_ and C_ must be on one device")


def _check_kernel(x, dt, A, B_, C_):
    """What the CUDA kernels take beyond the reference's conditions."""
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


@functools.lru_cache(maxsize=16)
def _sms(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _f32_aligned(t):
    """``t`` as f32 contiguous and 16-byte aligned (the kernels read it 16
    bytes at a time): itself where it already is."""
    t = t.to(torch.float32).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _strides(x, dt, A, B_, C_):
    """The eleven element strides of the kernels' ``Strides``."""
    a_stride = A.stride(0) if A.dim() == 2 else 0
    return (ctypes.c_longlong * 11)(*x.stride()[:3], *B_.stride()[:2], *C_.stride()[:2],
                                    *dt.stride(), a_stride)


def _vec(x, B_, C_) -> int:
    """1 where every row of x, B and C is 16-byte aligned (16-byte loads)."""
    row_strides = x.stride()[:3] + B_.stride()[:2] + C_.stride()[:2]
    return int(all(t.data_ptr() % 16 == 0 for t in (x, B_, C_)) and all(
        s % (16 // x.element_size()) == 0 for s in row_strides))


def _forward(x, dt, A, B_, C_, chunk, h0, with_h_in):
    """(y, h_final, h_in or None): the plain version on the CPU, else the
    kernel (on meta, its outputs' shapes); ``h_in`` the (B, nh, nc, hd, ds)
    f32 state entering each chunk."""
    if x.device.type == "cpu":
        if with_h_in:
            return ssd_chunked_plain(x, dt, A, B_, C_, chunk, h0, return_h_in=True)
        return (*ssd_chunked_plain(x, dt, A, B_, C_, chunk, h0), None)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan runs on cpu, cuda or meta, got {x.device}")
    Bb, S, nh, hd = x.shape
    L = min(chunk, S)  # a chunk too long for shared memory fails the launch
    _check_kernel(x, dt, A, B_, C_)
    with _report.call("ssd_scan", lambda: cost(
            Bb, S, nh, hd, B_.shape[-1], L, x.dtype, a_rows=A.dim() == 2,
            h0=h0 is not None, h_in=with_h_in)):
        return _forward_route(x, dt, A, B_, C_, L, h0, with_h_in)


def _forward_route(x, dt, A, B_, C_, L, h0, with_h_in):
    global launches, meta_launches
    Bb, S, nh, hd = x.shape
    ds = B_.shape[-1]
    y = torch.empty((Bb, S, nh, hd), dtype=torch.float32, device=x.device)
    h_final = torch.empty((Bb, nh, hd, ds), dtype=torch.float32, device=x.device)
    h_in = (torch.empty((Bb, nh, S // L, hd, ds), dtype=torch.float32, device=x.device)
            if with_h_in else None)
    if x.is_meta:
        meta_launches += 1
        return y, h_final, h_in
    A = A.contiguous()
    if h0 is not None:
        h0 = _f32_aligned(h0)
    fn, workspace = _launcher()
    n_ws = workspace(Bb, S, nh, hd, ds, L, DTYPES[x.dtype])
    ws = torch.empty((n_ws,), dtype=torch.float32, device=x.device) if n_ws else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
                 C_.data_ptr(), h0.data_ptr() if h0 is not None else None,
                 y.data_ptr(), h_final.data_ptr(),
                 h_in.data_ptr() if h_in is not None else None,
                 ws.data_ptr() if ws is not None else None, Bb, S, nh, hd, ds, L,
                 _strides(x, dt, A, B_, C_), DTYPES[x.dtype], _vec(x, B_, C_), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    launches += 1
    return y, h_final, h_in


def _backward(x, dt, A, B_, C_, chunk, h_in, dy, dh_final):
    """(dx, ddt, dA, dB, dC, dh0) with dA one (B, nh) row per batch row:
    the plain version on the CPU, else the backward kernel; dx, dB and dC
    in x's dtype."""
    Bb, S, nh, hd = x.shape
    if x.device.type == "cpu":
        dx, ddt, dA, dB, dC, dh0 = ssd_chunked_bwd_plain(
            x, dt, _rows(A, Bb), B_, C_, chunk, h_in, dy, dh_final)
        return dx.to(x.dtype), ddt, dA, dB.to(B_.dtype), dC.to(C_.dtype), dh0
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan runs on cpu, cuda or meta, got {x.device}")
    L = min(chunk, S)
    _check_kernel(x, dt, A, B_, C_)
    with _report.call("ssd_scan_bwd", lambda: cost(
            Bb, S, nh, hd, B_.shape[-1], L, x.dtype, backward=True, a_rows=A.dim() == 2,
            dh_final=dh_final is not None)):
        return _backward_route(x, dt, A, B_, C_, L, h_in, dy, dh_final)


def _backward_route(x, dt, A, B_, C_, L, h_in, dy, dh_final):
    global bwd_launches, meta_bwd_launches
    Bb, S, nh, hd = x.shape
    ds = B_.shape[-1]
    dev = x.device
    dx = torch.empty((Bb, S, nh, hd), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bb, S, nh), dtype=torch.float32, device=dev)
    dA = torch.empty((Bb, nh), dtype=torch.float32, device=dev)
    dB, dC = (torch.empty((Bb, S, ds), dtype=x.dtype, device=dev) for _ in range(2))
    dh0 = torch.empty((Bb, nh, hd, ds), dtype=torch.float32, device=dev)
    if x.is_meta:
        meta_bwd_launches += 1
        return dx, ddt, dA, dB, dC, dh0
    A = A.contiguous()
    h_in, dy = _f32_aligned(h_in), _f32_aligned(dy)
    if dh_final is not None:
        dh_final = _f32_aligned(dh_final)
    fn, workspace = _bwd_launcher()
    order, j_grid, i_grid, group = None, 0, 0, 1
    if tc_route(x.dtype, ds, L):
        plan = bwd_plan(Bb, S, nh, hd, ds, L, sms=_sms(dev))
        order = _order_on(plan.j_order + plan.i_order, dev)
        j_grid, i_grid, group = plan.j_grid, plan.i_grid, plan.group
    n_ws = workspace(Bb, S, nh, hd, ds, L, DTYPES[x.dtype], group)
    if order is not None and 4 * n_ws != plan.workspace_bytes:
        raise RuntimeError(f"csrc/ssd_scan_bwd.cu's workspace is {4 * n_ws} bytes, "
                           f"bwd_plan's {plan.workspace_bytes}")
    ws = torch.empty((n_ws,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                 h_in.data_ptr(), dy.data_ptr(),
                 dh_final.data_ptr() if dh_final is not None else None,
                 dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                 dh0.data_ptr(), ws.data_ptr(), Bb, S, nh, hd, ds, L,
                 _strides(x, dt, A, B_, C_), DTYPES[x.dtype], _vec(x, B_, C_),
                 order.data_ptr() if order is not None else None, j_grid, i_grid, group,
                 stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {err}")
    bwd_launches += 1
    return dx, ddt, dA, dB, dC, dh0


def ssd_scan_with_h_in(x, dt, A, B_, C_, chunk: int = 256, h0=None):
    """(y, h_final, h_in): the forward with the state entering each chunk,
    outside autograd; the kernel on a CUDA tensor (one counted launch), the
    plain version on a CPU tensor."""
    _check(x, dt, A, B_, C_, chunk, h0)
    return _forward(x, dt, A, B_, C_, chunk, h0, with_h_in=True)


def ssd_scan_bwd(x, dt, A, B_, C_, chunk, h_in, dy, dh_final=None):
    """(dx, ddt, dA, dB, dC, dh0) from the forward's ``h_in`` and the
    output gradients, outside autograd, dA one (B, nh) row per batch row;
    the backward kernels on a CUDA tensor (one counted launch: seven kernels
    on the tensor-core route, four on the FMA route), the plain version on a
    CPU tensor."""
    _check(x, dt, A, B_, C_, chunk, None)
    Bb, S, nh, hd = x.shape
    state = (Bb, nh, hd, B_.shape[-1])
    entering = (Bb, nh, S // min(chunk, S), hd, B_.shape[-1])
    if (tuple(h_in.shape) != entering or tuple(dy.shape) != tuple(x.shape)
            or (dh_final is not None and tuple(dh_final.shape) != state)):
        raise ValueError(f"h_in, dy and dh_final must be {entering}, {tuple(x.shape)} "
                         f"and {state}")
    return _backward(x, dt, A, B_, C_, chunk, h_in, dy, dh_final)


def _fold_rows(A, d, n, rows):
    """A under a ``vmap`` of n over a batch of ``rows`` rows folded into n *
    rows: unbatched, as it is (its batch stride stays 0 where it is (nh,));
    batched, one row per folded batch row."""
    if d is None:
        return A if A.dim() == 1 else A.repeat(n, 1)
    A = A.movedim(d, 0)
    if A.dim() == 2:  # (n, nh): each client's A for each of its rows
        A = A[:, None].expand(n, rows, A.shape[-1])
    return A.reshape(n * rows, A.shape[-1])


class SSDScan(torch.autograd.Function):
    """K6's forward with the entering states saved, differentiable through
    ``SSDScanBwd``; returns (y, h_final, h_in), h_in not differentiable."""

    @staticmethod
    def forward(x, dt, A, B_, C_, h0, chunk):
        return _forward(x, dt, A, B_, C_, chunk, h0, with_h_in=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, A, B_, C_, h0, chunk = inputs
        ctx.save_for_backward(x, dt, A, B_, C_, output[2])
        ctx.chunk, ctx.has_h0 = chunk, h0 is not None
        ctx.mark_non_differentiable(output[2])

    @staticmethod
    def backward(ctx, dy, dh_final, _dh_in):
        x, dt, A, B_, C_, h_in = ctx.saved_tensors
        dx, ddt, dA, dB, dC, dh0 = SSDScanBwd.apply(x, dt, A, B_, C_, h_in, dy, dh_final,
                                                    ctx.chunk)
        if A.dim() == 1:  # the rows' parts of A's gradient, summed in row order
            dA = dA.sum(0)
        return dx, ddt, dA, dB, dC, dh0 if ctx.has_h0 else None, None

    @staticmethod
    def vmap(info, in_dims, x, dt, A, B_, C_, h0, chunk):
        n = info.batch_size
        x, dt, B_, C_ = (_fold(t, d, n) for t, d in zip((x, dt, B_, C_),
                                                        (in_dims[0], in_dims[1], *in_dims[3:5])))
        A = _fold_rows(A, in_dims[2], n, x.shape[0] // n)
        h0 = None if h0 is None else _fold(h0, in_dims[5], n)
        out = SSDScan.apply(x, dt, A, B_, C_, h0, chunk)
        return tuple(_unfold(t, n) for t in out), (0, 0, 0)


class SSDScanBwd(torch.autograd.Function):
    """K6's backward: (dx, ddt, dA, dB, dC, dh0), dA one (B, nh) row per
    batch row, from the inputs, the forward's ``h_in`` and the output
    gradients. Not differentiable itself."""

    @staticmethod
    def forward(x, dt, A, B_, C_, h_in, dy, dh_final, chunk):
        return _backward(x, dt, A, B_, C_, chunk, h_in, dy, dh_final)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("K6's backward has no backward of its own")

    @staticmethod
    def vmap(info, in_dims, x, dt, A, B_, C_, h_in, dy, dh_final, chunk):
        n = info.batch_size
        folded = [None if t is None else _fold(t, d, n) for t, d in zip(
            (x, dt, B_, C_, h_in, dy, dh_final),
            (*in_dims[:2], *in_dims[3:8]))]
        x, dt, B_, C_, h_in, dy, dh_final = folded
        A = _fold_rows(A, in_dims[2], n, x.shape[0] // n)
        grads = SSDScanBwd.apply(x, dt, A, B_, C_, h_in, dy, dh_final, chunk)
        return tuple(_unfold(g, n) for g in grads), (0,) * 6


def ssd_scan(x, dt, A, B_, C_, chunk: int = 256,
             h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, nh, hd) f32, h_final (B, nh, hd, ds) f32) of the chunked
    scan, from ``h0`` or a zero state; differentiable in every input."""
    _check(x, dt, A, B_, C_, chunk, h0)
    if _tracked(x, dt, A, B_, C_, *(() if h0 is None else (h0,))):
        return SSDScan.apply(x, dt, A, B_, C_, h0, int(chunk))[:2]
    return _forward(x, dt, A, B_, C_, chunk, h0, with_h_in=False)[:2]
