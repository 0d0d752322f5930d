"""The radix-select top-k shared by K2 (``event_topk``) and K3 (``aoi_topk``).

The CUDA kernel is ``src/repro_torch/csrc/radix_topk.cuh``: the k smallest
(K2) or largest (K3) of n f32 values with their indices, ties to the lower
index, for any 1 <= k <= n < 2^31 in one launch. Each value becomes its
32-bit order-preserving image (complemented for K3; -0.0 made +0.0 and every
NaN one NaN, so the order is a stable sort's). Four 8-bit MSD passes find the
image T of the k-th key; the gather takes every element below T and the
first ``kr`` equal to it, in index order; a sorted result then sorts the k
selected: a bitonic sort of (image, index) keys for k <= 1024, else four
stable LSD passes.

This module holds what both wrappers share: ``plan`` (the launch shape from
(n, k, sorted) and the SM count alone), ``launch`` (one kernel call on a
CUDA vector, no host sync), the input ``check`` and ``emulate``, the
kernel's schedule run on CPU tensors for the tests.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

THREADS = 1024
RADIX = 256  # 8-bit digits
DIGITS = 4  # of a 32-bit image
WINDOW = 32768  # values a CTA holds in shared memory (csrc/radix_topk.cuh)
ONE_CTA_N = WINDOW  # n at or below this: one CTA, no grid barrier
MIN_PER_CTA = 8192  # grid route: values per CTA at least
SORT_ONE_CTA_K = 4096  # grid route: a sorted k up to this is sorted by CTA 0 alone
STATE_WORDS = 4
CAND = 2048  # candidate images a CTA lists once they fit
CNT_STRIDE = THREADS // 32 + 1  # per-digit row of warp counts, padded
SMS = 132  # the H100 SXM's SM count; ``launch`` passes the card's own


class Plan(NamedTuple):
    route: str  # "one_cta" (n <= ONE_CTA_N) or "grid" (cooperative)
    ctas: int  # CTAs of 1024 threads
    chunk: int  # values per CTA
    window: int  # values in shared memory at once
    windows: int  # windows per chunk (reloaded every pass when > 1)
    sort_ctas: int  # CTAs that run the sort passes (sorted only)
    seg: int  # selected elements per sorting CTA
    smem_bytes: int  # dynamic shared memory per CTA
    scratch_words: int  # 32-bit words of device scratch
    barriers: int  # grid barriers in the launch
    launches: int  # kernel launches per call: always 1


@functools.lru_cache(maxsize=1024)
def plan(n: int, k: int, sorted: bool = True, sms: int = SMS, ctas: int | None = None) -> Plan:
    """The launch of one call on (n, k, sorted) for a card of ``sms`` SMs.
    ``ctas`` overrides the grid (tests run the grid route at small n)."""
    if ctas is None:
        ctas = 1 if n <= ONE_CTA_N else min(sms, -(-n // MIN_PER_CTA))
    chunk = -(-n // ctas)
    window = min(chunk, WINDOW)
    sort_ctas = ctas if sorted and ctas > 1 and k > SORT_ONE_CTA_K else 1
    smem = 4 * (((window + window // 32 + 4) & ~3) + CAND
                + (2 * (RADIX * CNT_STRIDE + THREADS) if sorted else 0))
    # sorted: two (image, index) arrays of k, unless one CTA keeps k <= THREADS
    sort_words = 4 * k if sorted and (ctas > 1 or k > THREADS) else 0
    scratch = (ctas * RADIX + STATE_WORDS if ctas > 1 else 0) + sort_words
    barriers = 0
    if ctas > 1:  # a select pass each, the gather's prefix; sorted: the gather's
        # visibility, and on a grid sort two a pass (counts, then visibility)
        barriers = DIGITS + 1 + (1 + (2 * DIGITS - 1 if sort_ctas > 1 else 0) if sorted else 0)
    return Plan("one_cta" if ctas == 1 else "grid", ctas, chunk, window, -(-chunk // WINDOW),
                sort_ctas, -(-k // sort_ctas), smem, scratch, barriers, 1)


def check(values: torch.Tensor, k: int) -> None:
    """What both wrappers take: a 1-D f32 vector, 1 <= k <= n < 2^31."""
    if values.dim() != 1 or values.dtype != torch.float32:
        raise ValueError(
            f"values must be a 1-D float32 tensor, got {tuple(values.shape)} "
            f"{values.dtype}"
        )
    n = values.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    if n >= 2**31:
        raise ValueError(f"n={n} exceeds the kernel's 31-bit index range")


@functools.cache
def launcher(name: str):
    """The built library ``name``'s ``<name>_launch`` (K2's ``event_topk``
    or K3's ``aoi_topk``), typed (built at first use)."""
    from repro_torch.kernels.build import library

    lib = library(name)
    if getattr(lib, f"{name}_window")() != WINDOW:
        raise RuntimeError(f"csrc/{name}.cu WINDOW differs from radix_topk.WINDOW")
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# grid barrier words {arrived, generation} per (device, stream): zeroed once;
# a launch leaves "arrived" at 0 and only advances the generation
_barriers: dict = {}


def _barrier(device: torch.device, stream) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    bar = _barriers.get(key)
    if bar is None:
        bar = _barriers[key] = torch.zeros((2,), dtype=torch.int32, device=device)
    return bar


def launch(name: str, values: torch.Tensor, k: int,
           sorted: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of kernel ``name`` on a CUDA vector; (values (k,) f32,
    idx (k,) i64). Raises on what the kernel does not take."""
    if values.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {values.device}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    fn = launcher(name)
    dev = values.device
    n = values.shape[0]
    p = plan(n, k, sorted, _sms(dev.index))
    out = torch.empty((k + (k + 1) // 2,), dtype=torch.int64, device=dev)  # one allocation
    out_i, out_v = out[:k], out[k:].view(torch.float32)[:k]
    scratch = (torch.empty((p.scratch_words,), dtype=torch.int32, device=dev)
               if p.scratch_words else None)
    stream = torch.cuda.current_stream(dev)
    args = (values.data_ptr(), n, k, int(sorted), p.ctas, p.sort_ctas,
            scratch.data_ptr() if scratch is not None else None,
            _barrier(dev, stream).data_ptr() if p.ctas > 1 else None,
            out_v.data_ptr(), out_i.data_ptr(), stream.cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out_v, out_i


# --- the kernel's schedule on CPU tensors (tests only) -------------------------


def image(values: torch.Tensor, desc: bool) -> torch.Tensor:
    """Each f32's order-preserving 32-bit image as int64 (csrc ``image``)."""
    bits = values.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = bits & 0x7FFFFFFF
    bits = torch.where(mag == 0, 0, torch.where(mag > 0x7F800000, 0x7FC00000, bits))
    img = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    return img ^ 0xFFFFFFFF if desc else img


def _rank_in_group(group: torch.Tensor) -> torch.Tensor:
    """For each element, how many earlier elements share its group id."""
    order = torch.sort(group, stable=True).indices
    _, counts = torch.unique_consecutive(group[order], return_counts=True)
    starts = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    rank = torch.empty_like(group)
    rank[order] = torch.arange(group.numel()) - starts
    return rank


def _cta_rows(cta: torch.Tensor, digit: torch.Tensor, ctas: int) -> torch.Tensor:
    """(ctas, RADIX) digit histograms, one row per CTA."""
    rows = torch.zeros((ctas, RADIX), dtype=torch.int64)
    rows.index_put_((cta, digit), torch.ones_like(cta), accumulate=True)
    return rows


def emulate(values: torch.Tensor, k: int, sorted: bool = True, desc: bool = False,
            p: Plan | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's schedule on a CPU vector, step for step: per-CTA digit
    rows merged in CTA order and the bucket scan of each select pass; the
    gather's CTA-order prefix, window by window, each thread's run placed by
    the scan of the runs' 16:16 packed counts; for k <= THREADS on one CTA a
    sort of the distinct (image, index) keys (the bitonic network's result),
    else the LSD passes' per-CTA rows, their CTA-order offsets and the stable
    place inside each CTA. ``p`` is
    ``plan(n, k, sorted)`` unless given (another grid, for the tests)."""
    n = values.shape[0]
    p = p or plan(n, k, sorted)
    img = image(values, desc)
    pos_all = torch.arange(n)
    cta = pos_all // p.chunk
    # 2. select
    prefix, kr = 0, k
    for q in range(DIGITS):
        shift = 24 - 8 * q
        hi = 0 if q == 0 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
        live = (img & hi) == prefix
        totals = _cta_rows(cta[live], (img[live] >> shift) & (RADIX - 1), p.ctas).sum(0)
        before = torch.cumsum(totals, 0) - totals
        bucket = int(torch.nonzero((totals > 0) & (before < kr) & (kr <= before + totals))[0])
        prefix |= bucket << shift
        kr -= int(before[bucket])
    T = prefix
    # 3. gather: counts packed 16:16 per thread run of a window
    packed = torch.where(img < T, 0x10000, torch.where(img == T, 1, 0))
    local = pos_all - cta * p.chunk
    win = local // p.window
    cta_len = torch.clamp(n - torch.arange(p.ctas) * p.chunk, 0, p.chunk)
    m = torch.clamp(cta_len[cta] - win * p.window, 0, p.window)
    run_len = (m + THREADS - 1) // THREADS
    thread = (local - win * p.window) // run_len
    less, equal = img < T, img == T
    cl = torch.zeros(p.ctas, dtype=torch.int64).index_add_(0, cta, less.long())
    ce = torch.zeros(p.ctas, dtype=torch.int64).index_add_(0, cta, equal.long())
    cta_l, cta_e = torch.cumsum(cl, 0) - cl, torch.cumsum(ce, 0) - ce  # CTA order
    run_id = (cta * p.windows + win) * THREADS + thread
    runs = torch.zeros(p.ctas * p.windows * THREADS, dtype=torch.int64).index_add_(
        0, run_id, packed).view(p.ctas, p.windows, THREADS)
    run_before = (torch.cumsum(runs, 2) - runs).view(-1)[run_id]  # the block scan
    win_tot = runs.sum(2)
    win_l = torch.cumsum(win_tot >> 16, 1) - (win_tot >> 16)
    win_e = torch.cumsum(win_tot & 0xFFFF, 1) - (win_tot & 0xFFFF)
    start = cta * p.chunk + win * p.window + thread * run_len  # the run's first
    seen_l = torch.cumsum(less.long(), 0) - less.long()
    seen_e = torch.cumsum(equal.long(), 0) - equal.long()
    ml = cta_l[cta] + win_l[cta, win] + (run_before >> 16) + seen_l - seen_l[start]
    me = cta_e[cta] + win_e[cta, win] + (run_before & 0xFFFF) + seen_e - seen_e[start]
    take = less | (equal & (me < kr))
    dest = torch.where(less, ml + torch.clamp(me, max=kr), ml + me)[take]
    keys = torch.empty(k, dtype=torch.int64)
    idx = torch.empty(k, dtype=torch.int64)
    keys[dest] = img[take]
    idx[dest] = pos_all[take]
    if sorted and k <= THREADS:  # 4. bitonic on one CTA, distinct keys
        order = torch.sort(keys, stable=True).indices  # idx ascending already
        keys, idx = keys[order], idx[order]
    elif sorted:  # 4. four stable LSD passes over the k selected
        at = torch.arange(k)
        scta = at // p.seg
        for q in range(DIGITS):
            digit = (keys >> (8 * q)) & (RADIX - 1)
            rows = _cta_rows(scta, digit, p.sort_ctas)
            col = torch.cumsum(rows, 0) - rows  # CTAs before, same digit
            base = torch.cumsum(rows.sum(0), 0) - rows.sum(0)
            dest = (base[None, :] + col)[scta, digit] + _rank_in_group(scta * RADIX + digit)
            new_keys, new_idx = torch.empty_like(keys), torch.empty_like(idx)
            new_keys[dest], new_idx[dest] = keys, idx
            keys, idx = new_keys, new_idx
    return values[idx], idx
