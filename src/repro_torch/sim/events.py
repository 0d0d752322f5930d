"""The event engine: pending-completion times with next-k extraction.

State is a flat struct-of-arrays over the fleet — one f32 completion time
per client (``+inf`` when idle) plus availability/dropout bookkeeping — so
every engine operation is a vector op on the fleet's device. The only
"priority queue" operation the async loop needs is *pop the k earliest
events*: the ``event_topk`` CUDA kernel (K2) for fleets of at least
``KERNEL_THRESHOLD`` clients on the GPU, its plain version (a stable sort)
otherwise. Both break ties toward the lower client index.

The reference's out-of-range ``.at[idx].set(..., mode="drop")`` has no
torch counterpart; ``scatter_set`` writes through a buffer with one extra
dump slot, so masked-out slots (the idle clients a pop returns past the
pending ones) never write back — with no host sync.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import event_topk, ops

# fleets at or above this size route through the kernel on the GPU
KERNEL_THRESHOLD = 16384


def init_event_state(n: int, device) -> Dict[str, torch.Tensor]:
    """Fresh engine state: everyone idle, available at t=0, never done."""
    return {
        "t_done": torch.full((n,), float("inf"), dtype=torch.float32, device=device),
        "disp_ver": torch.full((n,), -1, dtype=torch.int32, device=device),
        "next_avail": torch.zeros((n,), dtype=torch.float32, device=device),
        "dropped": torch.zeros((n,), dtype=torch.bool, device=device),
        "last_done": torch.full((n,), -1.0, dtype=torch.float32, device=device),
    }


def schedule_completions(
    ev: Dict[str, torch.Tensor],
    send: torch.Tensor,  # (n,) bool — clients dispatched this step
    clock: torch.Tensor,  # () f32 current simulated time
    latency: torch.Tensor,  # (n,) f32 per-client wall time if dispatched
    version: torch.Tensor,  # () i32 current model version
    dropped: torch.Tensor,  # (n,) bool per-dispatch dropout draw
) -> Dict[str, torch.Tensor]:
    """Mark ``send`` clients in flight: completion at clock + latency."""
    return {
        **ev,
        "t_done": torch.where(send, clock + latency, ev["t_done"]),
        "disp_ver": torch.where(send, version, ev["disp_ver"]),
        "dropped": torch.where(send, dropped, ev["dropped"]),
    }


def next_k_events(
    times: torch.Tensor, k: int, *, use_kernel: bool | None = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(times (k,), idx (k,) int64) of the k earliest pending events.

    Slots beyond the number of pending events carry ``+inf`` times —
    callers mask by ``torch.isfinite``. Ties break toward lower index.
    ``use_kernel=None`` takes the kernel for fleets of at least
    ``KERNEL_THRESHOLD`` on the GPU, for any k, as the reference does on
    an accelerator.
    """
    n = times.shape[0]
    if use_kernel is None:
        use_kernel = n >= KERNEL_THRESHOLD and times.is_cuda
    if use_kernel:
        return ops.event_next_k(times, k)
    return event_topk.next_k_plain(times, k)


def pop_events(
    ev: Dict[str, torch.Tensor], k: int, *, use_kernel: bool | None = None
):
    """Extract the next k completions and return those clients to idle.

    Returns (event times (k,), client idx (k,), valid mask (k,), state').
    Invalid slots (fewer than k events pending) gather client 0 under a
    zero mask and never scatter back.
    """
    t, idx = next_k_events(ev["t_done"], k, use_kernel=use_kernel)
    return apply_pop(ev, t, idx)


def apply_pop(ev: Dict[str, torch.Tensor], t: torch.Tensor, idx: torch.Tensor,
              layout=None):
    """Bookkeeping shared by every pop path: mask invalid slots, return
    popped clients to idle. ``(t, idx)`` is any next-k extraction over
    ``ev["t_done"]``; under a sharded ``layout`` (``core.fleet``) the global
    ``idx`` writes only on its owner."""
    valid = torch.isfinite(t)
    idx_safe = torch.where(valid, idx, 0)
    if layout is None:
        t_done = scatter_set(ev["t_done"], idx, valid, float("inf"))
    else:
        t_done = layout.scatter_set(ev["t_done"], idx, valid, float("inf"))
    return t, idx_safe, valid, {**ev, "t_done": t_done}


def scatter_idx(idx: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter targets over an (n + 1,) buffer: masked-out slots go to the
    dump slot ``n`` and never write back."""
    return torch.where(mask, idx, n)


def scatter_set(x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                values) -> torch.Tensor:
    """``x`` with ``x[idx[j]] = values[j]`` for every ``j`` where
    ``mask[j]``; the reference's ``.at[scatter_idx].set(mode="drop")``.
    Unmasked indices must be distinct (they are popped clients)."""
    n = x.shape[0]
    buf = torch.cat([x, x.new_zeros((1,))])
    if isinstance(values, torch.Tensor):
        vals = values.to(x.dtype).expand(idx.shape)
    else:  # a fill, not a host-to-device copy of a scalar
        vals = torch.full(idx.shape, values, dtype=x.dtype, device=x.device)
    buf = buf.index_put((scatter_idx(idx, mask, n),), vals)
    return buf[:n]
