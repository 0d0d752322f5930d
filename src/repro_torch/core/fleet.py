"""The fleet-state seam: every site where a step reads or writes a per-client
``(n,)`` leaf goes through a ``FleetLayout``.

The reference writes its step once on global arrays and lets GSPMD lay the
``(n,)`` leaves over a mesh (its hooks ``pop``, ``cohort_layout``,
``constrain_state`` and ``cohort_pad``). PyTorch has no counterpart, so the
port names each crossing. A layout has two forms:

  * ``WholeFleet(n)`` — the single-device engines: ``x[idx]``,
    ``sim.events.scatter_set``, ``index_add``, ``pop_events`` and the
    identity for the cross-rank steps, so their bits are the calm port's;
  * ``BlockFleet(n, mesh)`` — the sharded engines: this rank holds the
    block ``[rank * n / D, (rank + 1) * n / D)`` of every fleet leaf and

      - ``block`` keeps this rank's block of a full-width ``(n, ...)``
        tensor (every fleet-wide draw is made at its full shape on every
        rank from the same stream, so the sharded run draws what the
        single run draws);
      - ``gather`` reads rows at global indices: each rank reads the rows it
        owns (clamped elsewhere), the ``(D, B, ...)`` candidates are
        all-gathered, and each slot selects its owner's row — never a sum of
        owner-masked rows, so -0.0, NaN and inf pass through as the single
        engine reads them;
      - ``scatter_set``/``index_add`` write only on the owner (JAX's drop of
        an out-of-range index kept: other ranks' targets are dropped);
      - ``psum`` all-gathers a partial value and sums it in rank order
        (``core.distributed.psum``; exact for the integer-valued float sums
        the step makes over the fleet), ``pmin`` takes the exact minimum;
      - ``pop`` is ``core.distributed.sharded_next_k_events`` and
        ``topk_idx`` is ``core.distributed.sharded_top_k``, the oldest-age
        merge.

Cohort-sized ``(B,)`` values are replicated: every rank computes them from
the same gathered inputs.
"""
from __future__ import annotations

from typing import Optional

import torch


class WholeFleet:
    """The one-device layout: every op is the single engine's own."""

    sharded = False

    def __init__(self, n: int):
        self.n = self.local_n = int(n)
        self.lo = 0

    def block(self, x):
        return x

    def gather(self, x, idx):
        return x[idx]

    def scatter_set(self, x, idx, mask, values):
        from repro_torch.sim.events import scatter_set

        return scatter_set(x, idx, mask, values)

    def index_add(self, x, idx, values):
        return x.index_add(0, idx, values)

    def psum(self, x):
        return x

    def pmin(self, x):
        return x

    def mask(self, idx):
        from repro_torch.core import selection

        return selection._mask(self.n, idx)

    def pop(self, ev, k: int, use_kernel: Optional[bool] = None):
        from repro_torch.sim.events import pop_events

        return pop_events(ev, k, use_kernel=use_kernel)

    def topk_idx(self, score, k: int):
        from repro_torch.core.selection import _topk_idx

        return _topk_idx(score, k)


class BlockFleet(WholeFleet):
    """This rank's block of an ``n``-client fleet over ``mesh``
    (``core.distributed.FleetMesh``); ``n`` must divide evenly."""

    sharded = True

    def __init__(self, n: int, mesh):
        if n % mesh.size:
            raise ValueError(
                f"mesh has {mesh.size} devices but n_clients={n} is not "
                "divisible by it"
            )
        self.n = int(n)
        self.mesh = mesh
        self.local_n = self.n // mesh.size
        self.lo = mesh.rank * self.local_n
        self._next_k = {}

    def _local(self, idx):
        """(local index clamped into the block, owned mask) of global
        indices ``idx``."""
        loc = idx - self.lo
        own = (loc >= 0) & (loc < self.local_n)
        return torch.clamp(loc, 0, self.local_n - 1), own

    def block(self, x):
        return x[self.lo:self.lo + self.local_n]

    def own_block(self, x):
        """This rank's block in storage of its own (a copy when the block
        is part of the whole, so the whole can be freed)."""
        return x if self.local_n == self.n else self.block(x).clone()

    def gather(self, x, idx):
        from repro_torch.core.distributed import all_gather

        loc, _ = self._local(idx)
        cand = all_gather(x[loc], self.mesh)  # (D, B, ...)
        owner = torch.clamp(idx, 0, self.n - 1) // self.local_n
        return cand[owner.long(), torch.arange(idx.shape[0], device=idx.device)]

    def scatter_set(self, x, idx, mask, values):
        from repro_torch.sim.events import scatter_set

        loc, own = self._local(idx)
        return scatter_set(x, loc, mask & own, values)

    def index_add(self, x, idx, values):
        loc, own = self._local(idx)
        own = own.view((-1,) + (1,) * (values.dim() - 1))
        zero = -0.0 if values.is_floating_point() else 0
        return x.index_add(0, loc, torch.where(own, values, zero))

    def psum(self, x):
        from repro_torch.core.distributed import psum

        return psum(x, self.mesh)

    def pmin(self, x):
        from repro_torch.core.distributed import all_gather

        return torch.min(all_gather(x, self.mesh), dim=0).values

    def mask(self, idx):
        loc, own = self._local(idx)
        sel = torch.zeros((self.local_n + 1,), dtype=torch.bool, device=idx.device)
        return sel.index_fill(0, torch.where(own, loc, self.local_n), True)[:-1]

    def pop(self, ev, k: int, use_kernel: Optional[bool] = None):
        from repro_torch.core.distributed import sharded_next_k_events
        from repro_torch.sim.events import apply_pop

        fn = self._next_k.get((k, use_kernel))
        if fn is None:
            fn = self._next_k[(k, use_kernel)] = sharded_next_k_events(
                self.mesh, self.n, k, use_kernel=use_kernel)
        t, idx = fn(ev["t_done"])
        return apply_pop(ev, t, idx, layout=self)

    def topk_idx(self, score, k: int):
        from repro_torch.core.distributed import sharded_top_k

        return sharded_top_k(score, k, self.mesh)

    def unshard(self, x):
        """The whole fleet's ``x`` (every rank gets it)."""
        from repro_torch.core.distributed import all_gather

        parts = all_gather(x, self.mesh)
        return parts.reshape((self.n,) + tuple(x.shape[1:]))


def whole(layout, n: int):
    """``layout``, or the one-device layout of an ``n``-client fleet."""
    return layout if layout is not None else WholeFleet(n)
