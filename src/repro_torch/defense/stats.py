"""Masked order statistics over the cohort axis, with no host read.

The defense scores every slot against its cohort's median (and the median
absolute deviation around it) of the valid slots only. As in the
reference, invalid slots sort to ``+inf`` at the top and the median is the
mean of the sorted values at ranks ``lo = max((c - 1) // 2, 0)`` and
``hi = max(c // 2, 0)`` of the ``c`` valid ones. ``c``, ``lo`` and ``hi``
stay 0-d tensors on the device, and a rank is picked with
``index_select``: indexing with a 0-d tensor would read it on the host.
"""
from __future__ import annotations

import torch


def median_ranks(valid: torch.Tensor):
    """``(c, lo, hi)``: the valid count and the two middle ranks (int32 and
    int64 0-d tensors on ``valid``'s device)."""
    c = valid.to(torch.int32).sum()
    lo = torch.clamp((c - 1) // 2, min=0).to(torch.int64)
    hi = torch.clamp(c // 2, min=0).to(torch.int64)
    return c, lo, hi


def pick(sorted_: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``sorted_[i]`` along dim 0 for a 0-d device index ``i``."""
    return torch.index_select(sorted_, 0, i.view(1)).squeeze(0)


def masked_median(x: torch.Tensor, valid: torch.Tensor, c, lo, hi) -> torch.Tensor:
    """Median of ``x[valid]`` along dim 0 (0.0 when no slot is valid)."""
    mask = valid.view((-1,) + (1,) * (x.dim() - 1))
    xs = torch.sort(torch.where(mask, x, torch.inf), dim=0).values
    return torch.where(c > 0, (pick(xs, lo) + pick(xs, hi)) / 2.0, 0.0)


def median_and_mad(x: torch.Tensor, valid: torch.Tensor, c, lo, hi):
    """The masked median of a (B,) vector and the masked median of its
    absolute deviations from it."""
    med = masked_median(x, valid, c, lo, hi)
    return med, masked_median(torch.abs(x - med), valid, c, lo, hi)
