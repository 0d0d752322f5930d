"""Age-of-Information dynamics (Eq. 4) on torch tensors.

Each client's age increases by one when not selected and resets to zero when
selected: A^{t+1} = (A^t + 1)(1 - S^t). The Markov *chain state* is the age
clipped to the maximum permissible age m (state m self-loops).
"""
from __future__ import annotations

import torch

from repro_torch.core.fleet import whole


def age_update(ages: torch.Tensor, selected: torch.Tensor) -> torch.Tensor:
    """Eq. (4): elementwise age evolution. ``selected`` is bool/0-1."""
    return (ages + 1) * (1 - selected.to(ages.dtype))


def chain_state(ages: torch.Tensor, m: int) -> torch.Tensor:
    """Markov chain state = min(age, m)."""
    return torch.clamp(ages, max=m)


def peak_age_accumulate(ages, selected, sum_x, sum_x2, count, layout=None):
    """Streaming accumulation of peak-age (= X) first/second moments.

    On each selection, the client's pre-reset age + 1 is one sample of X
    (age counts rounds since last selection; the gap between selections is
    age+1 when selection happens on the current round). Under a sharded
    ``layout`` (``core.fleet``) the block sums are summed over ranks (exact:
    integer-valued).
    """
    psum = whole(layout, ages.shape[0]).psum
    dt = torch.float64 if ages.dtype == torch.int64 else torch.float32
    x = (ages + 1).to(dt)
    sel = selected.to(dt)
    sum_x = sum_x + psum(torch.sum(x * sel))
    sum_x2 = sum_x2 + psum(torch.sum(x * x * sel))
    count = count + psum(torch.sum(sel))
    return sum_x, sum_x2, count
