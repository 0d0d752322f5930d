"""Oracles for the port's kernels (ground truth for tests), as
``repro.kernels.ref`` is for the Pallas kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels.aoi_topk import topk_plain
from repro_torch.kernels.event_topk import next_k_plain as event_next_k_ref  # noqa: F401
from repro_torch.kernels.fedavg_reduce import (  # noqa: F401
    fedavg_reduce_plain as fedavg_reduce_ref,
)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_plain as flash_attention_ref,
)
from repro_torch.kernels.flash_decode import (  # noqa: F401
    flash_decode_plain as flash_decode_ref,
)
from repro_torch.models.ssm import ssd_reference


def topk_ref(ages, k):
    """Global top-k (values, indices) with highest-age-first order."""
    return topk_plain(ages.to(torch.float32), k)


def ssd_scan_ref(x, dt, A, B_, C_):
    """Naive per-step SSM recurrence (oracle). Shapes as ``ops.ssd_scan``."""
    y, _ = ssd_reference(x, dt, A, B_, C_)
    return y.to(x.dtype)
