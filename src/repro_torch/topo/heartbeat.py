"""Heartbeat-driven liveness, on torch tensors (``repro.topo.heartbeat``).

A client whose last contact lies more than ``timeout`` simulated seconds
before the observation time has gone dark. Only ``expired`` is ported so
far: the async engine's deadline re-dispatch reads it ("no completion for
longer than the timeout" is the same signal). The heartbeat state and its
tier exclusion arrive with ROADMAP queue 1, slice D (topology).
"""
from __future__ import annotations

import torch


def expired(last_beat: torch.Tensor, now: torch.Tensor,
            timeout: float) -> torch.Tensor:
    """Dark-client mask: no contact for more than ``timeout`` seconds at
    observation time ``now`` (elementwise; shapes broadcast)."""
    return (now - last_beat) > timeout
