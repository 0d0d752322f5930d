"""Heartbeat-driven liveness, on torch tensors (``repro.topo.heartbeat``).

Real hierarchical fleets lose clients mid-round, and the tier coordinator
that stops hearing heartbeats drops the client from the round rather than
stalling the reduction. In the simulator a heartbeat is any observable
contact: dispatch (the client pulled a model) and completion (its update
arrived). A client whose update lands more than ``timeout`` simulated
seconds after its last contact has been dark the whole time: the async
engine excludes the update from the tier reduction (weight 0, like a
dropped slot) and counts it in ``hb_expired``. ``expired`` is also the
deadline re-dispatch's predicate ("no completion for longer than the
timeout" is the same signal).

The state is one flat ``(n,)`` last-beat vector on the fleet's device;
every function is a tensor op with no host sync.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.sim import events as ev_mod


def init_heartbeat(n: int, device) -> Dict[str, torch.Tensor]:
    """Fresh heartbeat state: everyone checked in at t=0."""
    return {"last_beat": torch.zeros((n,), dtype=torch.float32, device=device)}


def beat(hb: Dict, mask: torch.Tensor, t: torch.Tensor) -> Dict:
    """Clients under ``mask`` (n,) check in at time ``t`` (scalar)."""
    return {"last_beat": torch.where(mask, t, hb["last_beat"])}


def beat_at(hb: Dict, idx: torch.Tensor, mask: torch.Tensor,
            t: torch.Tensor, layout=None) -> Dict:
    """Popped clients ``idx`` (B,) check in at their completion times ``t``
    (B,) where ``mask`` holds: the reference's ``.at[scatter_idx].set(t,
    mode="drop")`` as a masked scatter (``sim.events.scatter_set``; on the
    owner only under a sharded ``core.fleet`` layout)."""
    if layout is not None:
        return {"last_beat": layout.scatter_set(hb["last_beat"], idx, mask, t)}
    return {"last_beat": ev_mod.scatter_set(hb["last_beat"], idx, mask, t)}


def expired(last_beat: torch.Tensor, now: torch.Tensor,
            timeout: float) -> torch.Tensor:
    """Dark-client mask: no contact for more than ``timeout`` seconds at
    observation time ``now`` (elementwise; shapes broadcast)."""
    return (now - last_beat) > timeout
