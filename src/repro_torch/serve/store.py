"""Multi-version model store over the async engine's version ring.

Port of ``repro.serve.store``. The async engine retains the last
``max_versions`` global models in a ring (``state["hist"]``, slot ``v % H``
holds version ``v``) so stale clients can train from their dispatch-time
model. That ring is a multi-version model store: ``VersionStore`` wraps
one ring snapshot behind a read API with explicit staleness accounting, so
the serving tier can pin replicas to retained versions while training
keeps advancing the ring underneath.

``read`` applies the engine's clipping (a requested version older than
the ring serves the oldest retained model) and reports the version served
and its staleness relative to the ring head. The snapshot holds the
engine's tensors by reference, and a read's params are views of the ring
slot: building a store or reading from it copies no parameter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple

import torch

from repro_torch.core.tree import tree_map


class VersionRead(NamedTuple):
    """One resolved read: the served parameters (views of the ring slot),
    the version they carry, its age relative to the newest version in the
    ring, and whether the *requested* version had already fallen off the
    ring (the read was upgraded to the oldest retained model)."""

    params: Any
    read_ver: torch.Tensor  # () int32, version actually served
    staleness: torch.Tensor  # () int32, latest - read_ver
    ring_miss: torch.Tensor  # () bool, requested version not retained


@dataclasses.dataclass(frozen=True)
class VersionStore:
    """Read API over a ring of the last ``max_versions`` global models.

    ``hist`` is any tree whose leaves carry a leading ``(H,)`` ring axis
    with version ``v`` in slot ``v % H``; ``version`` is the newest version
    present, a 0-d int tensor. Both come out of
    ``AsyncEngine.ring_snapshot(state)``: a store is a cheap value object
    over live engine state, rebuilt after every training chunk.
    """

    hist: Any
    version: torch.Tensor
    max_versions: int

    @classmethod
    def from_engine(cls, engine, state) -> "VersionStore":
        return cls(*engine.ring_snapshot(state))

    @property
    def latest(self) -> int:
        return int(self.version)

    @property
    def oldest_retained(self) -> int:
        """Oldest version still resident in the ring. Before the ring
        wraps for the first time every slot above ``version`` still holds
        the init params, so retention starts at version 0."""
        return max(self.latest - (self.max_versions - 1), 0)

    def retained_versions(self) -> List[int]:
        return list(range(self.oldest_retained, self.latest + 1))

    def read(self, ver) -> VersionRead:
        """Serve version ``ver`` (an int or a 0-d tensor), clipped to the
        retained window ``[max(latest - (H - 1), 0), latest]``: versions
        that fell off the ring (staleness >= H) get the oldest retained
        model, versions newer than the head get the head. The slot index
        must be a host int for the params to be views, so the read makes
        one host read of ``version`` (``latest``); ``read_ver``,
        ``staleness`` and ``ring_miss`` are 0-d tensors on the version's
        device."""
        h = self.max_versions
        latest = self.latest
        v = int(ver)
        lo = max(latest - (h - 1), 0)
        read_ver = min(max(v, lo), latest)
        params = tree_map(lambda leaf: leaf[read_ver % h], self.hist)
        dev = self.version.device

        def dev_int(x, dtype=torch.int32):
            return torch.tensor(x, dtype=dtype, device=dev)

        return VersionRead(params, dev_int(read_ver), dev_int(latest - read_ver),
                           dev_int(v < lo, torch.bool))
