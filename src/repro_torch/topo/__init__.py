"""Aggregation topology of the port (``repro.topo``).

``repro_torch.topo.graph`` holds the torch-free structure (the ``Topology``
dataclass, its ``@register_topology`` registry, and the built-in star /
hierarchical / gossip factories, copied from the reference);
``repro_torch.topo.reduce`` compiles a topology into the engines'
aggregation hook (tier merges through K1's segmented route, per-hop
latency); ``repro_torch.topo.heartbeat`` adds liveness and churn.
"""
from repro_torch.topo.graph import (
    Topology,
    make_topology,
    register_topology,
    topology_names,
)
from repro_torch.topo.heartbeat import beat, beat_at, expired, init_heartbeat
from repro_torch.topo.reduce import make_hop_latency, tiered_apply

__all__ = [
    "Topology",
    "make_topology",
    "register_topology",
    "topology_names",
    "tiered_apply",
    "make_hop_latency",
    "init_heartbeat",
    "beat",
    "beat_at",
    "expired",
]
