"""Aggregation topologies as first-class data: the reduction DAG.

Copied from ``repro.topo.graph`` (numpy only, like the reference): the
``Topology`` dataclass and its validation messages, the balanced
contiguous ``assign``/``parents`` maps, the gossip mixing matrix,
``describe``, and the ``@register_topology`` registry with the built-in
``star``, ``hierarchical`` and ``gossip`` factories.

A topology is pure *reduction structure*: clients feed tier-0 aggregation
nodes (edge servers), tiers feed their parents (regional aggregators), and
the top tier feeds the global model — or, for gossip, a flat graph of peer
nodes mixes accumulators with its neighbours. Tier reductions are
accumulator merges (``repro_torch.topo.reduce``), so any ``Aggregator``
with ``additive=True`` runs under any topology. The degenerate ``star`` is
the identity structure: engines treat it exactly like "no topology".

Registry: a topology is a registry entry, not an engine fork —

    from repro_torch.topo import register_topology

    @register_topology("my_topo")
    def _make(**kw):
        return Topology("my_topo", kind="hier", tier_sizes=(16, 4), ...)

and ``RunConfig(topology="my_topo")`` just works.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

KINDS = ("star", "hier", "gossip")


@dataclasses.dataclass(frozen=True)
class Topology:
    """One aggregation DAG: client -> tier 0 -> ... -> global.

    ``tier_sizes`` counts the aggregation nodes per intermediate tier,
    bottom-up and excluding the implicit global root — ``()`` is the
    star (every client talks straight to the server), ``(64, 8)`` is a
    2-tier hierarchy of 64 edge nodes under 8 regional nodes.
    ``tier_profiles`` names one ``sim.latency`` profile per cross-tier
    hop (client->tier0, tier0->tier1, ..., top->global), the per-edge
    latency an update pays on its way up the tree. ``heartbeat_timeout``
    (simulated seconds; 0 disables) arms ``repro_torch.topo.heartbeat``:
    clients the fleet has not heard from for longer than the timeout are
    presumed dead by their tier coordinator and excluded from that
    tier's reduction when their update finally arrives.

    Gossip topologies have exactly one tier of peer nodes mixing
    accumulators over a ``gossip_degree``-regular ring for
    ``gossip_rounds`` rounds; the global model reads node 0's view, which
    converges to the hierarchical reduction as rounds grow (additive
    accumulators are scale-free under the doubly stochastic mixing).
    """

    name: str
    kind: str = "star"
    tier_sizes: Tuple[int, ...] = ()
    tier_profiles: Tuple[str, ...] = ()
    heartbeat_timeout: float = 0.0
    gossip_rounds: int = 2
    gossip_degree: int = 2

    @property
    def n_tiers(self) -> int:
        return len(self.tier_sizes)

    @property
    def is_star(self) -> bool:
        """Degenerate reduction structure: engines must treat a star
        exactly like "no topology" (bit-for-bit pinned by
        ``tests/test_torch_topo_slice.py``). Heartbeat churn still applies."""
        return self.n_tiers == 0

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.kind == "star" and self.tier_sizes:
            raise ValueError("star topologies carry no aggregation tiers")
        if self.kind != "star" and not self.tier_sizes:
            raise ValueError(f"{self.kind} topology needs >= 1 tier")
        if self.kind == "gossip" and self.n_tiers != 1:
            raise ValueError(
                f"gossip is a flat peer graph: exactly one tier of nodes, "
                f"got tier_sizes={self.tier_sizes}"
            )
        if any(int(t) < 1 for t in self.tier_sizes):
            raise ValueError(f"tier sizes must be >= 1, got {self.tier_sizes}")
        if any(a < b for a, b in zip(self.tier_sizes, self.tier_sizes[1:])):
            raise ValueError(
                f"tier sizes must be non-increasing bottom-up (fan-in "
                f"toward the root), got {self.tier_sizes}"
            )
        # one latency profile per cross-tier hop, including the final
        # hop into the global root
        hops = self.n_tiers + (1 if self.tier_sizes else 0)
        if len(self.tier_profiles) not in (0, hops):
            raise ValueError(
                f"need {hops} tier_profiles (one per cross-tier hop, "
                f"including top->global), got {len(self.tier_profiles)}"
            )
        if self.heartbeat_timeout < 0:
            raise ValueError(
                f"heartbeat_timeout must be >= 0 (0 disables), got "
                f"{self.heartbeat_timeout}"
            )
        if self.kind == "gossip":
            if self.gossip_rounds < 0:
                raise ValueError("gossip_rounds must be >= 0")
            if not 0 < self.gossip_degree < int(self.tier_sizes[0]) or (
                self.gossip_degree % 2
            ):
                raise ValueError(
                    f"gossip_degree must be a positive even number below "
                    f"the node count {self.tier_sizes[0]}, got "
                    f"{self.gossip_degree}"
                )

    def validate(self, n_clients: int) -> None:
        """Shape check against a concrete fleet."""
        if self.tier_sizes and self.tier_sizes[0] > n_clients:
            raise ValueError(
                f"topology {self.name!r} has {self.tier_sizes[0]} tier-0 "
                f"nodes for only {n_clients} clients"
            )

    def assign(self, n_clients: int) -> np.ndarray:
        """Client -> tier-0 node map, (n,) int32: balanced contiguous
        blocks (node sizes differ by at most one client)."""
        self.validate(n_clients)
        if self.is_star:
            return np.zeros((n_clients,), np.int32)
        e = int(self.tier_sizes[0])
        return (np.arange(n_clients, dtype=np.int64) * e // n_clients).astype(
            np.int32
        )

    def parents(self) -> Tuple[np.ndarray, ...]:
        """Node -> parent-node maps for tiers 0..T-2 (the top tier's
        parent is the implicit global root), each (tier_sizes[l],) int32
        in the same balanced contiguous layout as ``assign``."""
        out = []
        for lo, hi in zip(self.tier_sizes, self.tier_sizes[1:]):
            lo, hi = int(lo), int(hi)
            out.append(
                (np.arange(lo, dtype=np.int64) * hi // lo).astype(np.int32)
            )
        return tuple(out)

    def gossip_mixing(self) -> np.ndarray:
        """Doubly stochastic mixing matrix of the ``gossip_degree``-regular
        ring over the peer nodes, (E, E) float32: uniform weight over self
        plus ``degree`` nearest ring neighbours. Symmetric, so column sums
        are 1 and the summed accumulator is invariant under mixing."""
        if self.kind != "gossip":
            raise ValueError(f"{self.name!r} is not a gossip topology")
        e = int(self.tier_sizes[0])
        w = 1.0 / (self.gossip_degree + 1)
        mix = np.zeros((e, e), np.float32)
        half = self.gossip_degree // 2
        for off in range(-half, half + 1):
            mix[np.arange(e), (np.arange(e) + off) % e] += w
        return mix

    def describe(self) -> str:
        if self.is_star:
            return "star"
        tiers = "x".join(str(t) for t in self.tier_sizes)
        extra = (
            f";gossip d={self.gossip_degree} r={self.gossip_rounds}"
            if self.kind == "gossip"
            else ""
        )
        hb = f";hb={self.heartbeat_timeout}s" if self.heartbeat_timeout else ""
        return f"{self.kind}[{tiers}]{extra}{hb}"


# ---------------------------------------------------------------------------
# Registry (mirrors engine.registry for policies/aggregators)
# ---------------------------------------------------------------------------

_TOPOLOGIES: Dict[str, Callable] = {}


def register_topology(name: str) -> Callable:
    """Decorator: register ``factory(**kw) -> Topology`` under ``name``."""

    def deco(factory: Callable) -> Callable:
        if name in _TOPOLOGIES:
            raise ValueError(f"topology {name!r} already registered")
        _TOPOLOGIES[name] = factory
        return factory

    return deco


def make_topology(name: str, **kw) -> Topology:
    """Construct a registered topology by name."""
    try:
        factory = _TOPOLOGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown topology {name!r}; registered: "
            f"{', '.join(topology_names())}"
        ) from None
    return factory(**kw)


def topology_names() -> Tuple[str, ...]:
    return tuple(_TOPOLOGIES)


def _as_tiers(tiers) -> Tuple[int, ...]:
    if isinstance(tiers, (int, np.integer)):
        return (int(tiers),)
    return tuple(int(t) for t in tiers)


@register_topology("star")
def make_star(heartbeat_timeout: float = 0.0) -> Topology:
    """The degenerate single-tier star — today's engines, verbatim."""
    return Topology("star", heartbeat_timeout=heartbeat_timeout)


@register_topology("hierarchical")
def make_hierarchical(
    tiers=(8,),
    profiles=None,
    heartbeat_timeout: float = 0.0,
) -> Topology:
    """Edge -> regional -> global tree: ``tiers`` is the node count per
    intermediate tier bottom-up (e.g. ``(64, 8)``), ``profiles`` one
    latency profile name per cross-tier hop (default: ``datacenter``
    links everywhere)."""
    tiers = _as_tiers(tiers)
    hops = len(tiers) + 1
    profiles = tuple(profiles) if profiles else ("datacenter",) * hops
    return Topology(
        f"hier{len(tiers)}",
        kind="hier",
        tier_sizes=tiers,
        tier_profiles=profiles,
        heartbeat_timeout=heartbeat_timeout,
    )


@register_topology("gossip")
def make_gossip(
    nodes: int = 8,
    degree: int = 2,
    rounds: int = 2,
    profile: str = "datacenter",
    heartbeat_timeout: float = 0.0,
) -> Topology:
    """Flat peer graph: ``nodes`` aggregation peers on a ``degree``-regular
    ring mixing accumulators for ``rounds`` gossip rounds."""
    return Topology(
        f"gossip{nodes}",
        kind="gossip",
        tier_sizes=(int(nodes),),
        tier_profiles=(profile, profile),
        heartbeat_timeout=heartbeat_timeout,
        gossip_rounds=int(rounds),
        gossip_degree=int(degree),
    )
