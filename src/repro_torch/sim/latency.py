"""Composable per-client latency/availability models (torch samplers).

A ``LatencyProfile`` describes the wall-clock behaviour of one fleet:

  * compute time   ~ speed_i * LogNormal(mu, sigma)       (local training)
  * comm time      ~ shift + Exponential(rate)            (up/down link)
  * availability   ~ Exponential(mean gap) off-time between sessions
  * dropout        ~ Bernoulli(hazard) per dispatch (update is lost)
  * speed_i        ~ LogNormal(0, hetero) — persistent per-client multiplier

The profiles are copied from the reference; the samplers turn primitive
draws from a ``repro_torch.core.draws`` source (sites ``speed``,
``latency_compute``, ``latency_comm``, ``dropout``, ``avail_gap``) into
``(n,)`` tensors with the reference's arithmetic. Setting every spread
parameter to zero gives the *degenerate* profile (every client takes
exactly ``exp(mu)`` seconds, always available, never drops).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.core.fleet import whole


@dataclasses.dataclass(frozen=True)
class LatencyProfile:
    name: str
    compute_mu: float = 0.0  # log of median compute seconds
    compute_sigma: float = 0.0  # lognormal spread; 0 => deterministic
    comm_shift: float = 0.0  # deterministic link latency floor
    comm_rate: float = 0.0  # exponential tail rate; 0 => no stochastic tail
    avail_gap: float = 0.0  # mean off-time between sessions; 0 => always on
    dropout: float = 0.0  # per-dispatch probability the update is lost
    hetero: float = 0.0  # per-client persistent speed spread (lognormal)

    def mean_latency(self) -> float:
        """Closed-form mean of one dispatch's wall time: E[speed * compute]
        + E[comm], matching ``sample_latency`` exactly (lognormal mean
        ``exp(mu + (sigma^2 + hetero^2)/2)`` plus ``shift + 1/rate``).

        Deliberately *excludes* ``avail_gap`` and ``dropout`` — those
        shape when a dispatch can start and whether its update survives,
        not how long the dispatch itself takes. For sizing runs on
        profiles with off-windows or dropouts (``mobile``), use
        ``mean_update_interval``, which folds both in (the reference
        pins both against its samplers in ``tests/test_latency_profiles.py``,
        the port in ``tests/test_torch_events_latency.py``).
        """
        compute = math.exp(self.compute_mu + 0.5 * (self.compute_sigma**2 + self.hetero**2))
        comm = self.comm_shift + (1.0 / self.comm_rate if self.comm_rate > 0 else 0.0)
        return compute + comm

    def mean_update_interval(self) -> float:
        """Expected wall time per *successful* update from one client
        dispatching back-to-back: each attempt pays the dispatch latency
        plus the mean off-window before the next session
        (``sample_avail_gap``'s exponential has mean ``avail_gap``), and
        a ``dropout`` fraction of attempts is lost, inflating the
        per-success cost by ``1/(1 - dropout)``. This is the number to
        size run lengths with on profiles like ``mobile``, where
        ``mean_latency`` alone underestimates wall time by ~1.8x."""
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(
                f"dropout must be in [0, 1) for a finite per-success "
                f"interval, got {self.dropout}"
            )
        return (self.mean_latency() + self.avail_gap) / (1.0 - self.dropout)


PROFILES: Dict[str, LatencyProfile] = {
    # zero-spread reference: async loop == sync FedAvg round
    "uniform": LatencyProfile("uniform"),
    # mild datacenter jitter: tight compute, thin comm tail
    "datacenter": LatencyProfile(
        "datacenter", compute_sigma=0.1, comm_shift=0.05, comm_rate=20.0
    ),
    # the paper's edge setting: heavy-tailed devices, flaky links
    "lognormal": LatencyProfile(
        "lognormal", compute_sigma=0.6, comm_shift=0.1, comm_rate=2.0, hetero=0.4
    ),
    # mobile fleet: long off-windows, dropouts, extreme stragglers
    "mobile": LatencyProfile(
        "mobile",
        compute_sigma=1.0,
        comm_shift=0.2,
        comm_rate=1.0,
        avail_gap=2.0,
        dropout=0.1,
        hetero=0.8,
    ),
}


def get_profile(name: str) -> LatencyProfile:
    try:
        return PROFILES[name]
    except KeyError:
        raise ValueError(
            f"unknown latency profile {name!r}; options: {sorted(PROFILES)}"
        ) from None


def client_speed(draws, n: int, profile: LatencyProfile) -> torch.Tensor:
    """Persistent per-client speed multiplier, sampled once per run."""
    if profile.hetero <= 0:
        return torch.ones((n,), dtype=torch.float32, device=draws.device)
    return torch.exp(profile.hetero * draws.normal("speed", (n,)))


def sample_latency(draws, profile: LatencyProfile, speed: torch.Tensor,
                   layout=None) -> torch.Tensor:
    """One dispatch's total wall time (compute + comm) per client, (n,) f32.
    Under a sharded ``layout`` (``core.fleet``) ``speed`` is this rank's
    block: the draws keep their full ``(n,)`` shape and the rank keeps its
    block."""
    lay = whole(layout, speed.shape[0])
    n = lay.n
    if profile.compute_sigma > 0:
        compute = torch.exp(
            profile.compute_mu
            + profile.compute_sigma * draws.normal("latency_compute", (n,))
        )
    else:
        compute = torch.full((n,), math.exp(profile.compute_mu),
                             dtype=torch.float32, device=speed.device)
    comm = torch.full((n,), profile.comm_shift, dtype=torch.float32,
                      device=speed.device)
    if profile.comm_rate > 0:
        comm = comm + draws.exponential("latency_comm", (n,)) / profile.comm_rate
    return speed * lay.block(compute) + lay.block(comm)


def sample_avail_gap(draws, profile: LatencyProfile, n: int) -> torch.Tensor:
    """Off-time before a client re-enters its availability window, (n,) f32."""
    if profile.avail_gap <= 0:
        return torch.zeros((n,), dtype=torch.float32, device=draws.device)
    return profile.avail_gap * draws.exponential("avail_gap", (n,))


def sample_dropout(draws, profile: LatencyProfile, n: int,
                   layout=None) -> torch.Tensor:
    """Per-dispatch dropout draw, (n,) bool (True = update is lost); this
    rank's block of it under a sharded ``layout``."""
    lay = whole(layout, n)
    if profile.dropout <= 0:
        return torch.zeros((lay.local_n,), dtype=torch.bool, device=draws.device)
    return lay.block(draws.uniform("dropout", (n,))) < profile.dropout


def simulate_sync_duration(selection, profile: LatencyProfile, draws) -> float:
    """Simulated wall time of a *synchronous* run with realized selection
    history (rounds, n): each round waits for its slowest selected client
    under this profile. The baseline the async loop is compared against.
    Speeds come from ``draws``, round ``r``'s latencies from
    ``draws.step(r)``. A host-side helper: one host pull per round."""
    selection = torch.as_tensor(selection, device=draws.device)
    n = selection.shape[1]
    speed = client_speed(draws, n, profile)
    total = 0.0
    for r, sel in enumerate(selection):
        lat = sample_latency(draws.step(r), profile, speed)
        total += float(torch.max(torch.where(sel, lat, 0.0)))
    return total
