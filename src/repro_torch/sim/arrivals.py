"""Open-loop request arrival process for the serving tier.

Port of ``repro.sim.arrivals``. An ``ArrivalProcess`` describes synthetic
inference traffic the way ``LatencyProfile`` describes fleet wall-clock
behaviour:

  * arrivals per tick ~ Poisson(rate)            (open loop: demand does
                                                  not wait for capacity)
  * generation length ~ gen_len * LogNormal(0, spread), clipped to
                        [1, max(1, 2 * gen_len)]
  * prompt tokens     ~ Uniform(vocab)

``from_profile`` derives the length spread from a latency profile's
heterogeneity (``compute_sigma + hetero``). The samplers draw from a
``core.draws`` source at the sites ``counts``, ``gen_len`` and ``prompt``
(a generator in real runs; the reference's arrays under ``ReplayDraws``,
which gives the reference's trace exactly), so a whole trace is drawn up
front and the serving loop stays deterministic under a seed.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch.sim.latency import LatencyProfile


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    name: str
    rate: float  # mean requests per scheduler tick (Poisson)
    prompt_len: int  # prompt tokens per request
    gen_len: int  # median tokens to generate
    len_spread: float = 0.0  # lognormal sigma of the generation length

    def __post_init__(self) -> None:
        if self.rate < 0:
            raise ValueError(f"rate must be >= 0, got {self.rate}")
        if self.prompt_len < 1 or self.gen_len < 1:
            raise ValueError("prompt_len and gen_len must be >= 1")


def from_profile(
    profile: LatencyProfile, rate: float, prompt_len: int, gen_len: int
) -> ArrivalProcess:
    """Traffic shaped by a fleet latency profile: the request-length
    spread inherits the profile's compute heterogeneity."""
    return ArrivalProcess(
        name=f"poisson[{profile.name}]",
        rate=rate,
        prompt_len=prompt_len,
        gen_len=gen_len,
        len_spread=profile.compute_sigma + profile.hetero,
    )


def sample_arrival_counts(draws, proc: ArrivalProcess, ticks: int) -> torch.Tensor:
    """(ticks,) int32 requests arriving at each tick."""
    return draws.poisson("counts", proc.rate, (ticks,)).to(torch.int32)


def sample_gen_lens(draws, proc: ArrivalProcess, n: int) -> torch.Tensor:
    """(n,) int32 generation lengths ~ gen_len * LogNormal(0, spread),
    clipped to [1, max(1, 2 * gen_len)] so one giant request cannot pin a
    slot for an unbounded run."""
    if proc.len_spread == 0.0:
        return torch.full((n,), proc.gen_len, dtype=torch.int32, device=draws.device)
    ln = torch.exp(proc.len_spread * draws.normal("gen_len", (n,)))
    return torch.clamp(torch.round(proc.gen_len * ln), 1,
                       max(1, 2 * proc.gen_len)).to(torch.int32)


def sample_requests(draws, proc: ArrivalProcess, ticks: int, vocab: int) -> List:
    """Materialize a whole request trace: a list of
    ``repro_torch.serve.Request`` covering ``ticks`` scheduler ticks, its
    prompts as numpy arrays (the trace is host data)."""
    from repro_torch.serve.loop import Request

    counts = sample_arrival_counts(draws, proc, ticks).cpu().numpy()
    total = int(counts.sum())
    lens = sample_gen_lens(draws, proc, total).cpu().numpy()
    prompts = draws.randint("prompt", 0, vocab, (total, proc.prompt_len))
    prompts = prompts.to(torch.int32).cpu().numpy()
    out, rid = [], 0
    for t, c in enumerate(counts):
        for _ in range(int(c)):
            out.append(Request(rid=rid, tick=t, prompt=prompts[rid],
                               gen_len=int(lens[rid])))
            rid += 1
    return out
