"""Distributed decentralized scheduling over ``torch.distributed``.

The port of ``repro.core.distributed``. The paper's key systems claim: the
Markov policy needs *no coordination* — each client decides from its own
age. At fleet scale the ``(n,)`` age vector is split over ranks, each rank
runs the Bernoulli decisions for its own client block, and the only
cross-rank traffic is one integer count (vs. the O(ranks * k) candidates
that a centralized policy such as oldest-age top-k gathers — also provided,
for an honest comparison of communication volume).

The reference lays its arrays over a 1-D device mesh and lets GSPMD insert
the collectives. Here the mesh is a process group with one rank per device
(NCCL on cards, gloo on the CPU), a ``FleetMesh`` names this rank's place in
it, and every collective is written out:

  * ``all_gather`` — each rank's tensor stacked in rank order, ``(D, ...)``;
  * ``psum`` — the ranks' partial values all-gathered and summed in rank
    order on every rank. No float reduction goes through ``all_reduce``,
    whose order is the library's: every rank gets the same bits, and two
    runs repeat bitwise;
  * ``sharded_next_k_events`` — the buffer pop: a local top-B per rank
    (the ``event_topk`` kernel, K2, at fleet scale on the card), an
    all-gather of the ``D x B`` candidates with their global indices, and
    one stable merge;
  * ``oldest_age_step_sharded`` — the centralized comparator: a local
    top-k through the ``aoi_topk`` kernel's route (K3), a gather, and a
    merge with ties to the lower global index.

``merge_next_k``/``merge_top_k`` take the candidates of D shards as lists,
so one process can hold the merges against a global top-k without ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.aoi import age_update

# the engine's fleet-sharding axis name (1-D mesh over client shards)
FLEET_AXIS = "fleet"


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """A 1-D mesh of ``size`` ranks over the fleet axis: this process is
    rank ``rank`` of the default process group, which the mesh spans."""

    size: int
    rank: int

    @property
    def backend(self) -> str:
        return str(torch.distributed.get_backend())


def available_ranks(device=None) -> int:
    """What a fleet mesh can span: the process group's world size when one
    exists; without one, the visible GPU count on CUDA and 1 on the CPU."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def fleet_mesh(shards: int = 0, device=None) -> FleetMesh:
    """The mesh of ``shards`` ranks (``shards=0`` takes every available
    one). A mesh spans the whole process group; a world of one with no
    group yet starts one (``init_world_of_one``), which lasts until the
    group is destroyed (``world_of_one`` scopes it)."""
    available = available_ranks(device)
    d = shards or available
    if d > available:
        raise ValueError(
            f"requested {d} fleet shards but only {available} devices "
            "are available (start one rank per shard over torch.distributed:"
            " the fl_async/fl_train drivers spawn them for --mesh-shards D,"
            " one per GPU on CUDA, any number on the CPU over gloo)"
        )
    dist = torch.distributed
    if not dist.is_initialized():
        init_world_of_one(device)
    world = dist.get_world_size()
    if d != world:
        raise ValueError(
            f"a fleet mesh spans its whole process group: asked for {d} "
            f"shards in a group of {world} ranks"
        )
    return FleetMesh(size=d, rank=dist.get_rank())


def init_world_of_one(device=None) -> None:
    """A process group of this process alone (NCCL on CUDA, gloo on the
    CPU). Its rendezvous is an in-memory ``HashStore``: nothing is written
    outside the process."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        backend, store=torch.distributed.HashStore(), rank=0, world_size=1)


@contextlib.contextmanager
def world_of_one(device=None):
    """Run the body in a world of one (``init_world_of_one``) when no
    process group exists, and destroy that group on exit; inside an
    existing group the body runs in it and the group is left as it was."""
    made = not torch.distributed.is_initialized()
    if made:
        init_world_of_one(device)
    try:
        yield
    finally:
        if made:
            torch.distributed.destroy_process_group()


def cohort_padding(b: int, shards: int) -> int:
    """Zero-weight slots appended to a ``b``-wide cohort so its axis
    divides a ``shards``-device mesh — the cohort-parallel execution mode
    shards the padded axis evenly and the padding slots carry weight 0
    (they never touch the aggregate, the telemetry, or the event state,
    which masks them exactly like invalid buffer slots)."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    return -b % shards


def resolve_fleet_shards(n: int, shards: int, available: int) -> int:
    """Shard count for an ``n``-client fleet: ``shards`` when explicit
    (must divide ``n`` so every device owns an equal client block), else
    the largest divisor of ``n`` at most ``available`` — auto-detection
    never fails, it just leaves devices idle for awkward fleet sizes."""
    if shards:
        if n % shards:
            raise ValueError(
                f"n_clients={n} is not divisible by mesh_shards={shards}; "
                "pick a shard count dividing the fleet (or 0 to auto-detect)"
            )
        return shards
    d = max(min(available, n), 1)
    while n % d:
        d -= 1
    return d


def scheduler_comm_bytes(n: int, k: int, devices: int) -> Tuple[int, int]:
    """(markov, oldest_age) per-round scheduler communication in bytes —
    the decentralization win, quantified."""
    markov = 4  # one int32 psum
    oldest = devices * k * 8  # gathered (value, index) candidates
    return markov, oldest


# ---------------------------------------------------------------------------
# Collectives (every rank calls each of them, in the same order)
# ---------------------------------------------------------------------------


def all_gather(x: torch.Tensor, mesh: FleetMesh) -> torch.Tensor:
    """``(D, *x.shape)``: every rank's ``x`` stacked in rank order (bool
    travels as uint8; the bits are copied, so -0.0, NaN and inf arrive as
    they left)."""
    is_bool = x.dtype == torch.bool
    src = (x.to(torch.uint8) if is_bool else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    torch.distributed.all_gather(parts, src)
    out = torch.stack(parts)
    return out.to(torch.bool) if is_bool else out


def psum(x: torch.Tensor, mesh: FleetMesh) -> torch.Tensor:
    """The ranks' partial ``x`` summed in rank order, the same bits on
    every rank. Equal to the one-device sum only where the terms are
    integer-valued (exact in any order), which is where the engines use
    it on floats."""
    parts = all_gather(x, mesh)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


# ---------------------------------------------------------------------------
# Merges of per-shard candidates (pure: lists of shards in one process)
# ---------------------------------------------------------------------------


def merge_next_k(cand_t: Sequence[torch.Tensor], cand_i: Sequence[torch.Tensor],
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k earliest of the shards' candidates: ``cand_t[r]`` are shard
    ``r``'s local next-k times in ascending order (ties by index), and
    ``cand_i[r]`` their global indices. Candidates in shard order are in
    global-index order among equal times, so one stable sort gives the
    global top-k's values, indices and tie order."""
    flat_t = torch.cat(list(cand_t))
    flat_i = torch.cat(list(cand_i))
    vals, pos = torch.sort(flat_t, stable=True)
    return vals[:k], flat_i[pos[:k]]


def merge_top_k(cand_v: Sequence[torch.Tensor], cand_i: Sequence[torch.Tensor],
                k: int) -> torch.Tensor:
    """Global indices of the k largest of the shards' candidates, ties to
    the lower global index: ``cand_i[r]`` ascending within a shard (the
    unsorted top-k's order), so the flat list is in global-index order and
    a stable descending sort keeps it among equal values."""
    flat_v = torch.cat(list(cand_v))
    flat_i = torch.cat(list(cand_i))
    _, pos = torch.sort(flat_v, descending=True, stable=True)
    return flat_i[pos[:k]]


def _block(n: int, mesh: FleetMesh) -> Tuple[int, int]:
    """(shard length, this rank's first global index) of an ``n``-wide
    axis padded to a multiple of the mesh."""
    shard = -(-n // mesh.size)
    return shard, mesh.rank * shard


def _pad(x: torch.Tensor, shard: int, fill) -> torch.Tensor:
    if x.shape[0] == shard:
        return x
    return torch.cat([x, torch.full((shard - x.shape[0],), fill, dtype=x.dtype,
                                    device=x.device)])


def sharded_next_k_events(mesh: FleetMesh, n: int, k: int,
                          use_kernel: Optional[bool] = None) -> Callable:
    """The sharded buffer pop: ``f(times block) -> (t (k,), idx (k,))``,
    equal (values, indices and tie order) to a global next-k over the full
    fleet, the same on every rank.

    This rank's block is ``[rank * s, (rank + 1) * s)`` with ``s =
    ceil(n / D)``; a ragged fleet's last blocks are shorter (or empty) and
    are padded here with ``+inf`` sentinels, which can only surface as
    invalid pops (callers mask by ``torch.isfinite``). Each rank extracts
    its local ``min(k, s)`` earliest events (``sim.events.next_k_events``:
    K2 for blocks of at least ``KERNEL_THRESHOLD`` on the card), the
    ``D x min(k, s)`` candidates are all-gathered, and ``merge_next_k``
    picks the global k: O(D * k) communication per step instead of the
    ``(n,)`` vector. ``k <= n`` as everywhere in the event engine."""
    from repro_torch.sim.events import next_k_events

    shard, base = _block(n, mesh)
    kk = min(k, shard)

    def next_k(times: torch.Tensor):
        t_loc, i_loc = next_k_events(_pad(times, shard, float("inf")), kk,
                                     use_kernel=use_kernel)
        cand_t = all_gather(t_loc, mesh)
        cand_i = all_gather(i_loc.to(torch.int64) + base, mesh)
        return merge_next_k(cand_t, cand_i, k)

    return next_k


def markov_step_sharded(mesh: FleetMesh, probs, m: int) -> Callable:
    """``f(ages block, draws) -> (selected, new ages, count)``: the Markov
    decisions of this rank's clients, purely local (decentralized); only
    the cohort count crosses ranks (an integer ``psum``).

    The reference folds the device index into its key; here each rank draws
    its block's coins from its own sub-stream ``draws.sub(str(rank))``
    (site ``select``), so the draws differ from the one-device policy's, as
    the reference's do."""
    p = torch.as_tensor(probs, dtype=torch.float32)

    def step(ages: torch.Tensor, draws):
        send_p = p.to(ages.device)[torch.clamp(ages, max=m).long()]
        sel = draws.sub(str(mesh.rank)).uniform("select", tuple(ages.shape)) < send_p
        count = psum(sel.to(torch.int32).sum(dtype=torch.int32), mesh)
        return sel, age_update(ages, sel), count

    return step


def sharded_top_k(scores: torch.Tensor, k: int, mesh: FleetMesh) -> torch.Tensor:
    """Global indices ``(k,)`` of the k largest of the fleet's ``scores``,
    ties to the lower global index, the same on every rank: this rank's
    block (``scores``, ``n / D`` wide) gives its local top-k
    (``core.selection._topk_idx``: K3 for blocks of at least
    ``KERNEL_THRESHOLD`` on the card, a stable sort otherwise), the
    ``D x k`` candidates are all-gathered with their global indices, and
    ``merge_top_k`` picks the k. The local top-k keeps the lower local
    index among equal scores and returns its picks in index order, and the
    merge keeps the flat order among equal values, so lower shards — i.e.
    lower global ids — win."""
    from repro_torch.core.selection import _topk_idx

    n_loc = scores.shape[0]
    idx = _topk_idx(scores, min(k, n_loc))
    cand_v = all_gather(scores[idx], mesh)
    cand_i = all_gather(idx.to(torch.int64) + mesh.rank * n_loc, mesh)
    return merge_top_k(cand_v, cand_i, k)


def oldest_age_step_sharded(mesh: FleetMesh, k: int) -> Callable:
    """Centralized oldest-age at fleet scale: ``f(ages block) -> (selected
    block, new ages block, chosen (k,))`` — ``sharded_top_k`` of the ages
    (a local top-k per rank, the ``D x k`` candidates gathered, a global
    top-k over them: communication O(D * k), vs O(1) for the Markov
    policy — the paper's decentralization argument, made concrete), ties
    to the lower *global* client index, deterministically. No draw is
    involved. ``ages`` may be integer ages or float scores."""

    def step(ages: torch.Tensor):
        n_loc = ages.shape[0]
        chosen = sharded_top_k(ages, k, mesh)  # (k,) global ids, every rank
        loc = chosen - mesh.rank * n_loc
        own = (loc >= 0) & (loc < n_loc)
        sel = torch.zeros((n_loc + 1,), dtype=torch.bool, device=ages.device)
        sel = sel.index_fill(0, torch.where(own, loc, n_loc), True)[:n_loc]
        return sel, age_update(ages, sel), chosen

    return step
