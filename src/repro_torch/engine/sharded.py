"""Mesh-sharded asynchronous engine: the fleet state split across ranks.

The port of ``repro.engine.sharded``. ``AsyncEngine`` holds every
per-client tensor — the ``(n,)`` event-engine vectors, the policy ages,
persistent speeds, the selection/load accumulators, the tier states and
the client data shards — on one device, which caps the fleet at one
device's memory. ``ShardedAsyncEngine`` is the same engine (the same step
math, the same draws, the identical ``_make_async_step`` body) with that
state split over a 1-D mesh of ranks, one rank per device, over
``torch.distributed`` (NCCL on cards, gloo on the CPU):

  * **blocks** — rank ``r`` holds ``[r * n / D, (r + 1) * n / D)`` of every
    leaf with a leading client axis under ``FLEET_STATE_KEYS`` (``ev``,
    ``sched`` ages, ``speed``, ``load_acc``'s last selection, the heartbeat,
    the per-tier last selection, the fault sets' ``prone``/``exposed``, the
    re-dispatch deadlines, the defense's reputation/status and collusion
    sketches) and of ``task.client_data``;
  * **replicated** — the global params, the ``max_versions`` ring, the
    scalars and every cohort-sized ``(B,)`` intermediate.

Every site of the step that reads or writes a fleet leaf goes through a
``core.fleet.BlockFleet`` (the reference's ``pop``/``constrain_state``
hooks): the pop is ``core.distributed.sharded_next_k_events`` (a local
top-B per rank, K2 at fleet scale on the card, an all-gather of the
``D x B`` candidates, one stable merge); gathers at the popped indices
select each slot's owner row from an all-gather; scatters write on the
owner; fleet-wide sums are all-gathered partials summed in rank order.

**Bit-for-bit equivalence.** Every ``(n,)`` draw keeps its full shape on
every rank, from the same ``Draws`` stream, and the rank keeps its block;
every cohort-sized value is computed whole on every rank from gathered
inputs; and the fleet-wide float sums are sums of integer-valued float32,
exact in any partial-sum order. So the engine reproduces ``AsyncEngine``
exactly — the same selections, losses, final params and telemetry — for
the same ``RunConfig`` seed, per step and chunked (the RNG work is not
sharded: each rank draws the whole fleet's coins).

**Cohort-parallel** (``RunConfig.shard_cohort``): the popped cohort is
padded to a multiple of the mesh and each rank trains its slice; the
aggregation merges the slices' accumulators
(``aggregators.cohort_sharded_apply``, or ``topo.reduce.tiered_apply``
over the mesh). Allclose, not bitwise, to the replicated layout.

Shard counts must divide ``n_clients`` (``mesh_shards=0`` auto-detects the
largest divisor of the fleet size at most the available ranks: the process
group's size, or one device with no group, for which ``make_engine`` makes
a world of one). ``launch/ranks.py`` starts D ranks in one call.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core import distributed as dist
from repro_torch.core.fleet import BlockFleet
from repro_torch.core.selection import Policy
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.engine.aggregators import Aggregator, cohort_sharded_apply
from repro_torch.engine.async_engine import AsyncEngine, _make_async_step
from repro_torch.engine.config import RunConfig
from repro_torch.fl.task import FLTask

# state entries whose leading-``n`` leaves are blocks over the fleet axis;
# their (E,) per-tier moments, the fault sets' scalar counters and the
# defense's scalars and learned head stay replicated through the
# shape[0] == n test of fleet_state_sharding, as in the reference
FLEET_STATE_KEYS = ("ev", "sched", "speed", "load_acc", "hb", "tier_acc",
                    "faults", "rd", "defense")


def per_device_state_bytes(state) -> int:
    """Bytes of a state tree held by this rank: the sum of its tensors'
    sizes (a block counts its block)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(state)
               if isinstance(t, torch.Tensor))


def fleet_state_sharding(n: int, state: Dict) -> Dict:
    """A matching tree of bools for an engine state: True for a leaf with a
    leading client axis under the per-client entries (a block over the
    fleet axis), False for everything else (params, ring, scalars)."""

    def leaf_rule(is_fleet):
        def rule(x):
            return bool(is_fleet and isinstance(x, torch.Tensor)
                        and x.dim() >= 1 and x.shape[0] == n)

        return rule

    return {key: tree_map(leaf_rule(key in FLEET_STATE_KEYS), sub)
            for key, sub in state.items()}


def require_cohort_mesh(shards: int, what: str) -> None:
    """``shard_cohort=True`` on a 1-device mesh would be a silent no-op
    (the "sharded" cohort is the whole cohort) — reject it loudly."""
    if shards < 2:
        raise ValueError(
            f"shard_cohort=True but {what} resolves to a {shards}-device "
            "mesh — cohort-parallel execution needs >= 2 devices. Start "
            "that many ranks over torch.distributed (the fl_async/fl_train "
            "drivers spawn them for --mesh-shards D); otherwise drop "
            "shard_cohort."
        )


def make_sharded_eval(task: FLTask, mesh: dist.FleetMesh):
    """Eval with the held-out batch axis split over the ranks of ``mesh``
    (params replicated): each rank scores ``1/D`` of the eval set with
    ``task.eval_batch_fn``, which returns the batch's summed metrics, and
    the sums are merged in rank order. Returns None — the caller falls back
    to the replicated ``task.eval_fn`` — when the task lacks the
    batched-eval interface (``eval_data``/``eval_batch_fn``) or the eval
    prefix does not divide the mesh. Metrics are allclose to, not bitwise
    identical with, the replicated eval (the reduction order differs)."""
    if task.eval_data is None or task.eval_batch_fn is None:
        return None
    leaves = list(task.eval_data.values())
    n_eval = leaves[0].shape[0]
    if n_eval % mesh.size or any(a.dim() < 1 or a.shape[0] != n_eval
                                 for a in leaves):
        return None
    per = n_eval // mesh.size
    data = {k: a[mesh.rank * per:(mesh.rank + 1) * per]
            for k, a in task.eval_data.items()}

    @torch.no_grad()
    def evaluate(params):
        sums = task.eval_batch_fn(params, data)
        return {k: dist.psum(v, mesh) / n_eval for k, v in sums.items()}

    return evaluate


class CohortSplit:
    """This rank's slice of the cohort-parallel mode's padded cohort: a
    ``width``-slot cohort padded with ``pad`` slots to a multiple of the
    mesh, rank ``r`` training slots ``[r * w / D, (r + 1) * w / D)`` of the
    padded axis. ``rows`` maps the slice to cohort slots (a padded slot
    repeats the last real one and carries weight 0)."""

    def __init__(self, width: int, mesh: dist.FleetMesh, device):
        self.mesh = mesh
        self.width = width
        self.pad = dist.cohort_padding(width, mesh.size)
        per = (width + self.pad) // mesh.size
        lo = mesh.rank * per
        self.slots = slice(lo, lo + per)
        self.rows = torch.clamp(torch.arange(lo, lo + per, device=device),
                                max=width - 1)

    def slot_weights(self, w):
        """This rank's slice of the weights, 0 on padded slots."""
        return torch.cat([w, w.new_zeros((self.pad,))])[self.slots]

    def gather(self, x):
        """The cohort's ``x`` (``width`` slots) from each rank's slice."""
        parts = dist.all_gather(x, self.mesh)
        return parts.reshape((-1,) + tuple(x.shape[1:]))[:self.width]


class ShardedAsyncEngine(AsyncEngine):
    """``AsyncEngine`` with the fleet state split over a mesh of ranks.

    Drop-in behind the ``Engine`` protocol: ``make_engine`` routes here
    whenever ``RunConfig.mesh_shards`` is set (0 = auto-detect). Every rank
    of the mesh constructs the engine and drives it in lockstep (each step
    makes collectives); each returns the same results. The engine keeps
    only this rank's block of the task's client data (``self.task``): a
    caller that drops its own whole-fleet task frees the rest.
    """

    def __init__(
        self,
        task: FLTask,
        cfg: RunConfig,
        policy: Optional[Policy] = None,
        aggregator: Optional[Aggregator] = None,
        draws=None,
    ):
        n = cfg.n_clients
        shards = dist.resolve_fleet_shards(
            n, cfg.mesh_shards or 0, dist.available_ranks(task.device))
        mesh = dist.fleet_mesh(shards, device=task.device)
        self.mesh = mesh
        self.mesh_shards = mesh.size
        if cfg.shard_cohort:
            require_cohort_mesh(mesh.size, f"mesh_shards={cfg.mesh_shards}")
        self.fleet = BlockFleet(n, mesh)
        # client data is per-client state too: keep this rank's block
        task = dataclasses.replace(task, client_data={
            k: self.fleet.own_block(a) if a.shape[:1] == (n,) else a
            for k, a in task.client_data.items()})
        self._sharded_eval = (make_sharded_eval(task, mesh)
                              if cfg.shard_cohort else None)
        self._spec = None
        super().__init__(task, cfg, policy=policy, aggregator=aggregator,
                         draws=draws)

    def _layout(self):
        return self.fleet

    def _build_step(self):
        cfg = self.cfg
        kw = dict(topo=self.topo, faults=self.fault_set, defense=self.defense,
                  layout=self.fleet)
        if cfg.shard_cohort:
            # cohort-parallel: each rank trains and accumulates its slice
            # of the padded cohort; the aggregation merges the slices
            if self.topo is not None and not self.topo.is_star:
                from repro_torch.topo.reduce import tiered_apply

                kw["aggregate"] = tiered_apply(self.aggregator, self.topo,
                                               cfg.n_clients, mesh=self.mesh)
            else:
                kw["aggregate"] = cohort_sharded_apply(self.aggregator, self.mesh)
            kw["cohort"] = CohortSplit(cfg.resolved_buffer_size(), self.mesh,
                                       self.task.device)
        return _make_async_step(self.task, cfg, self.policy, self.aggregator,
                                self.profile, **kw)

    def init(self) -> Dict:
        """The single engine's initial state (the same draws), each fleet
        leaf cut to this rank's block; replicated leaves are kept as they
        are."""
        state = super().init()
        self._spec = fleet_state_sharding(self.cfg.n_clients, state)
        return tree_map(lambda x, blk: self.fleet.own_block(x) if blk else x,
                        state, self._spec)

    def unshard(self, state: Dict) -> Dict:
        """The whole-fleet state (every rank gets it): each block leaf
        all-gathered in rank order."""
        if self._spec is None:
            raise RuntimeError("unshard needs the layout of init(): call init() first")
        return tree_map(lambda x, blk: self.fleet.unshard(x) if blk else x,
                        state, self._spec)

    def step(self, state: Dict, r: int):
        state, aux = super().step(state, r)
        return state, {**aux, "send": self.fleet.unshard(aux["send"])}

    def run_chunk(self, state: Dict, r0: int, length: int, with_history: bool):
        state, aux = super().run_chunk(state, r0, length, with_history)
        if with_history:
            rows = dist.all_gather(aux["send"], self.mesh)  # (D, L, n / D)
            aux = {**aux, "send": rows.permute(1, 0, 2).reshape(length, -1)}
        return state, aux

    def evaluate(self, state: Dict) -> Dict:
        if self._sharded_eval is not None:
            return self._sharded_eval(self.eval_params(state))
        return super().evaluate(state)

    def finalize(self, state, records, sel_hist, wall_time_s):
        return super().finalize(self.unshard(state), records, sel_hist,
                                wall_time_s)

    def per_device_state_bytes(self, state: Dict) -> int:
        """Bytes of the engine state this rank holds — the
        sharded-vs-single-device memory comparison."""
        return per_device_state_bytes(state)

    def fleet_state_bytes(self, state: Dict) -> int:
        """Bytes of this rank's blocks of the fleet leaves (1/D of the
        single engine's fleet bytes)."""
        sizes = tree_map(lambda x, blk: per_device_state_bytes(x) if blk else 0,
                         state, self._spec)
        return sum(tree_leaves(sizes))

    def progress_line(self, rec, elapsed: float) -> str:
        return (
            f"  [{self.policy.name}/{self.profile.name}{self._topo_tag()}"
            f"/x{self.mesh_shards}] "
            f"step {rec.round:4d} t={rec.clock:9.2f}s v={rec.version:4d} "
            f"acc={rec.accuracy:.4f} loss={rec.eval_loss:.4f} ({elapsed:.1f}s)"
        )
