"""The synchronous FedAvg engine — the paper's round loop.

One round = policy step (which also ages the clients) ->
``cohort_indices`` -> gather the cohort's shards -> local training of
every slot from the current global params -> aggregator
``weigh/init/accumulate/finalize`` with staleness 0. With the default
``fedavg`` aggregator the cohort sum is the ``fedavg_reduce`` kernel
(K1).

This is ``repro.engine.sync``. With ``shard_cohort`` (and a mesh of
``mesh_shards`` ranks over ``torch.distributed``) the cohort axis is padded
with zero-weight slots to a multiple of the mesh and split over the ranks:
each rank trains its slice from replicated client data, the aggregation
merges the slices' accumulators (``aggregators.cohort_sharded_apply``, or
``topo.reduce.tiered_apply`` over the mesh) and the eval examples are split
too (``engine.sharded.make_sharded_eval``); allclose, not bitwise, to the
replicated round. A multi-tier topology routes the round's
aggregation through ``topo.reduce.tiered_apply`` (with the unstacked
global tree as bases) and adds the per-tier load accumulators
(``tier_acc``); a heartbeat is rejected, as in the reference (sync rounds
have no mid-round clock). Faults ride the round as in the reference: the
fault set's state is part of the engine state, its draws come from the
``faults`` sub-stream of the run's source (so a rate-0 armed run is
bitwise the calm run), and the popped cohort goes through ``on_pop``, then
``corrupt_updates``, then ``collude_updates``, then the kill mask on the
weights. The adaptive defense rides the round as in the reference: its
state is part of the engine state, its coins come from the ``defense``
sub-stream, quarantined clients are masked out of ``selected`` right after
the policy step (they still age), every surviving slot is scored with
staleness zero, post-transition suspects lose their weight, clique members'
weights are discounted, and with mtd the moving-target wrapper aggregates
at the level ``Defense.step_level`` gives: one host read of the level per
closed mtd window, none otherwise (the rule of ``engine/async_engine.py``).
Robust aggregators' telemetry (``stat_names``) accumulates in
``agg_stats``. The global params are not materialized ``width`` times per
round: the cohort sees them as stride-0 views
(``fl.server.broadcast_to_cohort``), the first SGD step writes the
per-slot copies, and aggregators receive the unstacked global tree as
``bases``. Every tensor of the state lives on the task's device, and no
round syncs with the host: the learning rate comes from the policy state's
round counter on the device.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.draws import GeneratorDraws
from repro_torch.core.load_metric import (
    empirical_load_stats,
    init_selection_accum,
    init_tier_accum,
    selection_stats_from_accum,
    tier_blocks,
    tier_stats_from_accum,
    update_tier_accum,
)
from repro_torch.core.selection import Policy
from repro_torch.core.tree import tree_map
from repro_torch.engine.aggregators import Aggregator, acc_stats
from repro_torch.engine.chunk import ChunkRunner, step_once
from repro_torch.engine.config import RoundRecord, RunConfig, RunResult
from repro_torch.engine.registry import make_aggregator, make_policy
from repro_torch.fl.client import make_local_update
from repro_torch.fl.server import broadcast_to_cohort, cohort_indices
from repro_torch.fl.task import FLTask
from repro_torch.optim.schedules import exponential_decay


class SyncEngine:
    """Synchronous rounds: every selected client trains from the current
    global params and the buffer is flushed once per round.

    ``draws`` is the run's random source (``core.draws``); by default a
    ``torch.Generator`` on the task's device seeded with ``cfg.seed``.
    """

    def __init__(
        self,
        task: FLTask,
        cfg: RunConfig,
        policy: Optional[Policy] = None,
        aggregator: Optional[Aggregator] = None,
        draws=None,
    ):
        if cfg.mode != "sync":
            raise ValueError(f"SyncEngine needs mode='sync', got {cfg.mode!r}")
        self.task = task
        self.cfg = cfg
        self.policy = policy or make_policy(
            cfg.policy, cfg.n_clients, cfg.k, cfg.m, **dict(cfg.policy_kwargs)
        )
        self.aggregator = aggregator or make_aggregator(
            cfg.resolved_aggregator(), **dict(cfg.aggregator_kwargs)
        )
        self.draws = draws if draws is not None else GeneratorDraws(cfg.seed,
                                                                    task.device)
        self.topo = cfg.resolved_topology()
        if self.topo is not None and self.topo.heartbeat_timeout > 0:
            raise ValueError(
                "heartbeat churn is wall-clock-based and needs the async "
                "engine's event clock; sync rounds have no mid-round time "
                "for a client to go dark in — drop heartbeat_timeout or "
                "use mode='async'"
            )
        self.fault_set = cfg.resolved_faults()
        if self.fault_set is not None:
            only = self.fault_set.async_only_names()
            if only:
                raise ValueError(
                    f"fault(s) {', '.join(only)} act on the async engine's "
                    "wall clock / version ring; sync rounds have neither — "
                    "drop them or use mode='async'"
                )
        self.defense_cfg = cfg.resolved_defense()
        if self.defense_cfg is not None:
            from repro_torch.defense import make_defense

            self.defense = make_defense(cfg.n_clients, self.defense_cfg)
        else:
            self.defense = None
        tiered = self.topo is not None and not self.topo.is_star
        aggregate = None
        blocks = None
        cohort = None
        self._sharded_eval = None
        mesh = None
        if cfg.shard_cohort:
            # cohort-parallel sync rounds: sync has no per-client device
            # state, so the mesh splits the *cohort* axis only
            from repro_torch.core import distributed as dist
            from repro_torch.engine.aggregators import cohort_sharded_apply
            from repro_torch.engine.sharded import (
                CohortSplit,
                make_sharded_eval,
                require_cohort_mesh,
            )

            shards = cfg.mesh_shards or dist.available_ranks(task.device)
            require_cohort_mesh(shards, f"mesh_shards={cfg.mesh_shards}")
            mesh = dist.fleet_mesh(shards, device=task.device)
            self.mesh, self.mesh_shards = mesh, shards
            width = cfg.cohort_width() if not self.policy.exact_k else cfg.k
            cohort = CohortSplit(width, mesh, task.device)
            aggregate = cohort_sharded_apply(self.aggregator, mesh)
            self._sharded_eval = make_sharded_eval(task, mesh)
        if tiered:
            from repro_torch.topo.reduce import tiered_apply

            aggregate = tiered_apply(self.aggregator, self.topo, cfg.n_clients,
                                     mesh=mesh, stacked_bases=False)
            blocks = tier_blocks(self.topo.assign(cfg.n_clients), task.device)
        core = _make_round_core(task, cfg, self.policy, self.aggregator,
                                aggregate=aggregate, faults=self.fault_set,
                                defense=self.defense, cohort=cohort)
        have_faults = self.fault_set is not None
        have_def = self.defense is not None
        stat_names = self.aggregator.stat_names

        def step(state, draws):
            params, sched, selected, loss, fstate, dstate, tel = core(
                state["params"], state["sched"], draws,
                state["faults"] if have_faults else None,
                state["defense"] if have_def else None)
            out = {"params": params, "sched": sched}
            if blocks is not None:
                out["tier_acc"] = update_tier_accum(state["tier_acc"], selected,
                                                    blocks)
            if have_faults:
                out["faults"] = fstate
            if have_def:
                out["defense"] = dstate
            if stat_names:
                out["agg_stats"] = {s: state["agg_stats"][s] + tel[s]
                                    for s in stat_names}
            return out, {"send": selected, "loss": loss}

        self._chunk = ChunkRunner(step, aux_keys=("loss",))

    def init(self) -> Dict:
        cfg, d = self.cfg, self.draws
        dev = self.task.device
        state = {
            "params": self.task.init(d),
            "sched": self.policy.init(d, cfg.n_clients),
            "load_acc": init_selection_accum(cfg.n_clients, cfg.k, dev),
        }
        if self.topo is not None and not self.topo.is_star:
            state["tier_acc"] = init_tier_accum(
                cfg.n_clients, int(self.topo.tier_sizes[0]), dev)
        if self.fault_set is not None:
            # the faults sub-stream: the calm stream's draws never move
            state["faults"] = self.fault_set.init(d.sub("faults"))
        if self.defense is not None:
            state["defense"] = self.defense.init(dev)  # deterministic zeros
        if self.aggregator.stat_names:
            state["agg_stats"] = {
                s: torch.zeros((), dtype=torch.float32, device=dev)
                for s in self.aggregator.stat_names
            }
        return state

    def step(self, state: Dict, r: int):
        return step_once(self._chunk, state, self.draws, r)

    def run_chunk(self, state: Dict, r0: int, length: int, with_history: bool):
        return self._chunk(state, self.draws, r0, length, with_history)

    def eval_params(self, state: Dict):
        return state["params"]

    def evaluate(self, state: Dict) -> Dict:
        if self._sharded_eval is not None:
            return self._sharded_eval(self.eval_params(state))
        return self.task.eval_fn(self.eval_params(state))

    def record(self, r: int, aux: Dict, ev: Dict) -> RoundRecord:
        return RoundRecord(
            round=r + 1,
            train_loss=float(aux["loss"]),
            eval_loss=float(ev["loss"]),
            accuracy=float(ev["accuracy"]),
        )

    def progress_line(self, rec: RoundRecord, elapsed: float) -> str:
        tag = (
            f"/{self.topo.describe()}"
            if self.topo is not None and not self.topo.is_star else ""
        )
        return (
            f"  [{self.policy.name}{tag}] round {rec.round:4d} "
            f"acc={rec.accuracy:.4f} loss={rec.eval_loss:.4f} ({elapsed:.1f}s)"
        )

    def finalize(self, state, records, sel_hist, wall_time_s) -> RunResult:
        if sel_hist is not None:
            load_stats = empirical_load_stats(sel_hist)
        else:
            load_stats = selection_stats_from_accum(state["load_acc"])
        load_stats = dict(load_stats)
        if "tier_acc" in state:
            load_stats.update(tier_stats_from_accum(state["tier_acc"]))
        if "faults" in state:
            for nm, cnt in self.fault_set.counters(state["faults"]).items():
                load_stats[f"fault_{nm}_injected"] = cnt
        if "agg_stats" in state:
            for s in self.aggregator.stat_names:
                load_stats[f"agg_{s}"] = float(state["agg_stats"][s])
        if "defense" in state:
            load_stats.update(self.defense.report(state["defense"]))
            if "tier_acc" in state:
                from repro_torch.topo.reduce import tier_suspect_counts

                load_stats["tier_suspects"] = tier_suspect_counts(
                    self.topo, self.cfg.n_clients,
                    state["defense"]["status"].cpu().numpy(),
                )
        fault_exposure = None
        if "faults" in state and self.cfg.fault_exposure:
            fault_exposure = self.fault_set.exposure(state["faults"])
        return RunResult(
            config=self.cfg,
            records=records,
            selection=sel_hist,
            load_stats=load_stats,
            wall_stats=None,
            params=state["params"],
            wall_time_s=wall_time_s,
            fault_exposure=fault_exposure,
            defense=(self.defense.arrays(state["defense"])
                     if "defense" in state else None),
        )


def _make_round_core(task: FLTask, cfg: RunConfig, policy: Policy,
                     agg: Aggregator, aggregate=None, faults=None, defense=None,
                     cohort=None):
    """The per-round function ``round_fn(params, sched_state, draws,
    fstate=None, dstate=None) -> (params, sched_state, selected, mean_loss,
    fstate, dstate, agg_telemetry)``, shared by the engine's chunk loop and the legacy
    ``fl.rounds.make_round_fn``.

    ``draws`` is the round's source: the policy draws at ``select``, the
    local update one ``local_perm`` stream per cohort slot over all
    ``width`` slots, padding included (the reference's
    ``split(k_local, width)``).

    ``faults`` (a ``repro_torch.faults.FaultSet``) threads the fault state
    through the round, drawing from ``draws.sub("faults")`` (the
    reference's fold 105 off ``k_sel``: sub-fold 1 for ``on_pop``, 2 for
    the corruption noise); with no faults armed nothing is drawn there and
    the round is the faultless one.

    ``aggregate(params, updates, bases, w, idx) -> (params, stats)``
    replaces the inline ``init/accumulate/finalize`` chain (the engine
    passes ``topo.reduce.tiered_apply`` under a multi-tier topology).

    ``defense`` (a ``repro_torch.defense.Defense``) mirrors the async seams,
    drawing from ``draws.sub("defense")`` (the reference's fold 108 off
    ``k_sel``): quarantined clients are masked out of ``selected`` right
    after the policy step, every surviving slot is scored with staleness
    identically zero, and post-transition suspects lose their weight.

    ``cohort`` (an ``engine.sharded.CohortSplit``) is the cohort-parallel
    seam (the reference's ``cohort_layout``/``cohort_shards``): the cohort
    is padded with weight-0 slots to a multiple of the mesh, this rank
    trains its slice (the ``local_perm`` draws stay the unpadded cohort's),
    the losses — and, under corrupting faults or the defense, the updates —
    are all-gathered, and ``aggregate`` receives the slice. The fault coins
    and everything else stay ``width`` wide, so the round draws what the
    replicated round draws (the reference draws its fault coins for the
    padded cohort).
    """
    width = cfg.cohort_width() if not policy.exact_k else cfg.k
    local_update = make_local_update(
        task.loss_fn, cfg.local_epochs, cfg.batch_size, task.examples_per_client
    )
    lr_fn = exponential_decay(cfg.lr0, cfg.lr_decay)
    have_faults = faults is not None
    kill_on = have_faults and faults.has("kill")
    corrupt_on = have_faults and (faults.has("scale") or faults.has("noise"))
    collude_on = have_faults and faults.has("collude")
    if have_faults:
        from repro_torch.faults.inject import collude_updates, corrupt_updates
    if aggregate is None:
        def aggregate(g, updates, bases, w, idx=None):
            acc = agg.accumulate(agg.init(g), updates, bases, w)
            return agg.finalize(g, acc), acc_stats(acc)
    have_def = defense is not None
    mtd_on = have_def and defense.mtd
    if mtd_on:
        from repro_torch.defense.adaptive import adaptive_aggregate

        aggregate_mtd = adaptive_aggregate(aggregate, defense.cfg.mtd_trims,
                                           families=defense.cfg.mtd_families)
    col_on = have_def and defense.collusion
    sup_on = (have_def and defense.wants_labels and have_faults
              and faults.has_pop and cfg.fault_exposure)
    if sup_on:
        from repro_torch.faults.inject import effects_hit

    whole_updates = cohort is not None and (corrupt_on or collude_on or have_def)

    def round_fn(params, sched_state, draws, fstate=None, dstate=None):
        selected, sched_state = policy.step(sched_state, draws)
        if have_def:
            selected = selected & ~defense.blocked(dstate)
        idx, mask = cohort_indices(selected, width)
        if have_faults:
            fdraws = draws.sub("faults")
            fstate, eff = faults.on_pop(fstate, fdraws, idx, mask > 0)
        shards = {k: a[idx] for k, a in task.client_data.items()}
        lr = lr_fn(sched_state["round"] - 1).expand(width)
        if cohort is None:
            updated, losses = local_update(
                broadcast_to_cohort(params, width), shards, draws, lr
            )
        else:
            # this rank trains its slice of the padded cohort
            rows = cohort.rows
            updated, losses = local_update(
                broadcast_to_cohort(params, rows.shape[0]),
                {k: a[rows] for k, a in shards.items()}, draws, lr[rows],
                perm_rows=(width, rows))
            slice_updated = updated
            losses = cohort.gather(losses)
            if whole_updates:
                updated = tree_map(cohort.gather, updated)
        if corrupt_on:
            updated = corrupt_updates(updated, params, eff, fdraws,
                                      faults.has("scale"), faults.has("noise"))
        if collude_on:
            # after corrupt: the coalition's replacement is authoritative
            updated = collude_updates(updated, params, eff)
        valid = mask > 0
        if kill_on:
            # a dropped client's update never reaches the server: weight 0
            valid = valid & ~eff.kill
        if have_def:
            # staleness is identically zero in a sync round
            ages = sched_state["ages"][idx] if "ages" in sched_state else None
            new_dstate, suspect, w_scale = defense.observe(
                dstate, draws.sub("defense"),
                updated, params, idx, valid, torch.zeros_like(idx),
                losses=losses, ages=ages,
                labels=effects_hit(eff) if sup_on else None,
            )
            valid = valid & ~suspect[idx]
        # sync cohorts are never stale: staleness is identically zero
        w = agg.weigh(valid, torch.zeros_like(idx))
        if col_on:
            # exact 1.0 on clique-free slots: calm armed rounds multiply
            # the weights by ones
            w = w * w_scale
        if cohort is not None:
            # the aggregate hook merges this rank's slice with the others'
            if whole_updates:
                slice_updated = tree_map(lambda u: u[cohort.rows], updated)
            params, tel = aggregate(params, slice_updated, params,
                                    cohort.slot_weights(w), idx[cohort.rows])
        elif mtd_on:
            params, tel = aggregate_mtd(params, updated, params, w, idx,
                                        defense.step_level(dstate, new_dstate))
        else:
            params, tel = aggregate(params, updated, params, w, idx)
        wsum = w.sum()
        # NaN, not a fake near-0 datapoint, when nobody was selected
        mean_loss = torch.where(wsum > 0,
                                torch.sum(losses * w) / torch.clamp(wsum, min=1.0),
                                torch.full_like(wsum, float("nan")))
        return (params, sched_state, selected, mean_loss, fstate,
                new_dstate if have_def else dstate, tel)

    return round_fn
