"""The buffered asynchronous engine over the event-driven fleet simulator.

One server step = admission control (idle+available clients consult their
selection policy — the Markov chain decides *locally* whether to pull the
model, preserving the paper's zero-coordination property) -> dispatch with
sampled wall-clock latencies -> pop the next ``buffer_size`` completions
(the ``event_topk`` CUDA kernel at fleet scale) -> local training of the
whole cohort, each member from its *dispatch-time* model version (a ring of
the last ``max_versions`` global models) -> aggregator
``weigh/init/accumulate/finalize`` over the buffered deltas -> clock/
version advance.

This is ``repro.engine.async_engine``; ``engine.sharded`` runs the same
step over a fleet mesh of ranks through its fleet seam. The robustness
tier, the aggregation topology and the adaptive defense ride the step as
in the reference, under the same structural
rule: faults, the deadline re-dispatch, a multi-tier topology, a heartbeat
and the defense, when armed, add their state to the engine state and draw
from their own sub-streams of the run's source (``faults``,
``redispatch``, ``hop``, ``defense``); absent, no state key, no draw and no
op exists, so the engine is the calm one, and a star topology is no
topology bit for bit. Every tensor of the state lives on the task's device
and no step syncs with the host: masked scatters go through
``sim.events.scatter_set``, and the only host pulls are the per-chunk aux
transfer, ``finalize`` and the moving-target defense's level.

**Host reads of the mtd level.** The reference picks the mtd rung inside
its jitted step from the level on the device. Here the rung is chosen in
Python, and the rule is: ``observe`` advances the window counter ``win``
by one every step and changes ``level`` only on the step that closes a
window, so the host tracks ``win`` itself (read once from a state the
engine did not make: a restored checkpoint) and reads ``level`` from the
device once, on each step that closes a window, after ``observe`` and
before the aggregation that uses it. An mtd run therefore makes one host
read per ``mtd_window`` steps; a run without mtd makes none
(``Defense.step_level``).

The load metric is reported on two clocks: X in decision epochs (the
paper's round-indexed Var[X]) and X in simulated seconds (wall-clock
inter-update gaps per client).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.aoi import age_update, peak_age_accumulate
from repro_torch.core.draws import GeneratorDraws
from repro_torch.core.fleet import whole
from repro_torch.core.load_metric import (
    empirical_load_stats,
    init_selection_accum,
    selection_stats_from_accum,
    tier_stats_from_accum,
)
from repro_torch.core.selection import Policy
from repro_torch.core.tree import tree_map
from repro_torch.engine.aggregators import Aggregator, acc_stats
from repro_torch.engine.chunk import ChunkRunner, step_once
from repro_torch.engine.config import RoundRecord, RunConfig, RunResult
from repro_torch.engine.registry import make_aggregator, make_policy
from repro_torch.fl.client import make_local_update
from repro_torch.fl.task import FLTask
from repro_torch.optim.schedules import exponential_decay
from repro_torch.sim import events as ev_mod
from repro_torch.sim import latency as lat_mod


def _resolved_profile(profile) -> lat_mod.LatencyProfile:
    if isinstance(profile, lat_mod.LatencyProfile):
        return profile
    return lat_mod.get_profile(profile)


def _init_stats(device, heartbeat: bool = False, redispatch: bool = False,
                agg_stats: tuple = ()) -> Dict[str, torch.Tensor]:
    def z():
        return torch.zeros((), dtype=torch.float32, device=device)

    out = {
        "wall_sx": z(), "wall_sx2": z(), "wall_cnt": z(),  # X in simulated seconds
        "ep_sx": z(), "ep_sx2": z(), "ep_cnt": z(),  # X in decision epochs
        "stale_sum": z(), "stale_cnt": z(),
        "stale_max": torch.zeros((), dtype=torch.int32, device=device),
        "updates": z(),  # successful updates aggregated
        "aggs": z(),  # server versions produced
    }
    if heartbeat:
        out["hb_expired"] = z()  # updates excluded by heartbeat churn
    if redispatch:
        out["redispatched"] = z()  # expired dispatches re-issued
        out["rd_expired"] = z()  # deadline expiries (incl. written off)
    for s in agg_stats:
        out[f"agg_{s}"] = z()  # aggregator telemetry (e.g. norm_clip)
    return out


class AsyncEngine:
    """Asynchronous server steps: one buffer flush per step, clients train
    from (possibly stale) ring-buffered model versions.

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
        if cfg.mode != "async":
            raise ValueError(f"AsyncEngine needs mode='async', got {cfg.mode!r}")
        self.task = task
        self.cfg = cfg
        self.policy = policy or make_policy(
            cfg.policy, cfg.n_clients, cfg.k, cfg.m, **dict(cfg.policy_kwargs)
        )
        self.aggregator = aggregator or make_aggregator(
            cfg.resolved_aggregator(), **dict(cfg.aggregator_kwargs)
        )
        self.profile = _resolved_profile(cfg.profile)
        self.draws = draws if draws is not None else GeneratorDraws(cfg.seed,
                                                                    task.device)
        self.topo = cfg.resolved_topology()
        self.fault_set = cfg.resolved_faults()
        self.defense_cfg = cfg.resolved_defense()
        if self.defense_cfg is not None:
            from repro_torch.defense import make_defense

            self.defense = make_defense(cfg.n_clients, self.defense_cfg)
        else:
            self.defense = None
        self._init_state, core = self._build_step()
        self._chunk = ChunkRunner(
            core, aux_keys=("loss", "clock", "version", "buffer_fill"),
            layout=self._layout(),
        )

    def _build_step(self):
        """``(init_state, step)`` of this engine (``engine.sharded``
        passes its fleet seam)."""
        return _make_async_step(
            self.task, self.cfg, self.policy, self.aggregator, self.profile,
            topo=self.topo, faults=self.fault_set, defense=self.defense,
        )

    def _layout(self):
        """The fleet layout of the state's ``(n,)`` leaves (None: whole)."""
        return None

    def init(self) -> Dict:
        cfg, d = self.cfg, self.draws
        params = self.task.init(d)
        sched = self.policy.init(d, cfg.n_clients)
        state = self._init_state(params, sched, d)
        state["load_acc"] = init_selection_accum(cfg.n_clients, cfg.k,
                                                 self.task.device)
        return state

    def step(self, state: Dict, r: int):
        return step_once(self._chunk, state, self.draws, r)

    def run_chunk(self, state: Dict, r0: int, length: int, with_history: bool):
        return self._chunk(state, self.draws, r0, length, with_history)

    def eval_params(self, state: Dict):
        return state["params"]

    def ring_snapshot(self, state: Dict):
        """The retained-version ring for the serving tier
        (``repro_torch.serve.VersionStore``): ``(hist, version,
        max_versions)``, the state's own tensors by reference: no copy and
        no host read, so serving reads versions without synchronizing
        training."""
        return state["hist"], state["version"], self.cfg.max_versions

    def evaluate(self, state: Dict) -> Dict:
        """Held-out eval on the current global params."""
        return self.task.eval_fn(self.eval_params(state))

    def record(self, r: int, aux: Dict, ev: Dict) -> RoundRecord:
        return RoundRecord(
            round=r + 1,
            train_loss=float(aux["loss"]),
            eval_loss=float(ev["loss"]),
            accuracy=float(ev["accuracy"]),
            clock=float(aux["clock"]),
            version=int(aux["version"]),
            buffer_fill=int(aux["buffer_fill"]),
        )

    def _topo_tag(self) -> str:
        if self.topo is None or self.topo.is_star:
            return ""
        return f"/{self.topo.describe()}"

    def progress_line(self, rec: RoundRecord, elapsed: float) -> str:
        return (
            f"  [{self.policy.name}/{self.profile.name}{self._topo_tag()}] "
            f"step {rec.round:4d} t={rec.clock:9.2f}s v={rec.version:4d} "
            f"acc={rec.accuracy:.4f} loss={rec.eval_loss:.4f} ({elapsed:.1f}s)"
        )

    def finalize(self, state, records, sel_hist, wall_time_s) -> RunResult:
        st = {k: float(v) for k, v in state["stats"].items()}

        def _mv(sx, sx2, cnt):
            if cnt <= 0:
                return float("nan"), float("nan")
            mean = sx / cnt
            return mean, max(sx2 / cnt - mean * mean, 0.0)

        mean_w, var_w = _mv(st["wall_sx"], st["wall_sx2"], st["wall_cnt"])
        mean_e, var_e = _mv(st["ep_sx"], st["ep_sx2"], st["ep_cnt"])
        wall_stats = {
            "mean_X_wall": mean_w, "var_X_wall": var_w,
            "num_samples_wall": int(st["wall_cnt"]),
            "mean_X_epoch": mean_e, "var_X_epoch": var_e,
            "num_samples_epoch": int(st["ep_cnt"]),
            "mean_staleness": st["stale_sum"] / max(st["stale_cnt"], 1.0),
            "max_staleness": int(st["stale_max"]),
            "updates_applied": int(st["updates"]),
            "aggregations": int(st["aggs"]),
            "sim_time": float(state["clock"]),
        }
        if "hb_expired" in st:
            wall_stats["hb_expired"] = int(st["hb_expired"])
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
        if "redispatched" in st:
            load_stats["redispatched"] = int(st["redispatched"])
            load_stats["rd_expired"] = int(st["rd_expired"])
        for s in self.aggregator.stat_names:
            load_stats[f"agg_{s}"] = float(st[f"agg_{s}"])
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
            wall_stats=wall_stats,
            params=state["params"],
            wall_time_s=wall_time_s,
            fault_exposure=fault_exposure,
            defense=(self.defense.arrays(state["defense"])
                     if "defense" in state else None),
        )


def _make_async_step(task: FLTask, cfg: RunConfig, policy: Policy,
                     agg: Aggregator, profile: lat_mod.LatencyProfile,
                     aggregate=None, topo=None, faults=None, defense=None,
                     layout=None, cohort=None):
    """Builds ``(init_state, step)`` with ``step(state, draws) -> (state,
    aux)``, the function ``ChunkRunner`` loops over; ``draws`` is the
    source of this step's draws.

    ``layout`` (a ``core.fleet`` layout; None: the one-device
    ``WholeFleet``) is the fleet seam, the port's form of the reference's
    hooks ``pop`` and ``constrain_state``: every read or write of an
    ``(n,)`` leaf — the policy step, the fleet-wide draws, the pop, the
    gathers at the popped indices, the masked scatters and the fleet sums —
    goes through it. Under ``engine.sharded``'s ``BlockFleet`` each rank
    holds its block of those leaves and everything cohort-sized is
    replicated, so the step is the single engine's bit for bit.

    ``cohort`` (an ``engine.sharded.CohortSplit``, the cohort-parallel mode
    of ``RunConfig.shard_cohort``; the reference's ``cohort_layout`` and
    ``cohort_pad``) splits the training and the aggregation over the mesh:
    the cohort is padded with zero-weight slots to a multiple of the mesh,
    this rank trains its slice of it, and ``aggregate`` receives the slice
    (``aggregators.cohort_sharded_apply`` or ``tiered_apply(mesh=...)``
    merge the slices' accumulators). Everything else — the pop, the fault
    coins, the weights, the telemetry — stays B wide, so the run draws what
    the replicated run draws; the slot outputs that a later stage reads
    whole (the losses; the updates and their bases under corrupting faults
    or the defense) are all-gathered.

    ``aggregate(params, updates, bases, w, idx) -> (params, stats)``
    replaces the inline ``init/accumulate/finalize`` chain (``idx`` is the
    cohort -> client map, which the tiered reduction uses to route each
    slot to its tier-0 node); by default it is that chain, or
    ``topo.reduce.tiered_apply`` under a multi-tier topology.

    ``topo`` (a ``repro_torch.topo.Topology``) reshapes the aggregation as
    in the reference: the default aggregate becomes the tiered reduction,
    every dispatch pays the per-hop DAG latency drawn from the ``hop``
    sub-stream (the reference's fold 104; a re-dispatch's from
    ``redispatch/hop``, its fold 107), the per-tier load accumulators ride
    the state, and a non-zero ``heartbeat_timeout`` excludes dark clients
    from the reduction. A star (or ``topo=None``) leaves every state key,
    draw and op untouched; a star with a heartbeat arms only the heartbeat.

    ``faults`` (a ``repro_torch.faults.FaultSet``) and a non-zero
    ``cfg.redispatch_timeout`` follow the reference's structural gating:
    armed, they add their ``(n,)`` state and draw from dedicated
    sub-streams (``faults``: the reference's fold 105 with sub-folds
    0 dispatch / 1 pop / 2 corruption noise; ``redispatch``: its folds
    106/107); absent, no state key, no draw and no op exists.

    ``defense`` (a ``repro_torch.defense.Defense``) closes the detect ->
    quarantine -> adapt loop inside this same step under the same rule:
    armed, it adds its ``(n,)`` reputation/status state, draws its
    probation/readmit coins from the ``defense`` sub-stream (the
    reference's fold 108), vetoes quarantined clients at the admission seam
    (``send &= ~blocked``; they still age), scores every update that
    arrived (probation clients included), excludes post-transition suspects
    at the aggregation seam (``succ &= ~suspect`` — the seam heartbeat dark
    clients use), discounts clique members' weights (``w *= w_scale``) with
    collusion armed, and with mtd swaps the aggregate hook for the
    moving-target wrapper at the level ``Defense.step_level`` gives.
    """
    n = cfg.n_clients
    B = cfg.resolved_buffer_size()
    H = cfg.max_versions
    dev = task.device
    lay = whole(layout, n)
    # the policy takes the layout only when sharded, so a plugin policy
    # with the two-argument step runs on one device as before
    pol_kw = {"layout": layout} if lay.sharded else {}
    tiered = topo is not None and not topo.is_star
    hb_timeout = float(topo.heartbeat_timeout) if topo is not None else 0.0
    have_faults = faults is not None
    rd_on = (cfg.redispatch_timeout or 0) > 0
    kill_on = have_faults and faults.has("kill")
    corrupt_on = have_faults and (faults.has("scale") or faults.has("noise"))
    collude_on = have_faults and faults.has("collude")
    replay_on = have_faults and faults.has("replay")
    if have_faults:
        from repro_torch.faults.inject import collude_updates, corrupt_updates
    have_def = defense is not None
    col_on = have_def and defense.collusion
    mtd_on = have_def and defense.mtd
    # supervised labels for the learned detector head: only when the run
    # opted into exposure ground truth AND some fault actually pops
    sup_on = (have_def and defense.wants_labels and have_faults
              and faults.has_pop and cfg.fault_exposure)
    if sup_on:
        from repro_torch.faults.inject import effects_hit
    if tiered:
        from repro_torch.core.load_metric import (
            init_tier_accum,
            tier_blocks,
            update_tier_accum,
        )
        from repro_torch.topo.reduce import make_hop_latency, tiered_apply

        assign = topo.assign(n)
        # this rank's block of the client -> tier-0 map (the whole map on
        # one device), its table over all E nodes
        blocks = tier_blocks(assign[lay.lo:lay.lo + lay.local_n], dev,
                             num_groups=int(topo.tier_sizes[0]))
        hop_fn = make_hop_latency(topo, n)
    if hb_timeout > 0 or rd_on:
        # re-dispatch deadlines reuse the heartbeat liveness predicate:
        # "no completion for longer than the timeout" is the same signal
        from repro_torch.topo import heartbeat as hb_mod
    if aggregate is None:
        if tiered:
            aggregate = tiered_apply(agg, topo, n)
        else:
            def aggregate(g, updates, bases, w, idx=None):
                acc = agg.accumulate(agg.init(g), updates, bases, w)
                return agg.finalize(g, acc), acc_stats(acc)
    if mtd_on:
        # config rejects mtd under tiered topologies, so the wrapped hook
        # is always the inline default; level 0 returns its params as is
        from repro_torch.defense.adaptive import adaptive_aggregate

        aggregate_mtd = adaptive_aggregate(aggregate, defense.cfg.mtd_trims,
                                           families=defense.cfg.mtd_families)
    local_update = make_local_update(
        task.loss_fn, cfg.local_epochs, cfg.batch_size, task.examples_per_client
    )
    lr_fn = exponential_decay(cfg.lr0, cfg.lr_decay)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    # cohort-parallel: stages that read every slot's update see the whole
    # cohort, all-gathered from the slices
    whole_updates = cohort is not None and (corrupt_on or collude_on or have_def)

    def init_state(params, sched_state, draws):
        state = {
            "params": params,
            # ring buffer of the last H global models; slot v % H = version v
            "hist": tree_map(
                lambda p: p[None].expand((H,) + p.shape).clone(), params
            ),
            "sched": sched_state,
            "ev": ev_mod.init_event_state(n, dev),
            "speed": lat_mod.client_speed(draws, n, profile),
            "clock": torch.zeros((), dtype=torch.float32, device=dev),
            "version": torch.zeros((), dtype=torch.int32, device=dev),
            "stats": _init_stats(dev, heartbeat=hb_timeout > 0, redispatch=rd_on,
                                 agg_stats=agg.stat_names),
        }
        if hb_timeout > 0:
            state["hb"] = hb_mod.init_heartbeat(n, dev)
        if tiered:
            state["tier_acc"] = init_tier_accum(n, int(topo.tier_sizes[0]), dev)
        if have_faults:
            state["faults"] = faults.init(draws.sub("faults"))
        if have_def:
            state["defense"] = defense.init(dev)  # deterministic zeros
        if rd_on:
            state["rd"] = {
                "t_disp": torch.zeros((n,), dtype=torch.float32, device=dev),
                "retries": torch.zeros((n,), dtype=torch.int32, device=dev),
            }
        return state

    def step(state, draws):
        ev, sched, stats = state["ev"], state["sched"], state["stats"]
        clock, version = state["clock"], state["version"]

        # --- admission control: idle+available clients consult the policy
        prev_ages = sched["ages"]
        idle = torch.isinf(ev["t_done"])
        available = ev["next_avail"] <= clock
        want, sched = policy.step(sched, draws, **pol_kw)
        send = want & idle & available
        if have_def:
            # quarantined clients are vetoed at the admission seam (they
            # still age); probation clients stay selectable so they keep
            # generating evidence for re-admission
            dstate = state["defense"]
            send = send & ~defense.blocked(dstate)
        # only actual dispatches reset the AoI clock; everyone else ages
        sched = {**sched, "ages": age_update(prev_ages, send)}
        ep_sx, ep_sx2, ep_cnt = peak_age_accumulate(
            prev_ages, send, stats["ep_sx"], stats["ep_sx2"], stats["ep_cnt"],
            layout)

        # --- dispatch: sample wall-clock latencies, mark in flight
        latency = lat_mod.sample_latency(draws, profile, state["speed"], layout)
        if tiered:
            # per-hop DAG latency, only when a multi-tier topology is armed
            latency = latency + lay.block(hop_fn(draws.sub("hop")))
        if have_faults:
            fstate = state["faults"]
            fdraws = draws.sub("faults")
            if faults.has_dispatch:
                fstate, latency = faults.on_dispatch(fstate, fdraws, send,
                                                     latency, layout)
        if hb_timeout > 0:
            # dispatch is a heartbeat: the client pulled the model now
            hb = hb_mod.beat(state["hb"], send, clock)
        dropped = lat_mod.sample_dropout(draws, profile, n, layout)
        ev = ev_mod.schedule_completions(ev, send, clock, latency, version, dropped)

        # --- deadline-based re-dispatch of expired in-flight dispatches:
        # a dispatch the server has not heard back from within the
        # timeout is re-issued at the current version with a fresh
        # latency (the redispatch sub-stream), at most
        # redispatch_retries times — then written off (t_done=inf frees
        # the client to be selected again). The original dispatch's
        # dropout coin is kept: a retry re-attempts delivery, not the
        # client's fate.
        if rd_on:
            rd_t = torch.where(send, clock, state["rd"]["t_disp"])
            rd_cnt = torch.where(send, 0, state["rd"]["retries"])
            inflight = ~torch.isinf(ev["t_done"])
            exp = inflight & hb_mod.expired(rd_t, clock,
                                            float(cfg.redispatch_timeout))
            retry = exp & (rd_cnt < cfg.redispatch_retries)
            give_up = exp & ~retry
            rd_draws = draws.sub("redispatch")
            rd_lat = lat_mod.sample_latency(rd_draws, profile, state["speed"],
                                            layout)
            if tiered:
                rd_lat = rd_lat + lay.block(hop_fn(rd_draws.sub("hop")))
            ev = {
                **ev,
                "t_done": torch.where(
                    retry, clock + rd_lat,
                    torch.where(give_up, torch.inf, ev["t_done"]),
                ),
                "disp_ver": torch.where(retry, version, ev["disp_ver"]),
            }
            rd = {
                "t_disp": torch.where(retry, clock, rd_t),
                "retries": rd_cnt + retry.to(torch.int32),
            }
            rd_retried = lay.psum(retry.to(torch.float32).sum())
            rd_expired = lay.psum(exp.to(torch.float32).sum())

        # --- pop the next B completions, advance the simulated clock
        t_ev, idx, valid, ev = lay.pop(ev, B, use_kernel=cfg.use_kernel)
        if have_faults and faults.has_pop:
            fstate, eff = faults.on_pop(fstate, fdraws, idx, valid, layout)
        new_clock = torch.maximum(
            clock, torch.max(torch.where(valid, t_ev, neg_inf))
        )
        # an all-idle fleet inside availability gaps must not freeze the
        # clock: with nothing in flight to pop, jump to the earliest
        # window opening so availability can recover next step
        new_clock = torch.where(
            valid.any(), new_clock,
            torch.maximum(new_clock, lay.pmin(torch.min(ev["next_avail"]))),
        )

        # --- local training from each client's dispatch-time model
        disp_ver = lay.gather(ev["disp_ver"], idx)
        # versions older than the ring are trained from the oldest retained
        # model; staleness for weighting still uses the true dispatch version
        oldest = torch.clamp(version - (H - 1), min=0)
        read_ver = torch.clamp(disp_ver, min=oldest, max=version)
        if replay_on:
            # stale replay: hit slots read an older retained version than
            # they were dispatched (shift 0 elsewhere is exact identity on
            # ints); the staleness *weight* below still sees the honest
            # dispatch version — precisely the attack
            read_ver = torch.maximum(read_ver - eff.replay_shift, oldest)
        slot = (read_ver % H).long()
        shards = {k: lay.gather(a, idx) for k, a in task.client_data.items()}
        lr = lr_fn(torch.clamp(disp_ver, min=0))
        if cohort is None:
            disp_params = tree_map(lambda h: h[slot], state["hist"])
            updated, losses = local_update(disp_params, shards, draws, lr)
        else:
            # this rank trains its slice of the padded cohort (a padded
            # slot repeats the last real one; its weight is 0)
            rows = cohort.rows
            disp_params = tree_map(lambda h: h[slot[rows]], state["hist"])
            updated, losses = local_update(
                disp_params, {k: a[rows] for k, a in shards.items()}, draws,
                lr[rows], perm_rows=(B, rows))
            slice_updated, slice_bases = updated, disp_params
            losses = cohort.gather(losses)
            if whole_updates:
                updated = tree_map(cohort.gather, updated)
                disp_params = tree_map(lambda h: h[slot], state["hist"])
        if corrupt_on:
            # missed slots keep their exact values (per-slot where inside
            # corrupt_updates), so a rate-0 set is bitwise identity
            updated = corrupt_updates(updated, disp_params, eff, fdraws,
                                      faults.has("scale"), faults.has("noise"))
        if collude_on:
            # after corrupt: a coalition member's replacement is
            # authoritative over any scale/noise it also drew
            updated = collude_updates(updated, disp_params, eff)

        # --- buffered aggregation of deltas through the aggregator seam
        succ = valid & ~lay.gather(ev["dropped"], idx)
        if kill_on:
            # mid-round dropout: the update never arrived
            succ = succ & ~eff.kill
        if hb_timeout > 0:
            # an update landing more than the timeout after its client's
            # last contact looks dead to its tier coordinator: excluded
            # like a dropped slot. Every arrival still counts as contact
            dark = succ & hb_mod.expired(lay.gather(hb["last_beat"], idx), t_ev,
                                         hb_timeout)
            succ = succ & ~dark
            arrived = valid & ~eff.kill if kill_on else valid
            hb = hb_mod.beat_at(hb, idx, arrived, t_ev, layout)
        staleness = torch.clamp(version - disp_ver, min=0)
        if have_def:
            # every update that arrived (pre-exclusion succ) is scored —
            # probation clients included — then post-transition suspects
            # leave the reduction through the seam heartbeat dark clients
            # use, closing the detect->quarantine loop within the step
            new_dstate, suspect, w_scale = defense.observe(
                dstate, draws.sub("defense"),
                updated, disp_params, idx, succ, staleness,
                losses=losses, ages=lay.gather(sched["ages"], idx),
                labels=effects_hit(eff) if sup_on else None, layout=layout,
            )
            succ = succ & ~lay.gather(suspect, idx)
        w = agg.weigh(succ, staleness)
        if col_on:
            # clique members keep a (discounted) vote rather than a
            # binary exclusion: w_scale is exact 1.0 on clique-free
            # slots, so a calm armed run multiplies by ones
            w = w * w_scale
        wsum = w.sum()
        has = wsum > 0
        denom = torch.clamp(wsum, min=1e-9)
        if cohort is not None:
            # the aggregate hook merges this rank's slice with the others'
            if whole_updates:
                slice_updated = tree_map(lambda u: u[cohort.rows], updated)
                slice_bases = tree_map(lambda b: b[cohort.rows], disp_params)
            params, agg_tel = aggregate(state["params"], slice_updated,
                                        slice_bases, cohort.slot_weights(w),
                                        idx[cohort.rows])
        elif mtd_on:
            params, agg_tel = aggregate_mtd(
                state["params"], updated, disp_params, w, idx,
                defense.step_level(dstate, new_dstate))
        else:
            params, agg_tel = aggregate(state["params"], updated, disp_params, w, idx)
        version = version + has.to(torch.int32)
        wslot = (version % H).long().view(1)
        hist = tree_map(lambda h, p: h.index_copy(0, wslot, p[None]),
                        state["hist"], params)
        # NaN, not a fake 0.0 datapoint, when nothing was aggregated
        mean_loss = torch.where(has, torch.sum(losses * w) / denom,
                                torch.full_like(denom, float("nan")))

        # --- completed clients go idle; wall-clock AoI samples
        # gaps are i.i.d. — draw only the B popped clients' worth
        gaps = lat_mod.sample_avail_gap(draws, profile, B)
        ev = {**ev, "next_avail": lay.scatter_set(
            ev["next_avail"], idx, valid, new_clock + gaps)}
        last_done = lay.gather(ev["last_done"], idx)
        x_wall = t_ev - last_done
        wall_ok = succ & (last_done >= 0.0)
        ev = {**ev, "last_done": lay.scatter_set(
            ev["last_done"], idx, succ, t_ev)}

        zero = torch.zeros((), dtype=torch.float32, device=dev)
        succ_f = succ.to(torch.float32)
        stats = {
            "wall_sx": stats["wall_sx"] + torch.sum(torch.where(wall_ok, x_wall, zero)),
            "wall_sx2": stats["wall_sx2"]
            + torch.sum(torch.where(wall_ok, x_wall**2, zero)),
            "wall_cnt": stats["wall_cnt"] + wall_ok.to(torch.float32).sum(),
            "ep_sx": ep_sx, "ep_sx2": ep_sx2, "ep_cnt": ep_cnt,
            "stale_sum": stats["stale_sum"]
            + torch.sum(torch.where(succ, staleness, 0).to(torch.float32)),
            "stale_cnt": stats["stale_cnt"] + succ_f.sum(),
            "stale_max": torch.maximum(
                stats["stale_max"], torch.max(torch.where(succ, staleness, 0))
            ),
            "updates": stats["updates"] + succ_f.sum(),
            "aggs": stats["aggs"] + has.to(torch.float32),
        }
        if hb_timeout > 0:
            stats["hb_expired"] = (state["stats"]["hb_expired"]
                                   + dark.to(torch.float32).sum())
        if rd_on:
            stats["redispatched"] = state["stats"]["redispatched"] + rd_retried
            stats["rd_expired"] = state["stats"]["rd_expired"] + rd_expired
        for s in agg.stat_names:
            stats[f"agg_{s}"] = state["stats"][f"agg_{s}"] + agg_tel[s]
        new_state = {
            **state,
            "params": params, "hist": hist, "sched": sched, "ev": ev,
            "clock": new_clock, "version": version, "stats": stats,
        }
        if hb_timeout > 0:
            new_state["hb"] = hb
        if have_faults:
            new_state["faults"] = fstate
        if have_def:
            new_state["defense"] = new_dstate
        if rd_on:
            new_state["rd"] = rd
        if tiered:
            new_state["tier_acc"] = update_tier_accum(state["tier_acc"], send,
                                                      blocks, layout)
        aux = {
            "send": send,
            "loss": mean_loss,
            "buffer_fill": valid.to(torch.int32).sum(),
            "clock": new_clock,
            "version": version,
        }
        return new_state, aux

    return init_state, step
