"""Asynchronous federated training driver of the port — the paper's
experiment under wall-clock heterogeneity (stragglers, dropouts,
availability windows), on the GPU.

The same flags and report as ``repro.launch.fl_async``, plus ``--device``:
clients that become available consult their selection policy (admission
control), train on the model version they pulled, and the server
aggregates a buffer of updates per step through the configured aggregator
(staleness-discounted ``fedbuff`` by default). Fleets of 16384 clients and
more pop their buffer through the ``event_topk`` CUDA kernel.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.fl_async --policy markov \\
      --rounds 40 --clients 200
  PYTHONPATH=src python -m repro_torch.launch.fl_async --dataset mnist \\
      --data-scale 5 --clients 16384 --k 256 --rounds 20   # fleet scale, K2
  PYTHONPATH=src python -m repro_torch.launch.fl_async --device cpu \\
      --clients 20 --k 4 --rounds 4 --data-scale 0.05     # CPU smoke run
  PYTHONPATH=src python -m repro_torch.launch.fl_async --faults dropout,corrupt \\
      --fault-rate 0.1 --robust-agg trimmed_mean \\
      --redispatch-timeout 30         # chaos run with graceful degradation
  PYTHONPATH=src python -m repro_torch.launch.fl_async --topology hierarchical \\
      --tiers 64,8 --heartbeat-timeout 300 --clients 16384 --k 256 \\
      --data-scale 5 --rounds 20      # edge -> regional -> global, K1 tiers
  PYTHONPATH=src python -m repro_torch.launch.fl_async --faults scale_attack \
      --fault-rate 0.25 --defense --quarantine-threshold 0.55 \
      --mtd-window 8 --collusion      # reputation, quarantine, moving target
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core import load_metric
from repro_torch.engine import make_engine, run_engine
from repro_torch.launch._fl_cli import (
    add_common_args,
    build_run_config,
    build_task,
    print_defense_stats,
    print_robustness_stats,
    print_tier_stats,
    run_world,
    spawn_ranks,
    write_result,
)
from repro_torch.sim import PROFILES

# async default: frequent small local updates (FedBuff-style) — with
# per-client shards this small, 5 epochs at lr 0.1 diverges
DEFAULTS = {
    "rounds": 40, "clients": 200, "local_epochs": 2, "lr": 0.05,
    "rounds_help": "server steps (buffer flushes)",
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    add_common_args(ap, DEFAULTS)
    ap.add_argument("--buffer-size", type=int, default=None,
                    help="updates aggregated per server step (default k)")
    ap.add_argument("--latency-profile", default="lognormal",
                    choices=sorted(PROFILES))
    ap.add_argument("--staleness-weight", type=float, default=0.5,
                    help="polynomial discount exponent a in (1+s)^-a; 0 = constant")
    ap.add_argument("--max-versions", type=int, default=8)
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """The task and engine the driver runs, from parsed flags. The task is
    the engine's own: a sharded engine's holds only this rank's block of
    the client data, so the whole fleet's is freed here."""
    task = build_task(args)
    cfg = build_run_config(
        args, mode="async", eval_div=20,
        aggregator_kwargs={
            "staleness_mode": "const" if args.staleness_weight == 0 else "poly",
            "staleness_exp": args.staleness_weight,
        } if (args.aggregator in (None, "fedbuff", "fedprox", "norm_clip")
              and args.robust_agg in (None, "norm_clip")) else {},
        buffer_size=args.buffer_size,
        max_versions=args.max_versions,
        profile=args.latency_profile,
    )
    engine = make_engine(task, cfg)
    return engine.task, engine


def report(res, args: argparse.Namespace) -> None:
    """The driver's ``== load metric X ==`` block."""
    cfg = res.config
    ws = res.wall_stats
    print("\n== load metric X (wall clock) ==")
    print(f"simulated time: {ws['sim_time']:.2f}s over {ws['aggregations']} aggregations "
          f"({ws['updates_applied']} client updates)")
    print(f"X_wall : E[X]={ws['mean_X_wall']:.3f}s Var[X]={ws['var_X_wall']:.3f} "
          f"(samples {ws['num_samples_wall']})")
    print(f"X_epoch: E[X]={ws['mean_X_epoch']:.3f} Var[X]={ws['var_X_epoch']:.3f} "
          f"(samples {ws['num_samples_epoch']})")
    print(f"theory (sync rounds): E[X]={cfg.n_clients / cfg.k:.3f} "
          f"Var random={load_metric.random_selection_var(cfg.n_clients, cfg.k):.3f} "
          f"Var markov*={load_metric.optimal_var(cfg.n_clients, cfg.k, cfg.m):.3f}")
    print(f"staleness: mean={ws['mean_staleness']:.2f} max={ws['max_staleness']}")
    if "hb_expired" in ws:
        print(f"heartbeat churn: {ws['hb_expired']} updates expired")
    print_robustness_stats(res.load_stats)
    if res.load_stats:
        es = res.load_stats
        print(f"dispatch cohorts: mean={es['mean_cohort']:.2f} std={es['std_cohort']:.2f} "
              f"range [{es['min_cohort']}, {es['max_cohort']}]")
        print(f"X_round: E[X]={es['mean_X']:.3f} Var[X]={es['var_X']:.3f} "
              f"(samples {es['num_samples']}, "
              f"{'history' if res.selection is not None else 'accumulators'})")
    print_defense_stats(res.load_stats)
    print_tier_stats(res.load_stats)
    if res.records:
        last = res.records[-1]
        print(f"final: acc={last.accuracy:.4f} eval_loss={last.eval_loss:.4f} "
              f"(v{last.version} @ t={last.clock:.2f}s)")


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    spawned = spawn_ranks("repro_torch.launch.fl_async", argv, args)
    if spawned is not None:
        return spawned
    with run_world(args):
        task, engine = build(args)
        cfg = engine.cfg
        print(
            f"async policy={cfg.policy} profile={args.latency_profile} "
            f"n={cfg.n_clients} k={cfg.k} m={cfg.m} buffer={cfg.resolved_buffer_size()} "
            f"steps={cfg.rounds} aggregator={cfg.resolved_aggregator()} "
            f"staleness=(1+s)^-{args.staleness_weight} "
            f"chunk={cfg.resolved_steps_per_chunk()} device={task.device}"
            + (f" topology={cfg.topology_name()}" if cfg.topology else "")
        )
        res = run_engine(engine, progress=True)
        report(res, args)
        write_result(args.out, res, args)
    return res


if __name__ == "__main__":
    main()
