"""Federated training driver of the port — the paper's experiment, end to
end, on the GPU.

The same flags and report as ``repro.launch.fl_train``, plus ``--device``:
FedAvg on a synthetic MNIST/CIFAR-like dataset under a chosen selection
policy, reporting accuracy-vs-round plus the load-metric statistics
(Var[X], cohort sizes) against theory. Its defaults are the paper's
Sec. IV settings (n = 100, k = 15, m = 10, E = 5, B = 50, lr 0.1 decaying
by 0.998 per round). With the default ``fedavg`` aggregator every round's
weighted cohort sum runs through the ``fedavg_reduce`` CUDA kernel (K1).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.fl_train --dataset mnist \\
      --policy markov --rounds 60
  PYTHONPATH=src python -m repro_torch.launch.fl_train --dataset mnist \\
      --data-scale 5 --policy markov --rounds 60   # MNIST at its real size
  PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu \\
      --clients 12 --k 4 --rounds 4 --data-scale 0.02   # CPU smoke run
  PYTHONPATH=src python -m repro_torch.launch.fl_train --data-scale 5 \\
      --lr 0.02 --rounds 20 --faults scale_attack --fault-rate 0.25 \\
      --robust-agg coordinate_median     # model-replacement attack, defended
  PYTHONPATH=src python -m repro_torch.launch.fl_train --data-scale 5 \\
      --lr 0.02 --topology hierarchical --tiers 10,2   # tiered FedAvg (K1)
  PYTHONPATH=src python -m repro_torch.launch.fl_train --data-scale 5 \
      --lr 0.02 --rounds 20 --faults scale_attack --fault-rate 0.25 \
      --defense --mtd-window 2 --detector learned   # the adaptive defense
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core import load_metric
from repro_torch.engine import make_engine, run_engine
from repro_torch.fl.rounds import rounds_to_target
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

DEFAULTS = {"rounds": 60, "clients": 100, "local_epochs": 5, "lr": 0.1}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    add_common_args(ap, DEFAULTS)
    ap.add_argument("--target-acc", type=float, default=None)
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """The task and engine the driver runs, from parsed flags."""
    task = build_task(args)
    cfg = build_run_config(args, mode="sync", eval_div=30)
    return task, make_engine(task, cfg)


def report(res, args: argparse.Namespace) -> None:
    """The driver's ``== load metric X ==`` block."""
    cfg = res.config
    stats = res.load_stats
    print("\n== load metric X ==")
    print(f"empirical: E[X]={stats['mean_X']:.3f} Var[X]={stats['var_X']:.3f} "
          f"(samples {stats['num_samples']})")
    print(f"theory   : E[X]={cfg.n_clients / cfg.k:.3f} "
          f"Var random={load_metric.random_selection_var(cfg.n_clients, cfg.k):.3f} "
          f"Var markov*={load_metric.optimal_var(cfg.n_clients, cfg.k, cfg.m):.3f}")
    print(f"cohort   : mean={stats['mean_cohort']:.2f} std={stats['std_cohort']:.2f} "
          f"range [{stats['min_cohort']}, {stats['max_cohort']}]")
    print_robustness_stats(stats)
    print_defense_stats(stats)
    print_tier_stats(stats)
    if args.target_acc:
        r = rounds_to_target(res.history(), args.target_acc)
        print(f"rounds to {args.target_acc:.0%}: {r}")


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    spawned = spawn_ranks("repro_torch.launch.fl_train", argv, args)
    if spawned is not None:
        return spawned
    with run_world(args):
        task, engine = build(args)
        cfg = engine.cfg
        print(f"policy={cfg.policy} n={cfg.n_clients} k={cfg.k} m={cfg.m} "
              f"rounds={cfg.rounds} aggregator={cfg.resolved_aggregator()} "
              f"chunk={cfg.resolved_steps_per_chunk()} device={task.device}"
              + (f" topology={cfg.topology_name()}" if cfg.topology else ""))
        res = run_engine(engine, progress=True)
        report(res, args)
        write_result(args.out, res, args)
    return res


if __name__ == "__main__":
    main()
