"""Train-and-serve driver of the port: one fleet, one version ring, both
workloads, on the GPU.

The same flags and defaults as ``repro.launch.serve_fleet``, plus
``--device``. Interleaves async federated training (``AsyncEngine`` chunks
over a reduced LLM arch as the FL workload, ``fl.task.make_lm_task``) with
the continuous-batching serving loop (``repro_torch.serve``) against the
same ring of retained global versions: after every training chunk the
serving replicas re-pin against a fresh ``VersionStore`` snapshot and
answer an open-loop burst of inference traffic, every decode tick and
every join token through K5. Reports TTFT, decode tokens/s, staleness of
the served version, and Var[X] over replicas per chunk.

  PYTHONPATH=src python -m repro_torch.launch.serve_fleet --arch tinyllama-1.1b \\
      --clients 32 --k 8 --rounds 8 --replicas 2 --slots 4 --router markov
  PYTHONPATH=src python -m repro_torch.launch.serve_fleet --device cpu \\
      --rounds 2 --chunk 1 --ticks-per-chunk 4     # CPU smoke run
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core.draws import GeneratorDraws
from repro_torch.device import resolve_device
from repro_torch.engine import AsyncEngine, RunConfig, dump_json
from repro_torch.fl.task import make_lm_task
from repro_torch.models import factory
from repro_torch.serve import ReplicaPool, VersionStore, router_names, run_serve_loop
from repro_torch.sim import PROFILES, arrivals as arr_mod, get_profile


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    # --- training fleet ---
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="model zoo arch (reduced) trained federated and served")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--policy", default="markov")
    ap.add_argument("--rounds", type=int, default=8,
                    help="total async server steps")
    ap.add_argument("--chunk", type=int, default=4,
                    help="training steps per chunk (serving runs between chunks)")
    ap.add_argument("--max-versions", type=int, default=8)
    ap.add_argument("--latency-profile", default="lognormal",
                    choices=sorted(PROFILES))
    # --- serving tier ---
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent decode streams per replica")
    ap.add_argument("--router", default="markov", choices=sorted(router_names()))
    ap.add_argument("--stagger", type=int, default=1,
                    help="replica i pins version latest - i * stagger")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="mean requests per serving tick (Poisson)")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=8,
                    help="median tokens generated per request")
    ap.add_argument("--ticks-per-chunk", type=int, default=12,
                    help="serving-trace ticks issued after each training chunk")
    ap.add_argument("--crash-rate", type=float, default=0.0,
                    help="per-tick replica crash probability (replica_crash "
                         "fault; in-flight streams fail over to survivors, "
                         "the last alive replica is spared)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run on the CPU)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the driver; returns the summary dict that ``--out`` writes."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg_arch = get_arch(args.arch).reduced()
    task = make_lm_task(cfg_arch, args.clients, seq_len=32, docs_per_client=4,
                        seed=args.seed, device=dev)
    model = factory.build(cfg_arch)
    cfg = RunConfig(
        mode="async", n_clients=args.clients, k=args.k, m=args.m,
        policy=args.policy, rounds=args.rounds, local_epochs=1, batch_size=4,
        lr0=0.05, seed=args.seed, eval_every=args.rounds,
        max_versions=args.max_versions, profile=args.latency_profile,
        collect_history=False,
    )
    engine = AsyncEngine(task, cfg)
    state = engine.init()
    proc = arr_mod.from_profile(
        get_profile(args.latency_profile), args.rate, args.prompt_len, args.gen
    )
    # request lengths spread up to 2x the median generation length
    ctx = args.prompt_len + max(1, 2 * args.gen)
    pool = ReplicaPool(model, args.replicas, args.slots, ctx,
                       stagger=args.stagger, device=dev)
    serve_faults = None
    if args.crash_rate > 0:
        from repro_torch.faults import make_fault

        serve_faults = [make_fault("replica_crash", args.replicas,
                                   args.crash_rate)]
    print(f"train: arch={cfg_arch.name} n={args.clients} k={args.k} "
          f"policy={args.policy} steps={args.rounds} ring H={args.max_versions} "
          f"device={dev}")
    print(f"serve: {args.replicas} replicas x {args.slots} slots, "
          f"router={args.router}, {proc.name} rate={args.rate}/tick "
          f"prompt={args.prompt_len} gen~{args.gen}")

    # the request traces' stream (host data, on the CPU); chunk ci draws
    # the trace of step ci
    trace_draws = GeneratorDraws(args.seed, "cpu").sub("arrivals")
    reports = []
    t_start = time.time()
    for ci, r0 in enumerate(range(0, args.rounds, args.chunk)):
        length = min(args.chunk, args.rounds - r0)
        state, aux = engine.run_chunk(state, r0, length, False)
        store = VersionStore.from_engine(engine, state)
        pool.refresh(store)
        reqs = arr_mod.sample_requests(trace_draws.step(ci), proc,
                                       args.ticks_per_chunk, cfg_arch.vocab_size)
        rep = run_serve_loop(
            model, store, reqs, router=args.router, pool=pool,
            seed=args.seed + ci, faults=serve_faults,
        )
        reports.append(rep)
        loss = float(aux["loss"][-1])
        print(f"  chunk {ci}: trained to v{store.latest} "
              f"(loss {loss:.4f}) | {rep.summary()}")

    results = [r for rep in reports for r in rep.results]
    ttft = [r.ttft_ticks for r in results]
    stal = [r.staleness for r in results]
    tokens = sum(rep.tokens_out for rep in reports)
    decode_wall = sum(rep.decode_wall_s for rep in reports)
    var_x = [rep.serve_stats["var_X"] for rep in reports]
    print(f"\n== serving summary ({time.time() - t_start:.1f}s wall) ==")
    print(f"streams served: {len(results)} ({tokens} tokens, "
          f"{tokens / decode_wall if decode_wall else float('nan'):.0f} tok/s decode)")
    print(f"ttft: mean={np.mean(ttft) if ttft else float('nan'):.2f} ticks "
          f"p95={np.percentile(ttft, 95) if ttft else float('nan'):.1f}")
    print(f"staleness of served version: mean={np.mean(stal) if stal else float('nan'):.2f} "
          f"max={max(stal) if stal else 0}")
    print(f"routing Var[X] per chunk: "
          f"{', '.join(f'{v:.3f}' for v in var_x)}")
    last = reports[-1].serve_stats
    print(f"per-replica E[X]: "
          f"{', '.join(f'{v:.2f}' for v in last['replica_mean_X'])}")
    crashes = sum(rep.serve_stats["crashes"] for rep in reports)
    failed_over = sum(rep.serve_stats["failed_over"] for rep in reports)
    ring_miss = reports[-1].serve_stats["ring_miss"]
    if crashes or ring_miss:
        print(f"degradation: {crashes} replica crashes, {failed_over} "
              f"streams failed over ({pool.n_alive()}/{args.replicas} "
              f"replicas alive), {ring_miss} ring-miss reads")
    summary = {
        "cli_args": vars(args),
        "streams": len(results),
        "tokens": tokens,
        "tok_s": tokens / decode_wall if decode_wall else float("nan"),
        "ttft_ticks_mean": float(np.mean(ttft)) if ttft else float("nan"),
        "staleness_mean": float(np.mean(stal)) if stal else float("nan"),
        "staleness_max": int(max(stal)) if stal else 0,
        "serve_stats": [rep.serve_stats for rep in reports],
    }
    if args.out:
        dump_json(args.out, summary)
        print("wrote", args.out)
    return summary


if __name__ == "__main__":
    main()
