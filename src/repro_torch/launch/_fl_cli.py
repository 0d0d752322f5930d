"""CLI plumbing for the port's federated training driver.

The flags are those of ``repro.launch._fl_cli`` (plus ``--device``), so a
command line moves between the packages unchanged. The robustness tier's
flags (``--faults``, ``--fault-rate``, ``--robust-agg``,
``--redispatch-timeout``, ``--redispatch-retries``) and the topology flags
(``--topology``, ``--tiers``, ``--heartbeat-timeout``) and the defense
flags (``--defense``, ``--quarantine-threshold``, ``--mtd-window``,
``--detector``, ``--collusion``) run as in the reference, and so do
``--mesh-shards``/``--shard-cohort``: with D > 1 shards and no process
group, ``spawn_ranks`` starts D ranks of the driver (one per GPU over NCCL
on CUDA, gloo on the CPU) and rank 0 prints and returns the result.
``--rng-impl`` reaches ``RunConfig``, which raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import math
from typing import Any, Dict, Optional

from repro_torch.engine import RunConfig, dump_json, policy_names
from repro_torch.fl.task import FLTask


def add_common_args(ap: argparse.ArgumentParser, defaults: Dict[str, Any]) -> None:
    """Flags shared with the reference drivers; ``defaults`` carries the
    per-driver defaults."""
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run on "
                         "the CPU)")
    ap.add_argument("--dataset", default="mnist",
                    choices=["mnist", "cifar10", "cifar100"])
    ap.add_argument("--arch", default=None,
                    help="use a reduced LLM arch as the FL workload")
    ap.add_argument("--policy", default="markov", choices=sorted(policy_names()))
    ap.add_argument("--rounds", type=int, default=defaults["rounds"],
                    help=defaults.get("rounds_help", "training rounds"))
    ap.add_argument("--clients", type=int, default=defaults["clients"])
    ap.add_argument("--k", type=int, default=15)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--aggregator", default=None,
                    help="aggregation rule (default: fedavg sync, fedbuff "
                         "async)")
    ap.add_argument("--local-epochs", type=int, default=defaults["local_epochs"])
    ap.add_argument("--batch-size", type=int, default=50)
    ap.add_argument("--lr", type=float, default=defaults["lr"])
    ap.add_argument("--noniid", action="store_true", help="Dirichlet(0.6) label skew")
    ap.add_argument("--data-scale", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps-per-chunk", type=int, default=None,
                    help="steps advanced per host transfer; default: auto, "
                         "min(eval cadence, 64)")
    ap.add_argument("--no-history", action="store_true",
                    help="skip materializing the (rounds, n) selection "
                         "matrix; load stats come from the device-resident "
                         "accumulators")
    # --- fault injection & graceful degradation (repro_torch.faults) ---
    ap.add_argument("--faults", default=None, metavar="NAME[,NAME...]",
                    help="comma-separated fault injections from the "
                         "@register_fault registry (e.g. dropout,corrupt); "
                         "omitting the flag is bitwise the fault-free run")
    ap.add_argument("--fault-rate", type=float, default=0.05,
                    help="per-event injection probability shared by every "
                         "armed fault (default 0.05)")
    ap.add_argument("--robust-agg", default=None, metavar="NAME",
                    help="shorthand for --aggregator with a robust rule "
                         "(norm_clip | trimmed_mean | coordinate_median); "
                         "conflicts with --aggregator")
    ap.add_argument("--redispatch-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="deadline-based re-dispatch: an in-flight client "
                         "past this simulated-seconds deadline is re-sent "
                         "the current model (async engine only)")
    ap.add_argument("--redispatch-retries", type=int, default=1,
                    help="re-dispatch attempts per dispatch before the "
                         "slot is abandoned (default 1)")
    # --- aggregation topology (repro_torch.topo) ---
    ap.add_argument("--topology", default=None, metavar="NAME",
                    help="aggregation topology from the @register_topology "
                         "registry (star | hierarchical | gossip). Default: "
                         "the star, bit-for-bit identical to not passing "
                         "the flag. Multi-tier topologies need an additive "
                         "aggregator and report per-tier Var[X].")
    ap.add_argument("--tiers", default=None, metavar="E0[,E1,...]",
                    help="aggregation nodes per tier, bottom-up, e.g. "
                         "'64,8' for edge->regional->global (hierarchical) "
                         "or '8' for the peer-node count (gossip)")
    ap.add_argument("--heartbeat-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="simulated-seconds liveness timeout: updates from "
                         "clients dark for longer are excluded from their "
                         "tier's reduction (async engine only)")
    # --- adaptive defense tier (repro_torch.defense) ---
    ap.add_argument("--defense", action="store_true",
                    help="arm the adaptive defense tier: per-client EWMA "
                         "reputation scoring, quarantine with a probation "
                         "Markov chain, and exclusion of flagged clients "
                         "from selection and aggregation. Omitting the "
                         "flag is bit-for-bit identical to a defense-free "
                         "run.")
    ap.add_argument("--quarantine-threshold", type=float, default=None,
                    metavar="T",
                    help="reputation score above which a client is "
                         "quarantined (default 0.55; 'inf' arms the "
                         "scoring pipeline without ever quarantining)")
    ap.add_argument("--mtd-window", type=int, default=None, metavar="STEPS",
                    help="arm moving-target aggregation: re-decide the "
                         "trimmed-mean trim fraction from windowed attack "
                         "pressure every STEPS aggregations (needs "
                         "--defense; star topology only)")
    ap.add_argument("--detector", default=None, metavar="NAME",
                    help="per-slot anomaly detector (zscore | learned). "
                         "'learned' trains a logistic head online over the "
                         "defense telemetry and reports its running AUC "
                         "(needs --defense; default zscore)")
    ap.add_argument("--collusion", action="store_true",
                    help="arm collusion-aware scoring: per-client historical "
                         "update-direction sketches plus similarity-clique "
                         "detection of coordinated (norm-invisible) "
                         "coalitions (needs --defense)")
    # --- fleet sharding (repro_torch.engine.sharded) ---
    ap.add_argument("--mesh-shards", type=int, default=None, metavar="D",
                    help="split the async fleet state over D ranks (0 = "
                         "auto-detect); with --shard-cohort the cohort axis "
                         "(sync or async). D > 1 starts D ranks: one per "
                         "GPU on CUDA, gloo ranks on the CPU")
    ap.add_argument("--shard-cohort", action="store_true",
                    help="cohort-parallel execution: each rank trains and "
                         "accumulates its slice of the cohort (needs "
                         "--mesh-shards)")
    # the reference's JAX PRNG choice: accepted, then rejected by RunConfig
    ap.add_argument("--rng-impl", default=None)


def _driver_rank(rank: int, world: int, module: str, argv, out_path: str,
                 device: str) -> None:
    """One rank of a driver started by ``spawn_ranks``: the driver's
    ``main`` on this rank's device; rank 0 prints and saves the result."""
    import contextlib
    import importlib
    import io

    import torch

    from repro_torch.core.tree import tree_map

    argv = list(argv) + ["--device", f"cuda:{rank}" if device == "cuda" else device]
    mod = importlib.import_module(module)
    if rank == 0:
        res = mod.main(argv)
        res.params = tree_map(lambda v: v.cpu(), res.params)
        torch.save(res, out_path)
    else:
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main(argv)


def spawn_ranks(module: str, argv, args: argparse.Namespace):
    """Start the driver ``module`` on ``--mesh-shards`` ranks when D > 1
    and this process is not already one of D ranks; returns rank 0's
    ``RunResult``, or None when the run stays in this process (no mesh,
    D <= 1, or already a rank). On CUDA, D above the visible GPU count
    raises."""
    import os
    import sys
    import tempfile

    import torch

    from repro_torch.device import resolve_device
    from repro_torch.launch import ranks

    if args.mesh_shards is None:
        return None
    device = resolve_device(args.device).type
    gpus = torch.cuda.device_count() if device == "cuda" else 0
    shards = args.mesh_shards or (gpus if device == "cuda" else 1)
    dist = torch.distributed
    if shards <= 1 or (dist.is_initialized() and dist.get_world_size() == shards):
        return None
    if device == "cuda" and shards > gpus:
        raise ValueError(
            f"--mesh-shards {shards} runs one rank per GPU, but only {gpus} "
            "GPU(s) are visible"
        )
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv:
        i = argv.index("--device")
        del argv[i:i + 2]
    with tempfile.TemporaryDirectory(prefix="driver_") as tmp:
        out = os.path.join(tmp, "result.pt")
        ranks.spawn(_driver_rank, shards, (module, argv, out, device),
                    backend="nccl" if device == "cuda" else "gloo",
                    devices=[f"cuda:{r}" for r in range(shards)]
                    if device == "cuda" else None)
        return torch.load(out, weights_only=False)


def run_world(args: argparse.Namespace):
    """The process group of a run in this process: with ``--mesh-shards``
    and no group yet, a world of one, ended when the run is
    (``core.distributed.world_of_one``); no group without the flag."""
    import contextlib

    from repro_torch.core.distributed import world_of_one
    from repro_torch.device import resolve_device

    if args.mesh_shards is None:
        return contextlib.nullcontext()
    return world_of_one(resolve_device(args.device))


def build_task(args: argparse.Namespace) -> FLTask:
    """The federated workload on ``args.device``: the paper's CNN, or with
    ``--arch`` the reduced variant of that architecture as a causal LM over
    64-token documents, 8 a client (as the reference's drivers)."""
    if args.arch:
        from repro_torch.configs import get_arch
        from repro_torch.fl import make_lm_task

        cfg = get_arch(args.arch).reduced()
        return make_lm_task(cfg, args.clients, seq_len=64, docs_per_client=8,
                            seed=args.seed, device=args.device)
    from repro_torch.configs.paper_cnn import CNN_CONFIGS
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.fl import make_cnn_task

    train, test = load_dataset(args.dataset, seed=args.seed, scale=args.data_scale)
    cnn = CNN_CONFIGS[f"paper-cnn-{args.dataset}"]
    return make_cnn_task(
        cnn, train, test, args.clients,
        noniid_alpha=0.6 if args.noniid else None, seed=args.seed,
        device=args.device,
    )


def topology_args(args: argparse.Namespace) -> Dict[str, Any]:
    """``topology``/``topology_kwargs`` RunConfig fields from the shared
    ``--topology``/``--tiers``/``--heartbeat-timeout`` flags."""
    if args.topology is None:
        if args.tiers is not None or args.heartbeat_timeout is not None:
            raise SystemExit(
                "--tiers/--heartbeat-timeout need --topology"
            )
        return {}
    kw: Dict[str, Any] = {}
    if args.tiers is not None:
        tiers = tuple(int(t) for t in args.tiers.split(","))
        # gossip is a flat peer graph: one tier, named 'nodes'
        if args.topology == "gossip":
            if len(tiers) != 1:
                raise SystemExit("gossip takes a single --tiers value")
            kw["nodes"] = tiers[0]
        else:
            kw["tiers"] = tiers
    if args.heartbeat_timeout is not None:
        kw["heartbeat_timeout"] = args.heartbeat_timeout
    return {"topology": args.topology, "topology_kwargs": kw}


def fault_args(args: argparse.Namespace) -> Dict[str, Any]:
    """``faults``/``redispatch_*`` RunConfig fields from the shared fault
    flags; ``--robust-agg`` is folded into ``args.aggregator`` so the
    drivers' aggregator handling sees one source of truth."""
    if args.robust_agg is not None:
        if args.aggregator is not None:
            raise SystemExit(
                "--robust-agg is shorthand for --aggregator: pass one"
            )
        args.aggregator = args.robust_agg
    kw: Dict[str, Any] = {}
    if args.faults is not None:
        from repro_torch.faults import known_fault_names

        names = tuple(s.strip() for s in args.faults.split(",") if s.strip())
        unknown = [n for n in names if n not in known_fault_names()]
        if unknown:
            raise SystemExit(
                f"unknown fault(s) {', '.join(unknown)}; registered: "
                f"{', '.join(known_fault_names())}"
            )
        kw["faults"] = names
        kw["fault_rate"] = args.fault_rate
    if args.redispatch_timeout is not None:
        kw["redispatch_timeout"] = args.redispatch_timeout
        kw["redispatch_retries"] = args.redispatch_retries
    return kw


def defense_args(args: argparse.Namespace) -> Dict[str, Any]:
    """``defense``/``defense_kwargs`` RunConfig fields from the shared
    ``--defense``/``--quarantine-threshold``/``--mtd-window``/
    ``--detector``/``--collusion`` flags."""
    if not args.defense:
        if (args.quarantine_threshold is not None or args.mtd_window is not None
                or args.detector is not None or args.collusion):
            raise SystemExit(
                "--quarantine-threshold/--mtd-window/--detector/--collusion "
                "need --defense"
            )
        return {}
    kw: Dict[str, Any] = {}
    if args.quarantine_threshold is not None:
        kw["threshold"] = args.quarantine_threshold
    if args.mtd_window is not None:
        kw["mtd"] = True
        kw["mtd_window"] = args.mtd_window
    if args.detector is not None:
        kw["detector"] = args.detector
    if args.collusion:
        kw["collusion"] = True
    return {"defense": True, "defense_kwargs": kw}


def build_run_config(args: argparse.Namespace, mode: str, eval_div: int,
                     **extra) -> RunConfig:
    extra = {**topology_args(args), **fault_args(args), **defense_args(args),
             **extra}
    return RunConfig(
        mode=mode,
        n_clients=args.clients, k=args.k, m=args.m, policy=args.policy,
        aggregator=args.aggregator,
        rounds=args.rounds, local_epochs=args.local_epochs,
        batch_size=args.batch_size, lr0=args.lr, seed=args.seed,
        eval_every=max(args.rounds // eval_div, 1),
        steps_per_chunk=args.steps_per_chunk,
        collect_history=False if args.no_history else None,
        rng_impl=args.rng_impl,
        mesh_shards=args.mesh_shards,
        shard_cohort=args.shard_cohort,
        **extra,
    )


def print_robustness_stats(load_stats) -> None:
    """The robustness tier's counters, as the reference's drivers print
    them: injections per fault, the deadline re-dispatch, and the robust
    aggregator's telemetry."""
    ls = load_stats or {}
    injected = {k[len("fault_"):-len("_injected")]: v for k, v in ls.items()
                if k.startswith("fault_") and k.endswith("_injected")}
    if injected:
        print("faults injected: " + ", ".join(
            f"{nm}={int(v)}" for nm, v in injected.items()))
    if "redispatched" in ls:
        print(f"re-dispatch: {ls['redispatched']} re-sent, "
              f"{ls['rd_expired']} deadline hits")
    agg_stats = {k[len("agg_"):]: v for k, v in ls.items()
                 if k.startswith("agg_")}
    if agg_stats:
        print("robust aggregation: " + ", ".join(
            f"{nm}={int(v)}" for nm, v in agg_stats.items()))


def print_defense_stats(load_stats: Optional[Dict[str, Any]]) -> None:
    """Defense-tier report (present when ``--defense`` ran): quarantine
    flow, current suspect census, and the moving-target trim level."""
    ls = load_stats or {}
    if "def_quarantined_now" not in ls:
        return
    line = (f"defense: quarantined={int(ls['def_quarantined_now'])} "
            f"probation={int(ls['def_probation_now'])} "
            f"(inflow {int(ls['def_quarantine_inflow'])}, "
            f"readmitted {int(ls['def_readmitted'])})")
    if "def_mtd_level" in ls:
        line += f" mtd_level={int(ls['def_mtd_level'])}"
    if "def_clique_hits" in ls:
        line += f" clique_hits={int(ls['def_clique_hits'])}"
    if "def_detector_auc" in ls:
        auc = float(ls["def_detector_auc"])
        line += (" detector_auc=n/a" if math.isnan(auc)
                 else f" detector_auc={auc:.3f}")
    print(line)
    if "tier_suspects" in ls:
        counts = ls["tier_suspects"]
        print("  suspects by tier-0 node: "
              + ", ".join(f"{i}:{int(c)}" for i, c in enumerate(counts)))


def print_tier_stats(load_stats: Optional[Dict[str, Any]]) -> None:
    """Per-tier load metric report (present when a multi-tier topology
    ran): Var[X] per tier-0 aggregation node next to the fleet-wide
    figure, which is where inter-tier imbalance shows up."""
    if not load_stats or "tier_var_X" not in load_stats:
        return
    mean = load_stats["tier_mean_X"]
    var = load_stats["tier_var_X"]
    ns = load_stats["tier_num_samples"]
    print(f"per-tier X ({len(var)} tier-0 nodes):")
    show = range(len(var)) if len(var) <= 8 else list(range(4)) + [-1]
    for i in show:
        node = i if i >= 0 else len(var) - 1
        if node != i and len(var) > 8:
            print("  ...")
        print(f"  node {node:3d}: E[X]={mean[node]:.3f} "
              f"Var[X]={var[node]:.3f} (samples {ns[node]})")


def write_result(path: Optional[str], result, args: argparse.Namespace) -> None:
    """One strict-JSON results dump (NaN-safe)."""
    if not path:
        return
    payload = result.to_jsonable()
    payload["cli_args"] = vars(args)
    dump_json(path, payload)
    print("wrote", path)
