"""One run contract for federated training, copied from ``repro.engine.config``.

``RunConfig`` keeps every field of the reference, so a config builds,
validates and serializes the same way in both packages; ``RunResult`` /
``RoundRecord`` are the typed output schema; ``chunk_plan`` splits a run
into chunks that never straddle an eval step.

The port runs the synchronous and asynchronous paths (ROADMAP queue 1,
slices A and B) with the robustness tier (slice C: faults, robust
aggregators, deadline re-dispatch and ``fault_exposure``), aggregation
topologies (slice D: ``topology``/``topology_kwargs``, resolved eagerly
through ``repro_torch.topo.graph``) and the adaptive defense (slice E:
``defense``/``defense_kwargs``, resolved eagerly through
``repro_torch.defense.config``), validated as the reference validates
them, and fleet sharding (slice F: ``mesh_shards``/``shard_cohort``,
validated with the reference's messages). A config that asks for a JAX
PRNG implementation raises ``NotImplementedError``; no option is silently
ignored.

This module is dependency-free (dataclasses + numpy only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np

MODES = ("sync", "async")
RNG_IMPLS = ("threefry2x32", "rbg", "unsafe_rbg")
# largest scan chunk the auto heuristic will pick (bounds the stacked
# per-chunk aux/history buffers at chunk_len * n cells)
MAX_AUTO_CHUNK = 64


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything needed to reproduce one federated run (the reference's
    fields; ``rng_impl`` raises, see ``_slice_guard``)."""

    # --- fleet + schedule (paper Sec. IV defaults) ---
    n_clients: int = 100
    k: int = 15  # paper: 15% participation
    m: int = 10  # max permissible age (Markov policy)
    policy: str = "markov"  # any name in repro_torch.engine.policy_names()
    policy_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    rounds: int = 100  # sync rounds / async server steps
    local_epochs: int = 5
    batch_size: int = 50
    lr0: float = 0.1
    lr_decay: float = 0.998
    seed: int = 0
    # cohort padding for variable-size policies (markov): vmap width
    max_cohort: Optional[int] = None
    eval_every: int = 1

    # --- hot loop ---
    # steps advanced per host transfer. None -> auto: min(eval_every,
    # MAX_AUTO_CHUNK); chunks never straddle an eval step.
    steps_per_chunk: Optional[int] = None
    # materialize the (rounds, n) selection matrix on the host. None ->
    # below the history cell cap. False: load stats come from the
    # device-resident accumulators alone.
    collect_history: Optional[bool] = None
    # the reference's JAX PRNG implementation; must stay None here
    rng_impl: Optional[str] = None

    # --- engine ---
    mode: str = "sync"  # sync | async
    # None -> per-mode default: fedavg (sync) / fedbuff (async)
    aggregator: Optional[str] = None
    aggregator_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # --- async engine only ---
    buffer_size: Optional[int] = None  # aggregation buffer; default k
    max_versions: int = 8  # ring of retained global models
    profile: Any = "lognormal"  # name or sim.latency.LatencyProfile
    use_kernel: Optional[bool] = None  # None: kernel when fleet is large

    # --- fleet sharding (repro_torch.engine.sharded) ---
    # None -> one device. D > 0 splits the async fleet state over D ranks
    # of a torch.distributed group (0 = auto-detect: the largest divisor
    # of n_clients at most the group's size); with shard_cohort the cohort
    # axis is split over them instead of replicated (sync or async).
    mesh_shards: Optional[int] = None
    # --- aggregation topology (repro_torch.topo) ---
    # None / "star" -> the single-server reduction, bit-for-bit unchanged.
    # A registered topology name ("hierarchical", "gossip", or anything
    # added via @register_topology) or a ready ``Topology`` routes the
    # aggregation through the tiered reduction (additive aggregators only),
    # prices each cross-tier hop with a sim.latency profile, and — when the
    # topology arms ``heartbeat_timeout`` — excludes clients that went dark
    # from their tier's reduction (async engine; sync rejects a heartbeat).
    topology: Any = None
    topology_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # --- fault injection (repro_torch.faults) ---
    # fault names from the @register_fault registry ("dropout,corrupt" or
    # a sequence). Empty -> no fault state, no draws, no ops: the engines
    # are structurally the calm run.
    faults: Any = ()
    fault_rate: float = 0.05  # per-event injection probability
    # per-fault kwargs, keyed by fault name: {"corrupt": {"sigma": 2.0}}
    fault_kwargs: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict
    )
    # deadline-based re-dispatch (async engine): a dispatch still in
    # flight this many simulated seconds later is re-issued at the
    # current version with a fresh latency draw, at most
    # redispatch_retries times; then it is written off. None/0 -> the
    # expiry check and its (n,) state are absent entirely.
    redispatch_timeout: Optional[float] = None
    redispatch_retries: int = 1
    shard_cohort: bool = False
    # --- adaptive defense (repro_torch.defense) ---
    # False -> no defense state, no sub-stream, no ops: the engines are
    # structurally the calm run. True arms per-client reputation +
    # quarantine (and, via defense_kwargs={"mtd": True}, moving-target
    # aggregation); the state rides the engine state like fault state, so
    # it works per-step and chunked, and checkpoints/restores bitwise.
    defense: bool = False
    defense_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # surface per-client fault-exposure counts ((n,) per armed fault) in
    # RunResult.fault_exposure
    fault_exposure: bool = False

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        _slice_guard(self)
        if not 0 < self.k <= self.n_clients:
            raise ValueError(
                f"k={self.k} must be in 1..n_clients={self.n_clients}"
            )
        if self.max_cohort is not None and self.max_cohort < self.k:
            raise ValueError(
                f"max_cohort={self.max_cohort} < k={self.k}: the cohort "
                "buffer could not hold even an exact-k selection; raise "
                "max_cohort (or leave it None for the binomial-tail default)"
            )
        if self.steps_per_chunk is not None and self.steps_per_chunk < 1:
            raise ValueError(
                f"steps_per_chunk must be >= 1, got {self.steps_per_chunk}"
            )
        if self.mesh_shards is not None:
            if self.mode != "async" and not self.shard_cohort:
                raise ValueError(
                    "mesh_shards requires mode='async' (fleet sharding is "
                    "an async-engine feature) or shard_cohort=True (the "
                    "mesh then shards the sync cohort axis), got "
                    f"mode={self.mode!r}"
                )
            if self.mesh_shards < 0:
                raise ValueError(
                    f"mesh_shards must be >= 0 (0 = auto-detect devices), "
                    f"got {self.mesh_shards}"
                )
            if (self.mode == "async" and self.mesh_shards > 0
                    and self.n_clients % self.mesh_shards):
                raise ValueError(
                    f"mesh_shards={self.mesh_shards} must divide "
                    f"n_clients={self.n_clients} (every device owns an "
                    "equal client block); use 0 to auto-detect"
                )
        if self.shard_cohort and self.mesh_shards is None:
            raise ValueError(
                "shard_cohort=True needs a device mesh: set mesh_shards "
                "(0 = auto-detect) — without one the cohort would silently "
                "stay replicated"
            )
        if self.topology is not None:
            # resolve eagerly so a typo'd name or an invalid tier shape
            # fails at config construction, not mid-run
            self.resolved_topology()
        elif self.topology_kwargs:
            raise ValueError(
                "topology_kwargs given without a topology name"
            )
        names = self.fault_names()
        if names:
            if not 0.0 <= self.fault_rate <= 1.0:
                raise ValueError(
                    f"fault_rate must be in [0, 1], got {self.fault_rate}"
                )
            # the static built-in list plus plugins, so a typo fails at
            # config construction
            from repro_torch.faults.registry import known_fault_names

            known = known_fault_names()
            bad = [nm for nm in names if nm not in known]
            if bad:
                raise ValueError(
                    f"unknown fault(s) {', '.join(repr(b) for b in bad)}; "
                    f"registered: {', '.join(known)}"
                )
            stray = set(self.fault_kwargs) - set(names)
            if stray:
                raise ValueError(
                    f"fault_kwargs for fault(s) not in faults: "
                    f"{', '.join(sorted(stray))}"
                )
        elif self.fault_kwargs:
            raise ValueError("fault_kwargs given without faults")
        if self.fault_exposure and not names:
            raise ValueError(
                "fault_exposure=True records per-client fault hits, but "
                "no faults are configured — arm faults or drop the flag"
            )
        if self.defense:
            # resolve eagerly (torch-free DefenseConfig) so a bad knob
            # fails at config construction, like topology resolution
            dcfg = self.resolved_defense()
            if self.shard_cohort and (dcfg.collusion
                                      or dcfg.detector != "zscore"):
                raise ValueError(
                    "collusion scoring and the learned detector keep "
                    "whole-cohort state (pairwise similarity, one "
                    "logistic head) that is not psum-mergeable under "
                    "shard_cohort — drop shard_cohort (fleet sharding "
                    "via --mesh-shards *without* --shard-cohort works: "
                    "the (n, d_sketch) sketches shard over the fleet "
                    "axis like every other per-client leaf), or keep "
                    "the default detector='zscore' without collusion"
                )
            if dcfg.mtd:
                topo = self.resolved_topology()
                if topo is not None and not topo.is_star:
                    raise ValueError(
                        "moving-target defense (mtd) swaps in an "
                        "order-statistic trimmed mean, which is not "
                        "additive: it cannot ride a tiered topology's "
                        "segment-sum reduction — disable mtd or use the "
                        "star topology (reputation/quarantine alone work "
                        "everywhere)"
                    )
                if self.shard_cohort:
                    raise ValueError(
                        "moving-target defense (mtd) swaps in an "
                        "order-statistic trimmed mean, which is not "
                        "additive: it cannot be psum-merged under "
                        "shard_cohort — disable mtd or shard_cohort "
                        "(reputation/quarantine alone work everywhere)"
                    )
        elif self.defense_kwargs:
            raise ValueError("defense_kwargs given without defense=True")
        if self.redispatch_timeout is not None:
            if self.mode != "async":
                raise ValueError(
                    "redispatch_timeout re-issues expired dispatches on "
                    "the async engine's event clock; sync rounds have no "
                    "in-flight dispatches — drop it or use mode='async'"
                )
            if self.redispatch_timeout <= 0:
                raise ValueError(
                    f"redispatch_timeout must be > 0 (or None to disable),"
                    f" got {self.redispatch_timeout}"
                )
            if self.redispatch_retries < 0:
                raise ValueError(
                    f"redispatch_retries must be >= 0, got "
                    f"{self.redispatch_retries}"
                )

    def cohort_width(self) -> int:
        """Padded cohort buffer width for variable-size policies."""
        if self.max_cohort is not None:
            return self.max_cohort
        return default_cohort_width(self.n_clients, self.k)

    def resolved_aggregator(self) -> str:
        if self.aggregator is not None:
            return self.aggregator
        return "fedavg" if self.mode == "sync" else "fedbuff"

    def resolved_buffer_size(self) -> int:
        return self.buffer_size or self.k

    def resolved_steps_per_chunk(self) -> int:
        if self.steps_per_chunk is not None:
            return self.steps_per_chunk
        return max(1, min(self.eval_every, MAX_AUTO_CHUNK))

    def profile_name(self) -> str:
        return self.profile if isinstance(self.profile, str) else self.profile.name

    def resolved_topology(self):
        """The ``repro_torch.topo.Topology`` this run aggregates through, or
        None for the default star; validated against ``n_clients``
        (``topo.graph`` is numpy-only, like this module)."""
        if self.topology is None:
            return None
        from repro_torch.topo.graph import Topology, make_topology

        if isinstance(self.topology, Topology):
            topo = self.topology
            if self.topology_kwargs:
                raise ValueError(
                    "topology_kwargs only apply to registry names; got a "
                    "ready Topology instance"
                )
        else:
            topo = make_topology(self.topology, **dict(self.topology_kwargs))
        topo.validate(self.n_clients)
        return topo

    def topology_name(self) -> str:
        topo = self.resolved_topology()
        return "star" if topo is None else topo.describe()

    def fault_names(self) -> tuple:
        """Normalized tuple of configured fault names ("a,b" or any
        sequence of names; () / None / "" -> no faults)."""
        if not self.faults:
            return ()
        if isinstance(self.faults, str):
            return tuple(
                nm.strip() for nm in self.faults.split(",") if nm.strip()
            )
        return tuple(self.faults)

    def resolved_faults(self):
        """The ``repro_torch.faults.FaultSet`` this run injects, or None
        when no faults are configured (lazy import: it brings torch)."""
        names = self.fault_names()
        if not names:
            return None
        from repro_torch.faults import FaultSet, make_fault

        return FaultSet(
            make_fault(
                nm, self.n_clients, self.fault_rate,
                **dict(self.fault_kwargs.get(nm, {})),
            )
            for nm in names
        )

    def resolved_defense(self):
        """The ``repro_torch.defense.DefenseConfig`` this run arms, or None
        (``repro_torch.defense.config`` is a plain dataclass module, so
        eager validation in ``__post_init__`` imports no torch)."""
        if not self.defense:
            return None
        from repro_torch.defense.config import DefenseConfig

        accepted = tuple(f.name for f in dataclasses.fields(DefenseConfig))
        stray = sorted(set(self.defense_kwargs) - set(accepted))
        if stray:
            raise ValueError(
                f"unknown defense_kwargs key(s) "
                f"{', '.join(repr(s) for s in stray)}; accepted: "
                f"{', '.join(accepted)}"
            )
        return DefenseConfig(**dict(self.defense_kwargs))


def _slice_guard(cfg: "RunConfig") -> None:
    """Reject the reference's option that has no meaning in the port."""
    if cfg.rng_impl is not None:
        raise NotImplementedError(
            f"rng_impl={cfg.rng_impl!r} names a JAX PRNG implementation; "
            "repro_torch draws from a torch.Generator (leave rng_impl None)"
        )


def chunk_plan(rounds: int, eval_every: int, steps_per_chunk: int):
    """Split ``rounds`` steps into scan chunks of at most ``steps_per_chunk``
    that never straddle an eval step, as ``(start, length, do_eval)``.

    Eval steps are exactly the pre-chunking cadence — every step ``r`` with
    ``(r + 1) % eval_every == 0`` plus the final step — so a chunked run
    evaluates (and records) at identical rounds to a per-step run.
    """
    plan = []
    r = 0
    while r < rounds:
        next_eval = min((r // eval_every + 1) * eval_every, rounds)
        end = min(r + steps_per_chunk, next_eval)
        plan.append((r, end - r, end == next_eval))
        r = end
    return plan


def default_cohort_width(n_clients: int, k: int) -> int:
    """Markov cohort is ~Binomial(n, k/n): pad to k + 4*sigma (overflow
    beyond the buffer is dropped, so the tail allowance matters)."""
    q = k / n_clients
    sigma = math.sqrt(n_clients * q * (1 - q))
    return min(n_clients, int(k + 4 * sigma) + 1)


def run_config_from_legacy(fl, acfg=None, **overrides) -> RunConfig:
    """Build a RunConfig from the legacy ``FLConfig`` (+ ``AsyncConfig``)
    pair. ``acfg`` switches the mode to async and maps its staleness
    knobs onto the fedbuff aggregator's kwargs."""
    kw: Dict[str, Any] = dict(
        n_clients=fl.n_clients, k=fl.k, m=fl.m, policy=fl.policy,
        rounds=fl.rounds, local_epochs=fl.local_epochs,
        batch_size=fl.batch_size, lr0=fl.lr0, lr_decay=fl.lr_decay,
        seed=fl.seed, max_cohort=fl.max_cohort, eval_every=fl.eval_every,
    )
    if acfg is not None:
        kw.update(
            mode="async",
            aggregator="fedbuff",
            aggregator_kwargs={
                "staleness_mode": acfg.staleness_mode,
                "staleness_exp": acfg.staleness_exp,
            },
            buffer_size=acfg.buffer_size,
            max_versions=acfg.max_versions,
            profile=acfg.profile,
            use_kernel=acfg.use_kernel,
        )
    kw.update(overrides)
    return RunConfig(**kw)


# ---------------------------------------------------------------------------
# Result schema
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoundRecord:
    """One evaluated round / server step, identical for both engines.

    ``clock``/``version``/``buffer_fill`` are simulator quantities and stay
    None under the sync engine.
    """

    round: int
    train_loss: float
    eval_loss: float
    accuracy: float
    clock: Optional[float] = None
    version: Optional[int] = None
    buffer_fill: Optional[int] = None


@dataclasses.dataclass
class RunResult:
    """Typed output of ``repro_torch.engine.run_engine``."""

    config: RunConfig
    records: List[RoundRecord]
    selection: Optional[np.ndarray]  # (rounds, n) bool, None above cell cap
    load_stats: Dict[str, float]  # empirical Var[X] etc. from selection
    wall_stats: Optional[Dict[str, float]]  # async-only simulator stats
    params: Any
    wall_time_s: float
    # per-fault (n,) exposure counts, only when cfg.fault_exposure
    fault_exposure: Optional[Dict[str, np.ndarray]] = None
    # per-client defense arrays ({"reputation", "status"}), only when armed
    defense: Optional[Dict[str, np.ndarray]] = None

    def history(self) -> Dict[str, list]:
        """Legacy column-oriented history view of the records."""
        cols = ["round", "accuracy", "eval_loss", "train_loss"]
        if self.config.mode == "async":
            cols = ["round", "clock", "version", "accuracy", "eval_loss",
                    "train_loss", "buffer_fill"]
        return {c: [getattr(r, c) for r in self.records] for c in cols}

    def to_jsonable(self) -> Dict[str, Any]:
        """JSON-safe payload (excludes params and the raw selection matrix)."""
        from repro_torch.engine.serialize import to_jsonable

        return to_jsonable({
            "config": dataclasses.asdict(self.config),
            "history": self.history(),
            "load_stats": self.load_stats,
            "wall_stats": self.wall_stats,
            "wall_time_s": self.wall_time_s,
        })
