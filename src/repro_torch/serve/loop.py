"""The serving tier: a replica pool over the version ring, driven by a
router and a continuous-batching request loop.

Port of ``repro.serve.loop``. One fleet both trains and serves: training
advances the async engine's ring of retained global versions; each serving
*replica* pins one retained version out of a ``VersionStore`` snapshot
(replica i serves ``latest - i * stagger``, refreshed between training
chunks) and decodes up to ``slots`` request streams at once through the
continuous-batching pool (``repro_torch.serve.batching``): one batch-S
``decode_step`` a tick, its attention through K5 with a per-row
``valid_len``. A ``Router`` from the ``@register_router`` registry decides
which replica admits each queued request; every routing decision is one
epoch of the paper's load metric, so Var[X] over replicas comes from the
same Kahan accumulators the training engines use
(``load_metric.*_replica_accum``).

Placement: the model, the params, the slot pools and K5 are on the pool's
device (the GPU unless the caller asks for the CPU). The router state, the
(R,) load vector, the replica accumulators and the random draws are R-wide
host bookkeeping whose every decision the host reads at once, so they live
on the CPU. The host reads from the device are the reference's own: one
token read per busy replica per tick, one per join (its first token), and
the version reads of a re-pin (``ReplicaPool.host_reads`` counts the first
two).

Reported per run (``ServeReport``): time-to-first-token (ticks from arrival
to the join's first token, and host-clock seconds), decode throughput in
tokens/s of host wall time, staleness of the served version (age of each
stream's pinned version relative to the ring head at join time), and
``serve_stats``: fleet-wide and per-replica E[X]/Var[X] over routing
decisions, plus the ring-miss, crash, failover and revival counts.

Decoding is greedy (argmax): the contract is bitwise stream isolation
under join/evict churn, which sampling noise would mask.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.draws import GeneratorDraws
from repro_torch.core.load_metric import (
    init_replica_accum,
    replica_stats_from_accum,
    update_replica_accum,
)
from repro_torch.device import resolve_device
from repro_torch.serve.batching import (
    init_slot_pool,
    prefill_tokens,
    slot_decode_fn,
    write_slot,
)
from repro_torch.serve.router import Router, make_router, penalized_load
from repro_torch.serve.store import VersionStore


@dataclasses.dataclass
class Request:
    """One inference request of the open-loop arrival process.

    ``resume`` carries the interrupted stream dict of a request being
    failed over from a crashed replica: the prompt is the original prompt
    plus every token already generated, ``gen_len`` the tokens still
    owed, and the join stitches the prior stream's history back on so the
    completed ``StreamResult`` is indistinguishable from an uninterrupted
    run (token for token when the new replica pins the same version)."""

    rid: int
    tick: int  # arrival tick
    prompt: np.ndarray  # (P,) int32 prompt tokens
    gen_len: int  # tokens to generate (>= 1)
    resume: Optional[Dict] = None  # interrupted stream being failed over


@dataclasses.dataclass
class StreamResult:
    """One completed request stream."""

    rid: int
    replica: int
    version: int  # global model version served
    staleness: int  # ring head - version, at join time
    arrival_tick: int
    first_token_tick: int
    done_tick: int
    tokens: List[int]
    migrations: int = 0  # replica crashes survived via failover
    ttft_s: float = float("nan")  # host clock: arrival tick's start to the first token

    @property
    def ttft_ticks(self) -> int:
        """Scheduler ticks from arrival to the first emitted token (the
        join tick's prefill emits it, so a same-tick join scores 1)."""
        return self.first_token_tick - self.arrival_tick + 1


class ReplicaPool:
    """``n_replicas`` serving replicas, each pinning one retained version
    and running a ``slots``-wide continuous-batching decode pool on
    ``device`` (``resolve_device``: the GPU unless ``"cpu"`` is asked for)."""

    def __init__(self, model, n_replicas: int, slots: int, ctx: int,
                 stagger: int = 1, device=None):
        self.model = model
        self.device = resolve_device(device)
        self.n_replicas = n_replicas
        self.slots = slots
        self.ctx = ctx
        self.stagger = stagger
        self._tick_fn = slot_decode_fn(model)
        self.pools = [init_slot_pool(model, slots, ctx, self.device)
                      for _ in range(n_replicas)]
        self.cur_tok = [torch.zeros((slots, 1), dtype=torch.int32, device=self.device)
                        for _ in range(n_replicas)]
        self.active: List[List[Optional[Dict]]] = [
            [None] * slots for _ in range(n_replicas)
        ]
        self.params: List = [None] * n_replicas
        self.version = [0] * n_replicas
        self.staleness = [0] * n_replicas
        self.alive = [True] * n_replicas
        self.ring_miss = 0  # reads whose requested version fell off the ring
        self.host_reads = 0  # token reads from the device: ticks and joins

    def _pin(self, replica: int, store: VersionStore) -> None:
        read = store.read(store.latest - replica * self.stagger)
        self.ring_miss += int(read.ring_miss)
        self.params[replica] = read.params
        self.version[replica] = int(read.read_ver)
        self.staleness[replica] = int(read.staleness)

    def refresh(self, store: VersionStore) -> None:
        """Re-pin every replica against a fresh ring snapshot: replica i
        serves ``latest - i * stagger`` (clipped to the retained window),
        so a staggered pool covers a spread of stalenesses. In-flight
        streams keep decoding (their KV caches already embed the version
        they prefilled under), but their ticks run the new pin's params,
        as in the reference. Dead replicas stay dead and unpinned."""
        for i in range(self.n_replicas):
            if self.alive[i]:
                self._pin(i, store)

    def load(self) -> np.ndarray:
        """(R,) float32 in-flight streams per replica, the router's
        score. Dead replicas score +inf so every load-aware (and the
        dead-masked round-robin) router routes around them."""
        return np.asarray(
            [
                sum(s is not None for s in a) if self.alive[i] else np.inf
                for i, a in enumerate(self.active)
            ],
            np.float32,
        )

    def has_free(self, replica: int) -> bool:
        return self.alive[replica] and any(
            s is None for s in self.active[replica]
        )

    def total_free(self) -> int:
        return sum(
            s is None
            for i, a in enumerate(self.active) if self.alive[i]
            for s in a
        )

    def n_alive(self) -> int:
        return sum(self.alive)

    def crash(self, replica: int) -> List[Dict]:
        """Kill ``replica``: mark it dead and evict every in-flight
        stream, returning the interrupted stream dicts so the loop can
        re-queue them as failover resumes. The replica takes no further
        joins or decode ticks."""
        self.alive[replica] = False
        orphans = [s for s in self.active[replica] if s is not None]
        self.active[replica] = [None] * self.slots
        return orphans

    def revive(self, replica: int, store: VersionStore) -> None:
        """Restart a crashed replica: mark it alive with an empty slot
        pool and re-pin it against the current ring snapshot. In-flight
        state never survives the crash (the orphans already failed over),
        so a revived replica comes back cold and rejoins the router's
        candidate set."""
        if self.alive[replica]:
            return
        self.alive[replica] = True
        self.active[replica] = [None] * self.slots
        self._pin(replica, store)

    @torch.no_grad()
    def join(self, replica: int, req: Request, tick: int,
             arrival_wall: Optional[float] = None):
        """Admit ``req`` on ``replica``: prefill its prompt into a fresh
        batch-1 cache through the decode path (``prefill_tokens``), emit the
        first token (one host read), and unless the request is already
        complete write the cache into a free slot's row. Returns a
        ``StreamResult`` when the request finishes at join (gen_len == 1),
        else None. Caller must check ``has_free`` first. ``arrival_wall``
        is the host clock at the start of the request's arrival tick, for
        ``StreamResult.ttft_s``."""
        slot = self.active[replica].index(None)
        caches = self.model.init_decode_caches(1, self.ctx, self.device)
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32), device=self.device)
        logits, one = prefill_tokens(self.model.decode_step, self.params[replica],
                                     caches, prompt[None, :])
        first = int(torch.argmax(logits[0, -1]))
        self.host_reads += 1
        ttft_s = (time.perf_counter() - arrival_wall if arrival_wall is not None
                  else float("nan"))
        if req.resume is not None:
            # failover: the prompt already holds the original prompt plus
            # every generated token, so this prefill's argmax is the next
            # token the dead replica owed. Stitch the prior stream's history
            # back on; the result keeps its original arrival/first-token
            # ticks and join-time version.
            prior = req.resume
            stream = {
                **prior,
                "tokens": prior["tokens"] + [first],
                "remaining": req.gen_len - 1,
                "migrations": prior["migrations"] + 1,
            }
        else:
            stream = {
                "rid": req.rid,
                "prompt": req.prompt,
                "arrival": req.tick,
                "first_tick": tick,
                "tokens": [first],
                "remaining": req.gen_len - 1,
                "version": self.version[replica],
                "staleness": self.staleness[replica],
                "migrations": 0,
                "ttft_s": ttft_s,
            }
        if stream["remaining"] == 0:
            return self._result(replica, stream, tick)
        self.pools[replica] = write_slot(self.pools[replica], slot, one)
        self.cur_tok[replica][slot] = first
        self.active[replica][slot] = stream
        return None

    @torch.no_grad()
    def decode_tick(self, tick: int) -> List[StreamResult]:
        """One batch-S decode step per busy replica: every slot advances
        one token, one host read of the replica's (S,) next tokens; active
        streams record theirs, finished streams evict."""
        done: List[StreamResult] = []
        for i in range(self.n_replicas):
            if not any(s is not None for s in self.active[i]):
                continue
            logits, self.pools[i] = self._tick_fn(self.params[i], self.pools[i],
                                                  self.cur_tok[i])
            nxt = torch.argmax(logits[:, -1, :], dim=-1)  # (S,)
            self.cur_tok[i] = nxt[:, None].to(torch.int32)
            host_next = nxt.cpu().numpy()
            self.host_reads += 1
            for s, stream in enumerate(self.active[i]):
                if stream is None:
                    continue
                stream["tokens"].append(int(host_next[s]))
                stream["remaining"] -= 1
                if stream["remaining"] == 0:
                    done.append(self._result(i, stream, tick))
                    self.active[i][s] = None
        return done

    def _result(self, replica: int, stream: Dict, tick: int) -> StreamResult:
        return StreamResult(
            rid=stream["rid"],
            replica=replica,
            version=stream["version"],
            staleness=stream["staleness"],
            arrival_tick=stream["arrival"],
            first_token_tick=stream["first_tick"],
            done_tick=tick,
            tokens=stream["tokens"],
            migrations=stream.get("migrations", 0),
            ttft_s=stream.get("ttft_s", float("nan")),
        )


@dataclasses.dataclass
class ServeReport:
    """Aggregate serving metrics for one loop run. ``ttft_s_mean`` and
    ``wall_s`` (host clock over every tick) are the port's additions."""

    results: List[StreamResult]
    ticks: int
    decisions: int
    rejections: int
    queue_left: int
    tokens_out: int
    ttft_ticks_mean: float
    staleness_mean: float
    staleness_max: int
    decode_wall_s: float
    tok_s: float
    serve_stats: Dict  # fleet + per-replica E[X]/Var[X] over decisions
    ttft_s_mean: float = float("nan")
    wall_s: float = float("nan")

    def summary(self) -> str:
        ss = self.serve_stats
        return (
            f"served {len(self.results)} streams / {self.tokens_out} tokens "
            f"in {self.ticks} ticks ({self.tok_s:.0f} tok/s decode) | "
            f"ttft={self.ttft_ticks_mean:.2f} ticks | "
            f"staleness mean={self.staleness_mean:.2f} max={self.staleness_max} | "
            f"routing Var[X]={ss['var_X']:.3f} E[X]={ss['mean_X']:.3f} "
            f"({self.decisions} decisions, {self.rejections} rejected)"
        )


def _serve_crash_rate(faults) -> float:
    """The ``replica_crash`` rate among ``faults`` (0 without one); raises
    for engine-scope faults and unknown serve faults."""
    crash_rate = 0.0
    for f in tuple(faults) if faults is not None else ():
        if getattr(f, "scope", None) != "serve":
            raise ValueError(
                f"fault {f.name!r} is engine-scope: pass it to "
                "RunConfig(faults=...), not the serving loop"
            )
        if f.name != "replica_crash":
            raise ValueError(
                f"unknown serve-scope fault {f.name!r}; the serving loop "
                "handles: replica_crash"
            )
        crash_rate = float(f.rate)
    return crash_rate


def run_serve_loop(
    model,
    store: VersionStore,
    requests: List[Request],
    *,
    router="round_robin",
    router_kwargs: Optional[Dict] = None,
    n_replicas: int = 2,
    slots: int = 4,
    ctx: Optional[int] = None,
    ticks: Optional[int] = None,
    stagger: int = 1,
    seed: int = 0,
    pool: Optional[ReplicaPool] = None,
    faults=None,
    restart_ticks: int = 0,
    reputation_penalty: float = 0.0,
    draws=None,
    device=None,
) -> ServeReport:
    """Drive the continuous-batching loop over an open-loop request trace.

    Per tick: append the tick's arrivals to the FIFO queue; while free
    slots remain, ask the router for the head request's replica (one
    accumulator epoch per decision; a rejection, or a pick of a full
    replica, ends admission for the tick); then advance every busy
    replica one decode step. ``pool`` reuses an existing ``ReplicaPool``
    (its in-flight streams survive across calls: pass the same pool
    between training chunks); otherwise one is built on ``device`` and
    pinned from ``store``.

    ``draws`` is the loop's random source (default: a generator seeded
    with ``seed``, on the CPU with the router). Decision ``d`` draws from
    ``draws.sub("router").step(d)``, tick ``t``'s crash coins from
    ``draws.sub("crash").step(t)``, so arming a crash changes no routing
    draw (the reference keeps them apart on separate key folds).

    ``faults`` takes serve-scope ``repro_torch.faults.Fault`` records
    (``replica_crash``): each tick every alive replica crashes with the
    fault's rate, except the last survivor (the pool must always be able to
    drain). A crash evicts the replica and re-queues its in-flight streams
    at the queue head as failover resumes: zero streams are dropped,
    counted in ``serve_stats["failed_over"]``.

    ``restart_ticks > 0`` arms graceful restarts: a crashed replica
    revives cold (``ReplicaPool.revive``) after that many ticks down,
    counted in ``serve_stats["revived"]``. ``reputation_penalty > 0``
    arms crash reputation: each replica carries a crash count decayed
    0.98x per tick, and ``penalty x count`` is added onto its routing
    load (``router.penalized_load``) so load-aware routers steer new
    joins away from recently flaky replicas. Both default off and add
    no work: the calm loop is unchanged.
    """
    if restart_ticks < 0:
        raise ValueError(
            f"restart_ticks must be >= 0, got {restart_ticks}"
        )
    if reputation_penalty < 0:
        raise ValueError(
            f"reputation_penalty must be >= 0, got {reputation_penalty}"
        )
    crash_rate = _serve_crash_rate(faults)
    requests = sorted(requests, key=lambda r: (r.tick, r.rid))
    if ctx is None:
        ctx = max((len(r.prompt) + r.gen_len for r in requests), default=8)
    if ticks is None:
        last = requests[-1].tick if requests else 0
        ticks = last + sum(r.gen_len for r in requests) + 8
    if pool is None:
        pool = ReplicaPool(model, n_replicas, slots, ctx, stagger=stagger,
                           device=device)
        pool.refresh(store)
    R = pool.n_replicas
    rt = router if isinstance(router, Router) else make_router(
        router, R, **(router_kwargs or {})
    )
    # host bookkeeping (router state, load, accumulators, draws) on the CPU
    draws = GeneratorDraws(seed, "cpu") if draws is None else draws
    route_draws, crash_draws = draws.sub("router"), draws.sub("crash")
    rstate = rt.init(route_draws, R)
    acc = init_replica_accum(R)
    no_assign = torch.zeros((R,), dtype=torch.bool)

    queue: collections.deque = collections.deque()
    pending = collections.deque(requests)
    results: List[StreamResult] = []
    decisions = rejections = 0
    crashes = failed_over = revived = 0
    crash_penalty = np.zeros((R,), np.float32)
    down_since: Dict[int, int] = {}
    tick_start: List[float] = []
    decode_wall = 0.0
    wall0 = time.perf_counter()
    t = 0
    for t in range(ticks):
        tick_start.append(time.perf_counter())
        # --- restarts: crashed replicas come back cold after their
        # restart window, before this tick's crash draw can re-kill them
        if restart_ticks > 0:
            for i, since in list(down_since.items()):
                if t - since >= restart_ticks:
                    pool.revive(i, store)
                    revived += 1
                    del down_since[i]
        if reputation_penalty > 0.0:
            crash_penalty *= np.float32(0.98)
        # --- fault injection: replica crashes, sparing the last survivor
        if crash_rate > 0.0 and pool.n_alive() > 1:
            hit = (crash_draws.step(t).uniform("hit", (R,)) < crash_rate).cpu().numpy()
            for i in range(R):
                if not (hit[i] and pool.alive[i]) or pool.n_alive() <= 1:
                    continue
                orphans = pool.crash(i)
                crashes += 1
                crash_penalty[i] += 1.0
                down_since[i] = t
                failed_over += len(orphans)
                # failover resumes go to the queue head, oldest first
                queue.extendleft(
                    _resume_request(s) for s in reversed(orphans)
                )
        while pending and pending[0].tick <= t:
            queue.append(pending.popleft())
        # --- admission: one router decision per queued head request
        while queue and pool.total_free() > 0:
            req = queue[0]
            load = torch.as_tensor(pool.load())
            if reputation_penalty > 0.0:
                load = penalized_load(
                    load, np.float32(reputation_penalty) * crash_penalty
                )
            ridx, rstate = rt.step(rstate, load, route_draws.step(decisions))
            decisions += 1
            ridx = int(ridx)  # a CPU tensor: no device sync
            if ridx >= 0 and pool.has_free(ridx):
                assigned = no_assign.clone()
                assigned[ridx] = True
                acc = update_replica_accum(acc, assigned)
                queue.popleft()
                res = pool.join(ridx, req, t, arrival_wall=tick_start[req.tick])
                if res is not None:
                    results.append(res)
            else:
                # rejected (or full replica picked): the epoch still
                # advances every replica's age chain; head-of-line waits
                acc = update_replica_accum(acc, no_assign)
                rejections += 1
                break
        # --- decode: every busy replica advances one token; the window
        # includes the tick's token reads, so it is a host wall time
        t0 = time.perf_counter()
        results.extend(pool.decode_tick(t))
        decode_wall += time.perf_counter() - t0
        if not pending and not queue and pool.total_free() == pool.n_alive() * pool.slots:
            break
    wall_s = time.perf_counter() - wall0

    tokens_out = sum(len(r.tokens) for r in results)
    ttfts = [r.ttft_ticks for r in results]
    ttft_s = [r.ttft_s for r in results if np.isfinite(r.ttft_s)]
    stal = [r.staleness for r in results]
    serve_stats = dict(replica_stats_from_accum(acc))
    serve_stats["ring_miss"] = pool.ring_miss
    serve_stats["crashes"] = crashes
    serve_stats["failed_over"] = failed_over
    serve_stats["revived"] = revived
    return ServeReport(
        results=results,
        ticks=t + 1,
        decisions=decisions,
        rejections=rejections,
        queue_left=len(queue) + len(pending),
        tokens_out=tokens_out,
        ttft_ticks_mean=float(np.mean(ttfts)) if ttfts else float("nan"),
        staleness_mean=float(np.mean(stal)) if stal else float("nan"),
        staleness_max=int(max(stal)) if stal else 0,
        decode_wall_s=decode_wall,
        tok_s=tokens_out / decode_wall if decode_wall > 0 else float("nan"),
        serve_stats=serve_stats,
        ttft_s_mean=float(np.mean(ttft_s)) if ttft_s else float("nan"),
        wall_s=wall_s,
    )


def _resume_request(stream: Dict) -> Request:
    """Rebuild a crashed replica's in-flight stream as a joinable
    request: the new prompt is the original prompt plus every token
    already generated, so the survivor's prefill reconstructs the exact
    decode context the dead replica held."""
    return Request(
        rid=stream["rid"],
        tick=stream["arrival"],
        prompt=np.concatenate([
            np.asarray(stream["prompt"], np.int32),
            np.asarray(stream["tokens"], np.int32),
        ]),
        gen_len=stream["remaining"],
        resume=stream,
    )
