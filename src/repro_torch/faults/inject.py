"""Deterministic fault injection for the fleet engines, on torch tensors.

The port of ``repro.faults.inject``. A :class:`Fault` is a per-client
state dict plus up to two pure hooks the engines call with a *dedicated*
random source (the run's ``draws.sub("faults")`` stream, then one
sub-stream per fault, so adding a fault never perturbs another's draws and
no fault draw moves the calm path's):

  * ``on_dispatch(fstate, draws, send, latency)`` fires when clients pull
    a model (async engine only — sync rounds have no dispatch latency) and
    may perturb the sampled wall-clock latencies (straggler stalls);
  * ``on_pop(fstate, draws, idx, valid)`` fires on the popped/selected
    cohort and returns an :class:`Effects` record — which slots to kill,
    how to corrupt their deltas, how far to replay their read version.

Per-fault state is a dict of ``(n,)`` tensors plus scalar counters on the
run's device, carried in the engine state like every other per-client
tensor. Faults-off is *structurally* the calm run (no state keys, no
sub-stream, no ops), and a rate-0 fault set is bitwise identity too —
every effect is applied through a per-slot ``torch.where`` that selects
the untouched input when the fault missed.

Hit selection is two-stage: ``init`` draws a persistent ``prone`` mask
(``client_frac`` of the fleet is susceptible at all — 1.0 skips the draw)
and each event draws a coin at ``rate`` among prone participants. A coin
is ``uniform < rate`` (the reference's ``jax.random.bernoulli``), drawn at
site ``hit`` of the fault's sub-stream.

``replica_crash`` is scope="serve": the serving loop consumes its rate;
the engines reject serve-scope faults.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.tree import tree_map_with_path, tree_paths
from repro_torch.faults.registry import register_fault

# replay shift meaning "as stale as the ring allows": the engine clips
# the shifted read version to the oldest retained model
MAX_REPLAY = 1 << 20


class Effects(NamedTuple):
    """Merged per-slot fault effects over one popped/selected cohort.

    Identity values (False / 1.0 / 0.0 / 0) leave a slot untouched
    bitwise — the engines apply every channel through a per-slot
    ``where`` keyed on the non-identity entries.
    """

    kill: torch.Tensor  # (B,) bool — drop the slot's update mid-round
    delta_scale: torch.Tensor  # (B,) f32 — multiply the slot's delta
    noise_sigma: torch.Tensor  # (B,) f32 — gaussian noise added to the delta
    replay_shift: torch.Tensor  # (B,) i32 — serve an older ring version
    collude: torch.Tensor  # (B,) f32 — 0 = honest, else the coalition's
    #                         norm multiplier (update replaced by the
    #                         shared poisoned direction, norm-matched)


def identity_effects(shape, device=None) -> Effects:
    return Effects(
        kill=torch.zeros(shape, dtype=torch.bool, device=device),
        delta_scale=torch.ones(shape, dtype=torch.float32, device=device),
        noise_sigma=torch.zeros(shape, dtype=torch.float32, device=device),
        replay_shift=torch.zeros(shape, dtype=torch.int32, device=device),
        collude=torch.zeros(shape, dtype=torch.float32, device=device),
    )


def merge_effects(a: Effects, b: Effects) -> Effects:
    """Compose two faults' effects on the same cohort: kills OR, delta
    scales multiply, noise sigmas add (the conservative upper envelope of
    independent noises), replay shifts take the max, collusion multipliers
    take the max (two coalitions cannot both replace one slot's update)."""
    return Effects(
        kill=a.kill | b.kill,
        delta_scale=a.delta_scale * b.delta_scale,
        noise_sigma=a.noise_sigma + b.noise_sigma,
        replay_shift=torch.maximum(a.replay_shift, b.replay_shift),
        collude=torch.maximum(a.collude, b.collude),
    )


def effects_hit(eff: Effects) -> torch.Tensor:
    """(B,) bool — slots some armed fault actually touched this pop (the
    ground-truth label of ``fault_exposure`` evaluation)."""
    return (eff.kill | (eff.delta_scale != 1.0) | (eff.noise_sigma > 0.0)
            | (eff.replay_shift > 0) | (eff.collude > 0.0))


@dataclasses.dataclass(frozen=True)
class Fault:
    """One registered fault: per-client state + pure injection hooks."""

    name: str
    channels: Tuple[str, ...]  # of: kill latency scale noise replay collude
    rate: float = 0.0
    scope: str = "engine"  # engine | serve
    async_only: bool = False
    init: Optional[Callable] = None  # (draws) -> state dict
    # (fstate, draws, send (n,), latency (n,)) -> (fstate, latency)
    on_dispatch: Optional[Callable] = None
    # (fstate, draws, idx (B,), valid (B,)) -> (fstate, Effects)
    on_pop: Optional[Callable] = None


class FaultSet:
    """An ordered collection of engine-scope faults sharing one random
    source.

    The engines talk to the set, never to individual faults: ``init``
    builds the per-fault state dict keyed by fault name, ``on_dispatch``/
    ``on_pop`` thread the state through every fault (fault ``f`` draws from
    ``draws.sub(f.name)``) and merge the effects.
    """

    def __init__(self, faults):
        faults = tuple(faults)
        names = [f.name for f in faults]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate fault names in set: {names}")
        serve = [f.name for f in faults if f.scope != "engine"]
        if serve:
            raise ValueError(
                f"fault(s) {', '.join(serve)} are serve-scope (replica "
                "crashes): pass them to the serving loop, not to the "
                "training engines"
            )
        self.faults = faults
        self.channels = frozenset(c for f in faults for c in f.channels)

    def has(self, channel: str) -> bool:
        return channel in self.channels

    @property
    def has_dispatch(self) -> bool:
        return any(f.on_dispatch is not None for f in self.faults)

    @property
    def has_pop(self) -> bool:
        return any(f.on_pop is not None for f in self.faults)

    def async_only_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.faults if f.async_only)

    def names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.faults)

    def init(self, draws) -> Dict[str, Dict]:
        return {f.name: f.init(draws.sub(f.name)) for f in self.faults}

    def on_dispatch(self, fstate, draws, send, latency, layout=None):
        kw = {} if layout is None else {"layout": layout}
        for f in self.faults:
            if f.on_dispatch is None:
                continue
            sub, latency = f.on_dispatch(fstate[f.name], draws.sub(f.name),
                                         send, latency, **kw)
            fstate = {**fstate, f.name: sub}
        return fstate, latency

    def on_pop(self, fstate, draws, idx, valid, layout=None):
        kw = {} if layout is None else {"layout": layout}
        eff = identity_effects(idx.shape, idx.device)
        for f in self.faults:
            if f.on_pop is None:
                continue
            sub, e = f.on_pop(fstate[f.name], draws.sub(f.name), idx, valid, **kw)
            fstate = {**fstate, f.name: sub}
            eff = merge_effects(eff, e)
        return fstate, eff

    def counters(self, fstate) -> Dict[str, float]:
        return {f.name: float(fstate[f.name]["injected"]) for f in self.faults}

    def exposure(self, fstate) -> Dict[str, "np.ndarray"]:
        """Per-client hit tallies, one ``(n,)`` float array per fault, on
        the host: the ground truth of which clients were actually hit,
        surfaced on ``RunResult.fault_exposure`` when
        ``RunConfig.fault_exposure`` is set."""
        return {f.name: fstate[f.name]["exposed"].cpu().numpy()
                for f in self.faults}


def corrupt_updates(updated, bases, eff: Effects, draws,
                    has_scale: bool, has_noise: bool):
    """Apply the scale/noise channels to the cohort's trained params.

    ``updated`` is cohort-stacked; ``bases`` is the params each slot
    trained from (stacked, or the unstacked global tree — broadcasts).
    Each channel is applied *independently* through its own per-slot
    ``where``: scale rewrites a hit slot's update as ``base + scale *
    delta``, noise adds ``sigma * N(0, 1)`` (site ``noise/<leaf path>`` of
    ``draws``) to the hit slot's params. A missed slot keeps its exact
    input values (``b + (u - b)`` is not bitwise ``u`` in floating point),
    which is what makes a rate-0 corrupting fault set bitwise identity.
    """

    def one(path, u, b):
        ws = (-1,) + (1,) * (u.dim() - 1)
        if has_scale:
            hit = (eff.delta_scale != 1.0).view(ws)
            d = (u - b).to(torch.float32) * eff.delta_scale.view(ws)
            u = torch.where(hit, b + d.to(u.dtype), u)
        if has_noise:
            hit = (eff.noise_sigma > 0.0).view(ws)
            noise = eff.noise_sigma.view(ws) * draws.normal(f"noise/{path}",
                                                            u.shape)
            u = torch.where(hit, u + noise.to(u.dtype), u)
        return u

    return tree_map_with_path(one, updated, bases)


# Host-side RNG seed for the coalition's shared poisoned direction —
# fixed across rounds (that persistence is the attack: a drifting poison
# direction would average itself away in the aggregate). The reference's
# constant, so both packages embed the same direction.
COLLUDE_SEED = 0xC0A11D0
_COLLUDE_CACHE: dict = {}
_COLLUDE_DEVICE_CACHE: dict = {}


def _collude_direction(shapes):
    """Unit-norm (over the whole pytree) poison direction, cached by the
    per-slot leaf shapes in the reference's pytree order (dict keys
    sorted), so every engine embeds identical constants."""
    import numpy as np

    key = tuple(shapes)
    cached = _COLLUDE_CACHE.get(key)
    if cached is None:
        rng = np.random.default_rng(COLLUDE_SEED)
        leaves = [rng.standard_normal(shp).astype(np.float32)
                  for shp in shapes]
        gnorm = np.sqrt(sum(float((lv.astype(np.float64) ** 2).sum())
                            for lv in leaves)) or 1.0
        cached = [lv / np.float32(gnorm) for lv in leaves]
        _COLLUDE_CACHE[key] = cached
    return cached


def _collude_direction_on(shapes, device):
    """``_collude_direction`` as tensors on ``device``, copied there once
    (a host-to-device copy inside a step would sync with the host)."""
    key = (tuple(shapes), str(device))
    out = _COLLUDE_DEVICE_CACHE.get(key)
    if out is None:
        out = [torch.as_tensor(d, device=device)
               for d in _collude_direction(shapes)]
        _COLLUDE_DEVICE_CACHE[key] = out
    return out


def collude_updates(updated, bases, eff: Effects):
    """Apply the collude channel: a hit slot's update is replaced by
    ``base + mult * own_norm * shared_direction`` — the coalition's
    common poisoned direction, norm-matched to the slot's own honest
    delta (times the per-slot jitter multiplier), so per-slot norm
    statistics see nothing. Missed slots keep their exact input values
    (bitwise identity, like :func:`corrupt_updates`). No draw: the
    direction is a constant and the jitter was drawn at pop time.
    """
    items = tree_paths(updated)
    bases_by_path = dict(tree_paths(bases))
    shapes = tuple(tuple(u.shape[1:]) for _, u in items)
    dirs = dict(zip((p for p, _ in items),
                    _collude_direction_on(shapes, eff.collude.device)))
    # per-slot delta norms, summed over the leaves in the reference's order
    sq = sum(torch.sum(((u - bases_by_path[p]).to(torch.float32)) ** 2,
                       dim=tuple(range(1, u.dim())))
             for p, u in items)
    mag = torch.sqrt(sq) * eff.collude  # (B,) target norms, 0 if missed
    hit = eff.collude > 0.0

    def one(path, u, b):
        ws = (-1,) + (1,) * (u.dim() - 1)
        poison = b + (mag.view(ws) * dirs[path]).to(u.dtype)
        return torch.where(hit.view(ws), poison, u)

    return tree_map_with_path(one, updated, bases)


# ---------------------------------------------------------------------------
# Built-in faults
# ---------------------------------------------------------------------------


def _prone_init(n: int, client_frac: float):
    """Persistent susceptible-client mask + injection counter."""
    if not 0.0 <= client_frac <= 1.0:
        raise ValueError(f"client_frac must be in [0, 1], got {client_frac}")

    def init(draws):
        dev = draws.device
        if client_frac >= 1.0:
            prone = torch.ones((n,), dtype=torch.bool, device=dev)
        else:
            prone = draws.uniform("prone", (n,)) < client_frac
        return {
            "prone": prone,
            "injected": torch.zeros((), dtype=torch.float32, device=dev),
            # per-client hit tally — ground truth for detection P/R and the
            # opt-in RunResult.fault_exposure surface
            "exposed": torch.zeros((n,), dtype=torch.float32, device=dev),
        }

    return init


def _check_rate(name: str, rate: float) -> None:
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"{name}: rate must be in [0, 1], got {rate}")


def _cohort_hit(fst, draws, idx, valid, rate, layout=None):
    """Per-slot injection coin among prone, valid cohort members."""
    prone = fst["prone"]
    hit = (prone[idx] if layout is None else layout.gather(prone, idx)) & valid
    if rate < 1.0:
        hit = hit & (draws.uniform("hit", tuple(idx.shape)) < rate)
    return hit


def _count(fst, hit, idx=None, layout=None):
    """Bump the scalar injection counter and the per-client exposure
    tally. ``idx`` given means ``hit`` is cohort-shaped: an ``index_add``
    at the cohort's client indices, where a missed or padded slot adds an
    exact 0 (the values are 0/1, so the sum is exact in any order, as the
    reference's ``.at[idx].add(h, mode="drop")``); ``idx=None`` means
    ``hit`` is already fleet-shaped (dispatch-side faults): under a sharded
    ``layout`` (``core.fleet``) this rank's block, whose count is summed
    over ranks (exact: 0/1 values); a cohort's ``idx`` adds only on its
    owner."""
    h = hit.to(torch.float32)
    if idx is None:
        exposed = fst["exposed"] + h
        total = h.sum() if layout is None else layout.psum(h.sum())
    else:
        exposed = (fst["exposed"].index_add(0, idx, h) if layout is None
                   else layout.index_add(fst["exposed"], idx, h))
        total = h.sum()
    return {**fst, "injected": fst["injected"] + total, "exposed": exposed}


def _where_hit(hit, value, identity):
    """(B,) f32: ``value`` on hit slots, ``identity`` elsewhere (fills, so
    no host-to-device copy of a scalar)."""
    return torch.full(hit.shape, identity, dtype=torch.float32,
                      device=hit.device).masked_fill(hit, value)


@register_fault("dropout")
def make_dropout(n: int, rate: float, client_frac: float = 1.0) -> Fault:
    """Mid-round dropout: the client trained but its update never arrives
    — the slot is excluded from aggregation like a dropped buffer slot."""
    _check_rate("dropout", rate)

    def on_pop(fst, draws, idx, valid, layout=None):
        hit = _cohort_hit(fst, draws, idx, valid, rate, layout)
        eff = identity_effects(idx.shape, idx.device)._replace(kill=hit)
        return _count(fst, hit, idx, layout), eff

    return Fault("dropout", channels=("kill",), rate=rate,
                 init=_prone_init(n, client_frac), on_pop=on_pop)


@register_fault("straggler")
def make_straggler(n: int, rate: float, stall: float = 10.0,
                   client_frac: float = 1.0) -> Fault:
    """Straggler stall: a dispatched client's wall-clock latency is
    multiplied by ``stall`` — it completes eventually, arbitrarily stale
    (and past any re-dispatch deadline). Async only."""
    _check_rate("straggler", rate)
    if stall <= 0:
        raise ValueError(f"straggler: stall must be > 0, got {stall}")

    def on_dispatch(fst, draws, send, latency, layout=None):
        hit = fst["prone"] & send
        if rate < 1.0:
            coin = draws.uniform("hit", (n,))
            hit = hit & ((coin if layout is None else layout.block(coin)) < rate)
        latency = torch.where(hit, latency * stall, latency)
        return _count(fst, hit, layout=layout), latency

    return Fault("straggler", channels=("latency",), rate=rate,
                 async_only=True, init=_prone_init(n, client_frac),
                 on_dispatch=on_dispatch)


@register_fault("stale_replay")
def make_stale_replay(n: int, rate: float, shift: int = MAX_REPLAY,
                      client_frac: float = 1.0) -> Fault:
    """Stale replay: the client ignores the model it was handed and
    trains from a version ``shift`` older (clipped to the oldest retained
    ring slot). Staleness *weighting* still sees the honest dispatch
    version — the attack is exactly that the discount does not know.
    Async only: the sync engine has no version ring to replay from."""
    _check_rate("stale_replay", rate)
    if shift < 1:
        raise ValueError(f"stale_replay: shift must be >= 1, got {shift}")

    def on_pop(fst, draws, idx, valid, layout=None):
        hit = _cohort_hit(fst, draws, idx, valid, rate, layout)
        eff = identity_effects(idx.shape, idx.device)._replace(
            replay_shift=hit.to(torch.int32) * shift
        )
        return _count(fst, hit, idx, layout), eff

    return Fault("stale_replay", channels=("replay",), rate=rate,
                 async_only=True, init=_prone_init(n, client_frac),
                 on_pop=on_pop)


@register_fault("corrupt")
def make_corrupt(n: int, rate: float, sigma: float = 1.0,
                 client_frac: float = 1.0) -> Fault:
    """Corrupted update: gaussian noise of scale ``sigma`` added to the
    slot's delta (bit flips, truncated uploads, garbage gradients)."""
    _check_rate("corrupt", rate)
    if sigma <= 0:
        raise ValueError(f"corrupt: sigma must be > 0, got {sigma}")

    def on_pop(fst, draws, idx, valid, layout=None):
        hit = _cohort_hit(fst, draws, idx, valid, rate, layout)
        eff = identity_effects(idx.shape, idx.device)._replace(
            noise_sigma=_where_hit(hit, sigma, 0.0)
        )
        return _count(fst, hit, idx, layout), eff

    return Fault("corrupt", channels=("noise",), rate=rate,
                 init=_prone_init(n, client_frac), on_pop=on_pop)


@register_fault("sign_flip")
def make_sign_flip(n: int, rate: float, client_frac: float = 1.0) -> Fault:
    """Sign-flipping attacker: the slot submits ``-delta``, steering the
    aggregate away from its own descent direction."""
    _check_rate("sign_flip", rate)

    def on_pop(fst, draws, idx, valid, layout=None):
        hit = _cohort_hit(fst, draws, idx, valid, rate, layout)
        eff = identity_effects(idx.shape, idx.device)._replace(
            delta_scale=_where_hit(hit, -1.0, 1.0)
        )
        return _count(fst, hit, idx, layout), eff

    return Fault("sign_flip", channels=("scale",), rate=rate,
                 init=_prone_init(n, client_frac), on_pop=on_pop)


@register_fault("scale_attack")
def make_scale_attack(n: int, rate: float, factor: float = 10.0,
                      client_frac: float = 1.0) -> Fault:
    """Scaled-update (model replacement) attacker: the slot's delta is
    boosted ``factor``x to dominate the aggregate."""
    _check_rate("scale_attack", rate)
    if factor == 1.0:
        raise ValueError("scale_attack: factor=1.0 is a no-op")

    def on_pop(fst, draws, idx, valid, layout=None):
        hit = _cohort_hit(fst, draws, idx, valid, rate, layout)
        eff = identity_effects(idx.shape, idx.device)._replace(
            delta_scale=_where_hit(hit, factor, 1.0)
        )
        return _count(fst, hit, idx, layout), eff

    return Fault("scale_attack", channels=("scale",), rate=rate,
                 init=_prone_init(n, client_frac), on_pop=on_pop)


@register_fault("collude")
def make_collude(n: int, rate: float, client_frac: float = 0.25,
                 jitter: float = 0.2) -> Fault:
    """Colluding coalition: ``client_frac`` of the fleet shares one
    fixed poisoned direction (see :data:`COLLUDE_SEED`); each hit slot
    submits it norm-matched to its own honest delta times a lognormal
    jitter ``exp(jitter * N(0, 1))`` (site ``jitter``) — per-slot norm
    statistics see an ordinary update, only cross-client direction
    *agreement over time* gives the coalition away."""
    _check_rate("collude", rate)
    if jitter < 0:
        raise ValueError(f"collude: jitter must be >= 0, got {jitter}")

    def on_pop(fst, draws, idx, valid, layout=None):
        hit = _cohort_hit(fst, draws, idx, valid, rate, layout)
        mult = torch.exp(jitter * draws.normal("jitter", tuple(idx.shape)))
        eff = identity_effects(idx.shape, idx.device)._replace(
            collude=torch.where(hit, mult, torch.zeros_like(mult)))
        return _count(fst, hit, idx, layout), eff

    return Fault("collude", channels=("collude",), rate=rate,
                 init=_prone_init(n, client_frac), on_pop=on_pop)


@register_fault("replica_crash")
def make_replica_crash(n: int, rate: float) -> Fault:
    """Serve-tier replica crash: each tick, each alive replica dies with
    probability ``rate`` (the last alive replica is spared so the pool
    can always drain). Consumed by the serving loop (ROADMAP queue 1,
    slice H); the training engines reject it."""
    _check_rate("replica_crash", rate)
    return Fault("replica_crash", channels=(), rate=rate, scope="serve")
