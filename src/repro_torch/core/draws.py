"""Random draws of the port, behind one interface with two sources.

The JAX reference draws from threefry keys on a fixed schedule
(``fold_in(k_run, r)`` per step, then splits and folds inside the step);
torch cannot reproduce those bits. So every draw site of the port names
itself and asks a ``Draws`` source for a primitive draw:

  * ``GeneratorDraws`` draws from one explicit ``torch.Generator`` on the
    run's device — real runs;
  * ``ReplayDraws`` hands back arrays it was fed, site by site and step by
    step — parity tests feed it the arrays the reference drew under its
    own key schedule, so discrete outputs can be compared exactly.

Sites used by the calm async path:

  init: ``params/<layer>`` (normal), ``policy_init`` (policy-specific),
  ``speed`` (normal); per step: ``select`` (policy-specific),
  ``latency_compute`` (normal), ``latency_comm`` (exponential),
  ``dropout`` (uniform), ``local_perm`` (permutations), ``avail_gap``
  (exponential).

Sites used by the calm sync path (``engine/sync.py``):

  init: ``params/<layer>``, ``policy_init``; per round: ``select``, then
  ``local_perm`` with one ``(epochs, examples)`` block per cohort slot
  over all ``width`` slots, padding included. The reference draws these
  from ``split(key, 3)`` at init and ``split(fold_in(k_run, r))`` per
  round, then ``split(k_local, width)``; it has no latency draws.
  ``sim.latency.simulate_sync_duration`` draws ``speed`` at init and
  ``latency_compute``/``latency_comm`` per round.

Named sub-streams (``sub(name)``) keep the draws of the armed robustness
tier off the calm stream: a fault coin drawn from the run's stream would
shift every later ``local_perm`` draw, so a rate-0 armed run would stop
being the calm run. The reference keeps them apart the same way, on
dedicated key folds (104 for the hop latency, 105 and its sub-folds 0/1/2,
106/107 for re-dispatch, 108 and its sub-folds 0/1 for the defense,
``fold_in(k_run, 2**31)`` or ``fold_in(key, 7)`` at init). Sites of the
sub-streams, as ``ReplayDraws`` names them:

  ``faults/<fault>/prone`` (uniform, init; only for ``client_frac`` < 1),
  ``faults/<fault>/hit`` (uniform per step: ``(n,)`` at dispatch for
  ``straggler``, ``(B,)`` at the pop for the others; not drawn at rate 1),
  ``faults/collude/jitter`` (normal, ``(B,)``), ``faults/noise/<leaf>``
  (normal, one per param leaf, ``<leaf>`` its path such as ``fc1/w``);
  ``redispatch/latency_compute`` and ``redispatch/latency_comm`` (the
  retry latency, drawn every step the deadline is armed);
  ``hop/<i>/latency_compute`` and ``hop/<i>/latency_comm`` (a multi-tier
  topology's per-hop latency, every step: hop ``i`` = 0 is the client ->
  tier-0 link, ``(n,)``; hop ``i`` >= 1 the ``(E,)`` draws of the tier
  above, or of gossip round ``i - 1``; the reference's ``i``-th split of
  its fold-104 key) and ``redispatch/hop/<i>/...`` (the same for a
  re-dispatch, its fold 107); ``defense/probation`` and ``defense/readmit``
  (the quarantine chain's coins: uniform ``(n,)``, both drawn every step
  the defense is armed, in that order; the reference's fold-108 sub-folds
  0 and 1).

The serving tier (``repro_torch.serve``, ``sim.arrivals``) draws from the
sub-streams ``router`` (the router's ``policy_init`` at init and its
``select`` per decision: ``step(d)`` is decision ``d``), ``crash`` (site
``hit``, uniform ``(R,)`` per tick: ``step(t)`` is tick ``t``) and, for a
request trace, the sites ``counts`` (Poisson), ``gen_len`` (normal) and
``prompt`` (integers).

A replayed Bernoulli coin is the reference's ``uniform(key, shape) < p``
(that is how ``jax.random.bernoulli`` draws), so the port compares the
fed uniform with the rate.

``step(r)`` gives the source for step ``r``: a generator source returns
itself (its stream simply advances), a replay source its table for ``r``.
``GeneratorDraws.get_state()``/``set_state()`` carry every generator
stream (the run's and each sub-stream) through a checkpoint; a replay,
indexed by step, has none.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

_TINY = float(np.finfo(np.float32).tiny)


def _sub_seed(seed: int, name: str) -> int:
    """Seed of the sub-stream ``name`` of a stream seeded with ``seed``: a
    fixed function of both (not Python's salted ``hash``)."""
    digest = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


class GeneratorDraws:
    """Draws from one ``torch.Generator`` seeded with ``seed`` on ``device``;
    ``sub(name)`` is a child with its own generator, made once per name."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._subs: Dict[str, "GeneratorDraws"] = {}

    def step(self, r: int) -> "GeneratorDraws":
        return self

    def sub(self, name: str) -> "GeneratorDraws":
        """The sub-stream ``name``: the same child every call (and so every
        step), seeded by ``_sub_seed(seed, name)``."""
        child = self._subs.get(name)
        if child is None:
            child = self._subs[name] = GeneratorDraws(_sub_seed(self.seed, name),
                                                      self.device)
        return child

    def get_state(self) -> Dict[str, torch.Generator]:
        """A copy of every stream made so far, by path (``""`` is this
        stream, ``"faults/dropout"`` a sub-stream of a sub-stream)."""
        out = {"": _copy_generator(self.generator)}
        for name, child in self._subs.items():
            out.update({f"{name}/{k}".rstrip("/"): g
                        for k, g in child.get_state().items()})
        return out

    def set_state(self, states: Mapping[str, torch.Generator]) -> None:
        """Restore the streams of ``get_state`` (making any sub-stream that
        this source has not made yet)."""
        for path, gen in states.items():
            node = self
            for name in filter(None, path.split("/")):
                node = node.sub(name)
            node.generator.set_state(gen.get_state())

    def uniform(self, site: str, shape, low: float = 0.0, high: float = 1.0):
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return u * (high - low) + low if (low, high) != (0.0, 1.0) else u

    def normal(self, site: str, shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    def exponential(self, site: str, shape):
        out = torch.empty(shape, device=self.device)
        return out.exponential_(generator=self.generator)

    def poisson(self, site: str, rate: float, shape):
        lam = torch.full(tuple(shape), float(rate), device=self.device)
        return torch.poisson(lam, generator=self.generator).to(torch.int64)

    def randint(self, site: str, low: int, high: int, shape):
        return torch.randint(low, high, tuple(shape), generator=self.generator,
                             device=self.device)

    def gumbel(self, site: str, shape):
        u = self.uniform(site, shape).clamp_min(_TINY)
        return -torch.log(-torch.log(u))

    def permutation(self, site: str, n: int, batch: Sequence[int] = ()):
        """``batch + (n,)`` independent uniform permutations of ``range(n)``
        (argsort of uniforms: ties have probability ~0 and break stably)."""
        u = torch.rand(tuple(batch) + (n,), generator=self.generator,
                       device=self.device)
        return torch.argsort(u, dim=-1, stable=True)

    def categorical(self, site: str, probs, shape):
        p = torch.as_tensor(np.asarray(probs, np.float64), dtype=torch.float32,
                            device=self.device)
        count = int(np.prod(shape))
        out = torch.multinomial(p, count, replacement=True,
                                generator=self.generator)
        return out.reshape(shape)


class ReplayDraws:
    """Replays fed arrays: ``init`` holds the init-time sites, ``steps[r]``
    the sites of step ``r``. A site that was not fed, or a fed array of
    the wrong shape, raises — a replay never invents a draw. A replayed
    ``uniform`` is the reference's draw as it came out, already scaled to
    its ``[low, high)``."""

    def __init__(self, init: Mapping[str, np.ndarray],
                 steps: Sequence[Mapping[str, np.ndarray]], device,
                 _table: Optional[Mapping[str, np.ndarray]] = None,
                 _prefix: str = ""):
        self.device = torch.device(device)
        self._init = dict(init)
        self._steps = list(steps)
        self._table: Dict[str, np.ndarray] = dict(
            self._init if _table is None else _table
        )
        self._prefix = _prefix

    def step(self, r: int) -> "ReplayDraws":
        if r >= len(self._steps):
            raise IndexError(f"replay has {len(self._steps)} steps, asked for {r}")
        return ReplayDraws(self._init, self._steps, self.device,
                           _table=self._steps[r], _prefix=self._prefix)

    def sub(self, name: str) -> "ReplayDraws":
        """The same table, its sites read under ``<name>/``."""
        return ReplayDraws(self._init, self._steps, self.device,
                           _table=self._table, _prefix=f"{self._prefix}{name}/")

    def _get(self, site: str, shape, dtype):
        site = self._prefix + site
        if site not in self._table:
            raise KeyError(f"replay was not fed draw site {site!r}; fed: "
                           f"{sorted(self._table)}")
        arr = np.asarray(self._table[site])
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"replayed {site!r} has shape {arr.shape}, the "
                             f"port asked for {tuple(shape)}")
        return torch.tensor(arr, device=self.device).to(dtype)

    def uniform(self, site, shape, low=0.0, high=1.0):
        return self._get(site, shape, torch.float32)

    def normal(self, site, shape):
        return self._get(site, shape, torch.float32)

    def exponential(self, site, shape):
        return self._get(site, shape, torch.float32)

    def gumbel(self, site, shape):
        return self._get(site, shape, torch.float32)

    def poisson(self, site, rate, shape):
        return self._get(site, shape, torch.int64)

    def randint(self, site, low, high, shape):
        return self._get(site, shape, torch.int64)

    def permutation(self, site, n, batch=()):
        return self._get(site, tuple(batch) + (n,), torch.int64)

    def categorical(self, site, probs, shape):
        return self._get(site, shape, torch.int64)


def _copy_generator(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out
