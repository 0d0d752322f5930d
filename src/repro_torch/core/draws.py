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

``step(r)`` gives the source for step ``r``: a generator source returns
itself (its stream simply advances), a replay source its table for ``r``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

_TINY = float(np.finfo(np.float32).tiny)


class GeneratorDraws:
    """Draws from one ``torch.Generator`` seeded with ``seed`` on ``device``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def step(self, r: int) -> "GeneratorDraws":
        return self

    def uniform(self, site: str, shape, low: float = 0.0, high: float = 1.0):
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return u * (high - low) + low if (low, high) != (0.0, 1.0) else u

    def normal(self, site: str, shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    def exponential(self, site: str, shape):
        out = torch.empty(shape, device=self.device)
        return out.exponential_(generator=self.generator)

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
                 _table: Optional[Mapping[str, np.ndarray]] = None):
        self.device = torch.device(device)
        self._init = dict(init)
        self._steps = list(steps)
        self._table: Dict[str, np.ndarray] = dict(
            self._init if _table is None else _table
        )

    def step(self, r: int) -> "ReplayDraws":
        if r >= len(self._steps):
            raise IndexError(f"replay has {len(self._steps)} steps, asked for {r}")
        return ReplayDraws(self._init, self._steps, self.device,
                           _table=self._steps[r])

    def _get(self, site: str, shape, dtype):
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

    def permutation(self, site, n, batch=()):
        return self._get(site, tuple(batch) + (n,), torch.int64)

    def categorical(self, site, probs, shape):
        return self._get(site, shape, torch.int64)
