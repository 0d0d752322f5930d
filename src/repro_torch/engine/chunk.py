"""Chunked execution of an engine's step function.

``ChunkRunner`` advances ``length`` steps per host transfer: a Python loop
of steps (the reference's ``lax.scan``) that keeps the whole engine state
and every accumulator on the device, folds the device-resident selection
accumulators (``core.load_metric.update_selection_accum``) after every
step, and stacks the per-step aux outputs on the device, so the caller
makes one host transfer per chunk and no step pulls an ``(n,)`` vector.
Step ``r`` draws from ``draws.step(r)``, so a chunk equals its steps run
one by one.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.load_metric import update_selection_accum

# state keys the runner owns; the engine step function never sees them
_RUNNER_KEYS = ("load_acc",)


class ChunkRunner:
    """Chunked driver over ``step(state, draws) -> (state, aux)``.

    ``aux`` contains at least ``send`` (the (n,) bool selection vector) plus
    any per-step scalars; ``aux_keys`` names the entries stacked and
    returned per step, and ``send`` is stacked too when the caller asks for
    history.
    """

    def __init__(self, step_fn: Callable, aux_keys: Tuple[str, ...],
                 layout=None):
        self._step_fn = step_fn
        self._aux_keys = aux_keys
        # a sharded ``core.fleet`` layout: ``send`` is this rank's block
        self._layout = layout

    def __call__(self, state: Dict, draws, r0: int, length: int,
                 with_history: bool):
        """Advance ``length`` steps from global step ``r0``; returns
        ``(state', stacked_aux)`` with a leading ``length`` axis on every
        aux entry, still on the device."""
        ys = {k: [] for k in self._aux_keys + (("send",) if with_history else ())}
        for r in range(r0, r0 + length):
            inner = {k: v for k, v in state.items() if k not in _RUNNER_KEYS}
            inner, aux = self._step_fn(inner, draws.step(r))
            state = {**inner,
                     "load_acc": update_selection_accum(state["load_acc"],
                                                        aux["send"],
                                                        self._layout)}
            for k in ys:
                ys[k].append(aux[k])
        return state, {k: torch.stack(v) for k, v in ys.items()}


def step_once(runner: ChunkRunner, state: Dict, draws, r: int):
    """One engine step through the chunk runner (a length-1 chunk), so the
    per-step and chunk paths share one implementation of the runner's
    bookkeeping. Returns ``(state', aux)`` with ``send`` included."""
    state, aux = runner(state, draws, r, 1, with_history=True)
    return state, {k: v[0] for k, v in aux.items()}
