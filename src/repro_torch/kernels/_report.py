"""Where a hand-written kernel's wrapper reports the work of each call.

A kernel's launch goes through ctypes, which no dispatch mode sees, so each
wrapper runs its route (the launch on the card, the outputs' shapes on the
meta device) inside ``call(name, cost)``. With no listener it does nothing.
With listeners (``roofline.op_cost.analyze`` subscribes one for the length
of its call) it marks the route as running, so a listener can keep the
route's own aten ops (outputs, workspaces, layout copies) out of its tally,
and once the route returns it hands each listener ``name`` and the
(FLOPs, bytes read, bytes written) that ``cost()`` gives.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List

_LISTENERS: List[Callable] = []
_DEPTH = [0]
_NULL = contextlib.nullcontext()


def listen(fn: Callable) -> None:
    """Call ``fn(name, flops, bytes_read, bytes_written)`` after each route."""
    _LISTENERS.append(fn)


def unlisten(fn: Callable) -> None:
    _LISTENERS.remove(fn)


def inside() -> bool:
    """True while a kernel's route runs."""
    return _DEPTH[0] > 0


@contextlib.contextmanager
def _reported(name: str, cost: Callable):
    _DEPTH[0] += 1
    try:
        yield
    finally:
        _DEPTH[0] -= 1
    flops, nread, nwritten = cost()
    for fn in list(_LISTENERS):
        fn(name, flops, nread, nwritten)


def call(name: str, cost: Callable):
    """The context a kernel wrapper runs its route in (module docstring)."""
    return _reported(name, cost) if _LISTENERS else _NULL
