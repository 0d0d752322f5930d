"""Minimal optimizer library: SGD(+momentum, Nesterov) and AdamW.

    opt = sgd(momentum=0.9)
    state = opt.init(params)
    params, state = opt.update(params, grads, state, lr)

Port of ``repro.optim.optimizers``: functional ``init``/``update`` over
param trees (nested dicts and tuples of tensors), returning new trees.
AdamW keeps its moments in float32 and casts each updated leaf back to
the leaf's dtype; its step count ``t`` is an int32 tensor on the params'
device. ``lr`` is a Python float or a 0-d tensor on the params' device.
SGD scales in the leaf's dtype with its scalars rounded to that dtype
first, as the reference's weakly typed Python scalars are (``weak``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.tree import tree_leaves, tree_map


def weak(x, dtype):
    """The scalar ``x`` as a weakly typed JAX scalar meets a ``dtype``
    array: rounded to ``dtype`` (a bf16 leaf scales by bf16(0.9), not 0.9).
    A Python number stays on the host; a tensor is cast on its device."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.tensor(x, dtype=dtype).item()


def scale(lr, g, dtype):
    """``lr * g`` in ``dtype``, as the reference's ``lr * g.astype(dtype)``."""
    return weak(lr, dtype) * g.to(dtype)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (params, grads, state, lr) -> (params, state)


def sgd(momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """Paper's local optimizer is plain SGD (Sec. IV)."""

    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": tree_map(torch.zeros_like, params)}

    def update(params, grads, state, lr):
        if momentum == 0.0:
            new = tree_map(lambda p, g: p - scale(lr, g, p.dtype), params, grads)
            return new, state
        m = tree_map(lambda m_, g: weak(momentum, m_.dtype) * m_ + g, state["m"], grads)
        step = (tree_map(lambda g, m_: g + weak(momentum, m_.dtype) * m_, grads, m)
                if nesterov else m)
        new = tree_map(lambda p, s: p - scale(lr, s, p.dtype), params, step)
        return new, {"m": m}

    return Optimizer(f"sgd(m={momentum})", init, update)


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        device = tree_leaves(params)[0].device
        return {
            "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "t": torch.zeros((), dtype=torch.int32, device=device),
        }

    def update(params, grads, state, lr):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(b1, tf)
        bc2 = 1 - torch.pow(b2, tf)

        def upd(p, m_, v_):
            step = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * step).to(p.dtype)

        new = tree_map(upd, params, m, v)
        return new, {"m": m, "v": v, "t": t}

    return Optimizer("adamw", init, update)
