"""Learning-rate schedules. The paper uses lr0=0.1 with decay 0.998/round.

Port of ``repro.optim.schedules``: each schedule maps an integer ``step``
tensor to a float32 tensor of its shape on its device, built from Python
scalars (no host-to-device copy, no host sync).
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full(step.shape, lr, dtype=torch.float32, device=step.device)


def exponential_decay(lr0: float, decay: float):
    """Paper Sec. IV: lr_t = lr0 * decay^t (decay per communication round)."""
    return lambda step: lr0 * torch.pow(decay, step.to(torch.float32))


def cosine(lr0: float, total_steps: int, lr_min: float = 0.0):
    def f(step):
        frac = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
        return lr_min + 0.5 * (lr0 - lr_min) * (1 + torch.cos(math.pi * frac))

    return f


def warmup_cosine(lr0: float, warmup: int, total_steps: int, lr_min: float = 0.0):
    cos = cosine(lr0, max(total_steps - warmup, 1), lr_min)

    def f(step):
        w = torch.clamp(step.to(torch.float32) / max(warmup, 1), max=1.0)
        return torch.where(step < warmup, lr0 * w, cos(step - warmup))

    return f
