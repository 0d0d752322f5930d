"""Learning-rate schedules. The paper uses lr0=0.1 with decay 0.998/round."""
from __future__ import annotations

import torch


def exponential_decay(lr0: float, decay: float):
    """Paper Sec. IV: lr_t = lr0 * decay^t (decay per communication round);
    ``step`` is an integer tensor, the result float32 of its shape (a
    Python-scalar base: no host-to-device copy)."""
    return lambda step: lr0 * torch.pow(decay, step.to(torch.float32))
