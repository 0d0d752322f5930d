"""Dense MLP blocks: gated (SwiGLU) and ungated (GELU).

Port of ``repro.models.mlp`` with the same parameter layouts (``w_in``,
``w_gate`` (d_model, d_ff), ``w_out`` (d_ff, d_model)). The reference's
explicit tensor-parallel branch (``explicit_tp``, built on
``models/pshard.py``) is model parallelism of the LM, not fleet sharding: it
comes with ``sharding.py`` and ``pshard.py`` in ROADMAP queue 1, slice I.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import MLPSpec
from repro_torch.models.common import activation, dense_init


def init_mlp(gen: torch.Generator, d_model: int, spec: MLPSpec, dtype) -> Dict:
    p = {
        "w_in": dense_init(gen, (d_model, spec.d_ff), 0, dtype),
        "w_out": dense_init(gen, (spec.d_ff, d_model), 0, dtype),
    }
    if spec.activation == "silu":  # gated
        p["w_gate"] = dense_init(gen, (d_model, spec.d_ff), 0, dtype)
    return p


def mlp_fwd(p: Dict, x: torch.Tensor, spec: MLPSpec) -> torch.Tensor:
    act = activation(spec.activation)
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    return h @ p["w_out"]
