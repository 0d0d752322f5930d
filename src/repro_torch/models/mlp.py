"""Dense MLP blocks: gated (SwiGLU) and ungated (GELU).

Port of ``repro.models.mlp`` with the same parameter layouts (``w_in``,
``w_gate`` (d_model, d_ff), ``w_out`` (d_ff, d_model)).

Under a mesh whose ``model`` axis splits ``d_ff`` (the rules of
``sharding.py``), each rank holds the columns of ``w_in`` and ``w_gate``
and the rows of ``w_out`` of its ``d_ff / tp`` block (Megatron tensor
parallelism): the input enters through ``pshard.enter`` and the rank's
partial output is summed over ``model`` (``pshard.leave``). The two paths
of the reference differ in what the sum moves:

  * GSPMD (default): the reference's partitioner widens bf16 dot outputs
    to f32 before it places the all-reduce, so the partial sums cross in
    f32 and are cast after the sum; the backward's sum of the input's
    gradient crosses in f32 too. The port computes the row-parallel
    product in f32 and sums that.
  * ``explicit_tp``: the reference's ``shard_map`` with a hand-placed
    ``psum`` AFTER the cast to the activation dtype; both sums move bf16
    bytes in a bf16 model, half the GSPMD path's (``pshard.counts``).

A ``d_ff`` that ``model`` does not split leaves the MLP replicated.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import MLPSpec
from repro_torch.models import pshard
from repro_torch.models.common import activation, dense_init


def init_mlp(gen: torch.Generator, d_model: int, spec: MLPSpec, dtype) -> Dict:
    p = {
        "w_in": dense_init(gen, (d_model, spec.d_ff), 0, dtype),
        "w_out": dense_init(gen, (spec.d_ff, d_model), 0, dtype),
    }
    if spec.activation == "silu":  # gated
        p["w_gate"] = dense_init(gen, (d_model, spec.d_ff), 0, dtype)
    return p


def sharded_dims(spec: MLPSpec) -> Dict:
    """The dims each leaf's block keeps as it lies over ``model`` (all of
    them: the MLP is column- then row-parallel wherever ``d_ff`` splits)."""
    return {"w_in": (1,), "w_gate": (1,), "w_out": (0,)}


def mlp_fwd(p: Dict, x: torch.Tensor, spec: MLPSpec,
            explicit_tp: bool = False) -> torch.Tensor:
    """``p`` holds the rank's ``d_ff`` block under a mesh (full leaves
    without one). ``explicit_tp`` takes the reference's explicit path
    where the reference does: a gated MLP on a (B, S, d) input."""
    act = activation(spec.activation)
    if p["w_in"].shape[-1] != spec.d_ff:  # the rank's d_ff block
        explicit = explicit_tp and x.dim() == 3 and "w_gate" in p
        wire = None if explicit else torch.float32
        x = pshard.enter(x, wire)
        h = x @ p["w_in"]
        h = act(x @ p["w_gate"]) * h if "w_gate" in p else act(h)
        if explicit:  # the cast happens BEFORE the collective
            return pshard.leave((h @ p["w_out"]).to(x.dtype))
        return pshard.leave(h.float() @ p["w_out"].float()).to(x.dtype)
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    return h @ p["w_out"]
