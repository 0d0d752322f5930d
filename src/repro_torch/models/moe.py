"""Mixture-of-experts layer with capacity-based dispatch (GShard/Switch
style), shared experts (deepseek-v2 / llama4), and the Switch load-balance
auxiliary loss.

Port of ``repro.models.moe`` with the same parameter layouts (``router``
(d_model, E) in f32 whatever the tree's dtype, ``w_in``/``w_gate``
(E, d_model, F), ``w_out`` (E, F, d_model), ``shared_*``) and the same
capacity semantics: tokens go in groups of ``G = min(group_size, T)``; each
expert takes at most ``C = max(min(G * top_k * capacity_factor / E, G),
top_k)`` of a group's routes, filled in token order over a top_k-step loop
(route k of every token after route k - 1 of every token), the exclusive
positions from an f32 ``cumsum``; a route whose position reaches C is
dropped (the token still gets the shared experts and the residual).

No TPU kernel lies behind it. Dispatch, expert compute and combine are
batched ``einsum``s over one-hot (nb, G, E, C) tensors, as in the
reference; the combine is a product with the one-hots, never a scatter-add,
so its sums have a fixed order. Everything here runs under
``torch.func.vmap(grad)`` (the FL clients' training): no in-place op, no
data-dependent shape, no host read. Two places where torch differs from
JAX are pinned: top-k ties go to the lower expert index (a stable
descending sort, as ``lax.top_k``), and a position equal to C one-hots to
zeros (a comparison with ``arange(C)``, as ``jax.nn.one_hot``; torch's
``one_hot`` would raise).

The serving pool routes each slot's token as its own group
(``group_size=1``): the reference vmaps its batch-1 decode step over the
slots, so a slot's token never shares capacity with another slot's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import MoESpec
from repro_torch.models.common import activation, dense_init

DEFAULT_GROUP = 128


def init_moe(gen: torch.Generator, d_model: int, spec: MoESpec, dtype) -> Dict:
    E, F = spec.num_experts, spec.d_ff_expert
    p = {
        "router": dense_init(gen, (d_model, E), 0, torch.float32),
        "w_in": dense_init(gen, (E, d_model, F), 1, dtype),
        "w_gate": dense_init(gen, (E, d_model, F), 1, dtype),
        "w_out": dense_init(gen, (E, F, d_model), 1, dtype),
    }
    if spec.num_shared:
        Fs = spec.d_ff_shared * spec.num_shared
        p["shared_in"] = dense_init(gen, (d_model, Fs), 0, dtype)
        p["shared_gate"] = dense_init(gen, (d_model, Fs), 0, dtype)
        p["shared_out"] = dense_init(gen, (Fs, d_model), 0, dtype)
    return p


def _capacity(group: int, spec: MoESpec) -> int:
    c = int(group * spec.top_k * spec.capacity_factor / spec.num_experts)
    return max(min(c, group), spec.top_k)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, highest first, ties
    to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_fwd(p: Dict, x: torch.Tensor, spec: MoESpec,
            group_size: int = DEFAULT_GROUP) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> (y, metrics ``aux_loss``, ``drop_frac``,
    ``router_entropy``, f32 0-d tensors). Routes beyond an expert's
    capacity are dropped."""
    B, S, d = x.shape
    T = B * S
    G = min(group_size, T)
    if T % G:
        raise ValueError(f"{T} tokens do not split into groups of {G}")
    nb = T // G
    E, K = spec.num_experts, spec.top_k
    C = _capacity(G, spec)

    xt = x.reshape(T, d)
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gate_k, idx_k = top_k(probs, K)  # (T, K)
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)

    # Switch aux loss over the whole batch
    me = probs.mean(0)
    ce = _one_hot(idx_k, E, torch.float32).sum(1).mean(0) / K
    aux_loss = E * torch.sum(me * ce)

    cdt = x.dtype
    xg = xt.reshape(nb, G, d)
    idx_g = idx_k.reshape(nb, G, K)
    gate_g = gate_k.reshape(nb, G, K)

    # dispatch/combine (nb, G, E, C) over a K-step loop
    counts = torch.zeros((nb, 1, E), dtype=torch.float32, device=x.device)
    dispatch = torch.zeros((nb, G, E, C), dtype=cdt, device=x.device)
    combine = torch.zeros((nb, G, E, C), dtype=cdt, device=x.device)
    for k in range(K):
        oh = _one_hot(idx_g[..., k], E, torch.float32)  # (nb, G, E)
        pos = counts + torch.cumsum(oh, dim=1) - oh  # exclusive position
        pos = torch.where(oh > 0, pos, float(C))  # out of range: a zero row
        pos_oh = _one_hot(pos.to(torch.int32), C, cdt)  # (nb, G, E, C)
        dispatch = dispatch + pos_oh
        combine = combine + gate_g[..., k, None, None].to(cdt) * pos_oh
        counts = counts + oh.sum(1, keepdim=True)

    xe = torch.einsum("ngec,ngd->necd", dispatch, xg)  # (nb, E, C, d)
    act = activation("silu")
    h = torch.einsum("necd,edf->necf", xe, p["w_in"])
    g = torch.einsum("necd,edf->necf", xe, p["w_gate"])
    ye = torch.einsum("necf,efd->necd", act(g) * h, p["w_out"])
    y = torch.einsum("ngec,necd->ngd", combine, ye).reshape(B, S, d)

    if "shared_in" in p:
        h = x @ p["shared_in"]
        g = x @ p["shared_gate"]
        y = y + (act(g) * h) @ p["shared_out"]

    dispatched = dispatch.float().sum()
    metrics = {
        "aux_loss": aux_loss,
        "drop_frac": 1.0 - dispatched / (T * K),
        "router_entropy": -torch.sum(me * torch.log(me + 1e-9)),
    }
    return y.to(x.dtype), metrics
