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

Under a mesh the layer is expert parallel: the router, the top-k and the
dispatch plan run on every model rank as they do here, each rank runs its
``E / tp`` experts on its slice of the one-hots, and the combine is summed
over ``model``; the shared experts are column- then row-parallel as the
dense MLP. Over the data axes the token groups are the reference's
group-batches of the global batch: where the rank's rows are whole groups
(B S a multiple of the group), it routes them alone and the aux loss's
batch statistics (the router's mean, the routed fractions, the dispatched
count) are summed over the data ranks; where a group spans ranks (a decode
step's few tokens), the batch is all-gathered over them and every data
rank routes it all. The aux loss, the same on every model rank, takes its
gradient on one of them (``pshard.one_owner``), and on one data rank where
the batch was gathered.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MoESpec
from repro_torch.models import pshard
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


def sharded_dims(spec: MoESpec) -> Dict:
    """The dims of each leaf's block the layer consumes as they lie over
    ``model``: the experts' axis, the shared experts' hidden axis."""
    tp = pshard.axis_size("model")
    if tp == 1:
        return {}
    Fs = spec.d_ff_shared * spec.num_shared
    if spec.num_experts % tp or Fs % tp:
        raise NotImplementedError(
            f"MoE layer: {spec.num_experts} experts (shared hidden {Fs}) do not "
            f"split over a model axis of {tp}")
    return {"w_in": (0,), "w_gate": (0,), "w_out": (0,), "shared_in": (1,),
            "shared_gate": (1,), "shared_out": (0,)}


def moe_fwd(p: Dict, x: torch.Tensor, spec: MoESpec,
            group_size: int = DEFAULT_GROUP) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> (y, metrics ``aux_loss``, ``drop_frac``,
    ``router_entropy``, f32 0-d tensors). Routes beyond an expert's
    capacity are dropped. Under a mesh, the rank's experts (module
    docstring)."""
    tp, dpax = pshard.axis_size("model"), pshard.dp()
    ndp = pshard.axis_size(dpax)
    if tp == 1 and ndp == 1:
        return _moe(p, x, spec, group_size)
    x_in = x
    if tp > 1:
        x = pshard.enter(x, torch.float32)
    first = pshard.index("model") * p["w_in"].shape[0]
    rows = x.shape[0] * x.shape[1]
    G = min(group_size, ndp * rows)  # the reference's group over the global batch
    if rows % G == 0:  # the rank's rows are whole groups
        y, metrics = _moe(p, x, spec, G, experts=first, stats_over=dpax)
        gathered = False
    else:  # a group spans data ranks: every data rank routes the global batch
        x = pshard.all_gather(x, dpax, 0)
        y, metrics = _moe(p, x, spec, G, experts=first)
        gathered = True
    if tp > 1:
        y = pshard.leave(y)
    aux = pshard.one_owner(metrics["aux_loss"], "model")
    if gathered:
        y = y.narrow(0, pshard.index(dpax) * x_in.shape[0], x_in.shape[0])
        aux = pshard.one_owner(aux, dpax)
    metrics["aux_loss"] = aux
    return y.to(x_in.dtype), metrics


def _moe(p: Dict, x: torch.Tensor, spec: MoESpec, group_size: int,
         experts: Optional[int] = None, stats_over=()) -> Tuple[torch.Tensor, Dict]:
    """The layer on x (B, S, d). ``experts``: the first of the rank's
    ``p["w_in"].shape[0]`` experts, whose partial output (f32) it returns.
    ``stats_over``: the mesh axes whose ranks hold the rest of the batch,
    over which the aux loss's statistics are summed."""
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

    own_dispatch, own_combine = dispatch, combine
    if experts is not None:
        E_l = p["w_in"].shape[0]
        own_dispatch = dispatch.narrow(2, experts, E_l)
        own_combine = combine.narrow(2, experts, E_l)
    xe = torch.einsum("ngec,ngd->necd", own_dispatch, xg)  # (nb, E, C, d)
    act = activation("silu")
    h = torch.einsum("necd,edf->necf", xe, p["w_in"])
    g = torch.einsum("necd,edf->necf", xe, p["w_gate"])
    ye = torch.einsum("necf,efd->necd", act(g) * h, p["w_out"])
    if experts is None:
        y = torch.einsum("ngec,necd->ngd", combine, ye).reshape(B, S, d)
    else:  # partial sums in f32 (the reference's GSPMD widening)
        y = torch.einsum("ngec,necd->ngd", own_combine.float(), ye.float()).reshape(B, S, d)

    if "shared_in" in p:
        h = x @ p["shared_in"]
        g = x @ p["shared_gate"]
        if experts is None:
            y = y + (act(g) * h) @ p["shared_out"]
        else:
            y = y + (act(g) * h).float() @ p["shared_out"].float()

    # Switch aux loss over the whole batch
    routed = _one_hot(idx_k, E, torch.float32).sum(1)  # (T, E)
    if pshard.axis_size(stats_over) == 1:
        T_all = T
        me = probs.mean(0)
        ce = routed.mean(0) / K
        dispatched = dispatch.float().sum()
    else:  # the data ranks' sums, added in rank order in one psum
        T_all = T * pshard.axis_size(stats_over)
        part = torch.cat([probs.sum(0), routed.sum(0), dispatch.float().sum().reshape(1)])
        summed = pshard.psum(part, stats_over)
        me, ce, dispatched = summed[:E] / T_all, summed[E:2 * E] / T_all / K, summed[2 * E]
    aux_loss = E * torch.sum(me * ce)
    metrics = {
        "aux_loss": aux_loss,
        "drop_frac": 1.0 - dispatched / (T_all * K),
        "router_entropy": -torch.sum(me * torch.log(me + 1e-9)),
    }
    return (y if experts is not None else y.to(x.dtype)), metrics
