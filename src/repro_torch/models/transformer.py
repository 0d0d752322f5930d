"""Pattern-repeat decoder transformer.

Port of ``repro.models.transformer``: one stack for every decoder arch the
reference registers, dense GQA (llama, tinyllama, stablelm, pixtral),
local:global interleave (gemma3), chunked:global with MoE (llama4),
MLA with MoE (deepseek-v2), mamba:attention hybrids (jamba) and pure SSD
(mamba2). An ``ArchConfig`` describes layers as ``prefix +
pattern * repeats + remainder``; the pattern's parameters (and decode
caches) are stacked on a leading ``repeats`` axis as in the reference, so a
reference tree converts key for key. Where the reference runs ``lax.scan`` over the
stacked leaves, the port loops over ``repeats`` and indexes them as views.
The vision stub (pixtral, llama4) prepends ``frontend`` embeddings through
``frontend_proj``; MoE layers add their Switch aux loss to ``forward``'s
total.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels.flash_attention import under_torch_func
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import pshard
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import RopeTable
from repro_torch.models.common import (
    apply_norm,
    apply_rope,
    dense_init,
    dtype_of,
    embed_init,
    init_norm,
    rope_frequencies,
)


# ---------------------------------------------------------------------------
# Rope tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def build_ropes(cfg: ArchConfig, device=None) -> Dict[str, RopeTable]:
    """The inverse-frequency tables of ``cfg``'s attention layers on
    ``device`` (built once per config and device)."""
    tables = {}
    specs = [s.attn for s in cfg.all_layers() if s.attn is not None]
    if not specs:
        return tables
    a = specs[0]
    inv, rot = rope_frequencies(a.head_dim, cfg.rope_theta, a.rope_frac, device)
    tables["global"] = RopeTable(inv, rot)
    if cfg.rope_theta_local:
        inv_l, rot_l = rope_frequencies(a.head_dim, cfg.rope_theta_local,
                                        a.rope_frac, device)
        tables["local"] = RopeTable(inv_l, rot_l)
    mla = [s for s in specs if s.is_mla]
    if mla:
        inv_m, rot_m = rope_frequencies(mla[0].rope_dim, cfg.rope_theta, 1.0, device)
        tables["mla"] = RopeTable(inv_m, rot_m)
    return tables


def _rope_for(cfg: ArchConfig, spec: LayerSpec, ropes) -> Optional[RopeTable]:
    a = spec.attn
    if a is None:
        return None
    if a.is_mla:  # MLA's decoupled RoPE dims, whatever ``rope`` says
        return ropes.get("mla")
    if not a.rope:
        return None
    if a.kind == "sliding" and "local" in ropes:
        return ropes["local"]
    return ropes.get("global")


# ---------------------------------------------------------------------------
# Per-layer init / apply (attention or SSM, then a dense MLP or MoE if any)
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec) -> Dict:
    dtype = dtype_of(cfg.param_dtype)
    dev = gen.device
    p: Dict = {"ln1": init_norm(cfg.d_model, cfg.norm, dtype, dev)}
    if spec.kind == "attn":
        p["attn"] = attn_mod.init_attention(gen, cfg.d_model, spec.attn, dtype)
    else:
        p["ssm"] = ssm_mod.init_ssm(gen, cfg.d_model, spec.ssm, dtype)
    if spec.mlp.kind != "none":
        p["ln2"] = init_norm(cfg.d_model, cfg.norm, dtype, dev)
        if spec.mlp.kind == "dense":
            p["mlp"] = mlp_mod.init_mlp(gen, cfg.d_model, spec.mlp, dtype)
        else:
            p["moe"] = moe_mod.init_moe(gen, cfg.d_model, spec.mlp.moe, dtype)
    return p


def _branch_layout(name: str, spec: LayerSpec, decode: bool):
    """(dims kept as they lie over ``model``, ``materialize`` mode) of the
    layer's ``name`` sub-tree under the current mesh."""
    tp = pshard.axis_size("model")
    if name in ("ln1", "ln2"):  # on the rank's rows with the sequence sharded
        return {}, ("parallel" if pshard.seq_shard() else "replicated")
    if tp == 1:
        return {}, "parallel"
    if name == "attn":
        route = attn_mod.tp_route(spec.attn, tp)
        if route == "context" and decode:
            return {}, "replicated"
        return attn_mod.sharded_dims(spec.attn, tp), "parallel"
    if name == "ssm":
        par = ssm_mod.heads_parallel(spec.ssm)
        return ssm_mod.sharded_dims(spec.ssm), ("parallel" if par else "replicated")
    if name == "moe":
        return moe_mod.sharded_dims(spec.mlp.moe), "parallel"
    if spec.mlp.d_ff % tp == 0:
        return mlp_mod.sharded_dims(spec.mlp), "parallel"
    return {}, "replicated"


def _materialize_layer(p: Dict, pspec: Dict, spec: LayerSpec, names, decode: bool) -> Dict:
    """The layer's sub-trees ``names`` as the rank's part of the layer uses
    them (``pshard.materialize``)."""
    out = {}
    for name in names:
        keep, mode = _branch_layout(name, spec, decode)
        if mode == "replicated" and pshard.seq_shard() and name not in ("ln1", "ln2"):
            raise NotImplementedError(
                f"{name} layer: sequence-sharded residual around a layer that "
                f"runs replicated over the model axis")
        out[name] = pshard.materialize_tree(p[name], pspec[name], keep, mode)
    return out


def _mixer(p, x, cfg, spec, ropes, positions, mode, cache, mla_absorb, pspec):
    """The layer's first branch (norm, then attention or SSM): (y, cache)."""
    if pspec is not None:
        p = _materialize_layer(p, pspec, spec, ("ln1", spec.kind if spec.kind == "attn"
                                                 else "ssm"), mode == "decode")
    h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    rope = _rope_for(cfg, spec, ropes)
    new_cache = cache
    if spec.kind == "attn":
        if mode == "decode":
            y, new_cache = attn_mod.attention_decode(p["attn"], h, spec.attn, rope,
                                                     cache, mla_absorb=mla_absorb)
        else:
            y = attn_mod.attention_fwd(p["attn"], h, spec.attn, rope, positions)
            if mode == "prefill":
                new_cache = _write_prefill_cache(p["attn"], _whole_rows(h), spec, rope,
                                                 positions)
    elif mode == "decode":
        y, new_cache = ssm_mod.ssm_decode(p["ssm"], h, spec.ssm, cache)
    elif mode == "prefill":
        y, hstate, conv_tail = _ssm_prefill(p["ssm"], h, spec)
        new_cache = {"h": hstate, "conv": conv_tail}
    else:
        y = ssm_mod.ssm_fwd(p["ssm"], h, spec.ssm)
    return y, new_cache


def _ffn(p, x, cfg, spec, mode, moe_group, pspec, explicit_tp):
    """The layer's second branch (norm, then the MLP or MoE): (y, aux)."""
    name = "mlp" if spec.mlp.kind == "dense" else "moe"
    if pspec is not None:
        p = _materialize_layer(p, pspec, spec, ("ln2", name), mode == "decode")
    h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    if name == "mlp":
        return mlp_mod.mlp_fwd(p["mlp"], h, spec.mlp,
                               explicit_tp=explicit_tp and mode != "decode"), None
    y, metrics = moe_mod.moe_fwd(p["moe"], h, spec.mlp.moe, moe_group)
    return y, metrics["aux_loss"]


def apply_layer(
    p: Dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    spec: LayerSpec,
    ropes,
    positions,
    mode: str,
    cache: Optional[Dict] = None,
    mla_absorb: bool = True,
    moe_group: int = moe_mod.DEFAULT_GROUP,
    pspec: Optional[Dict] = None,
    explicit_tp: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict], Optional[torch.Tensor]]:
    """Returns (x, new_cache, moe_aux_loss), the aux None for a layer
    without MoE (no tensor made a layer). In ``decode`` mode the cache is
    updated in place (``attention.attention_decode``, ``ssm.ssm_decode``).
    ``moe_group`` is the MoE layer's token group (the serving pool's tick
    routes each row alone: 1). Under a mesh ``p`` holds the rank's blocks,
    laid out by ``pspec``, which each branch materializes at use."""
    y, new_cache = _mixer(p, x, cfg, spec, ropes, positions, mode, cache, mla_absorb,
                          pspec)
    x = x + y
    aux = None
    if spec.mlp.kind != "none":
        y, aux = _ffn(p, x, cfg, spec, mode, moe_group, pspec, explicit_tp)
        x = x + y
    return x, new_cache, aux


def _whole_rows(h):
    """``h`` with the sequence whole (the rank's rows gathered where the
    sequence is sharded), as a prefill's cache writer needs it."""
    return pshard.all_gather(h, "model", 1, grad="split") if pshard.seq_shard() else h


# --- prefill-cache writers --------------------------------------------------


def _write_prefill_cache(p, h, spec: LayerSpec, rope, positions):
    """K/V (MLA: latents and the RoPE key) for the whole prompt, laid out in
    ring order so decode can continue."""
    a = spec.attn
    S = h.shape[1]
    L = a.cache_len(S)
    index = torch.full((), S, dtype=torch.int32, device=h.device)
    if a.is_mla:
        c_kv = h @ p["w_dkv"]
        k_rope = h @ p["w_k_rope"]
        if rope is not None:
            k_rope = attn_mod._rope_one_head(k_rope, positions[None], rope)
        return {"c_kv": _ring_layout(c_kv, L), "k_rope": _ring_layout(k_rope, L),
                "index": index}
    k = torch.einsum("bsd,dhe->bshe", h, p["w_k"])
    v = torch.einsum("bsd,dhe->bshe", h, p["w_v"])
    if a.qk_norm:
        k = attn_mod.rms_norm_headwise(p["k_norm"], k)
    if a.rope and rope is not None:
        k = apply_rope(k, positions[None], rope.inv_freq, rope.rot)
    return {"k": _ring_layout(k, L), "v": _ring_layout(v, L), "index": index}


def _ring_layout(t: torch.Tensor, L: int) -> torch.Tensor:
    """Keep the last L positions of (B, S, ...) laid out so that position p
    sits in slot p % L (matching the decode ring buffer)."""
    S = t.shape[1]
    if L >= S:
        if L == S:
            return t
        pad = torch.zeros((t.shape[0], L - S) + t.shape[2:], dtype=t.dtype,
                          device=t.device)
        return torch.cat([t, pad], dim=1)
    tail = t[:, S - L:]
    return torch.roll(tail, shifts=(S - L) % L, dims=1)


def _ssm_prefill(p, h, spec: LayerSpec):
    """(out, final state, conv tail): the tail is the last W - 1 conv
    inputs before the conv, from the block's own projection (the reference
    projects the prompt a second time for it; the values are the same)."""
    out, hstate, xbc = ssm_mod._ssm_fwd(p, h, spec.ssm)
    tail = xbc[:, -(spec.ssm.conv_width - 1):].contiguous()
    return out, hstate, tail


# ---------------------------------------------------------------------------
# Whole-model params
# ---------------------------------------------------------------------------


def _stack(trees):
    return tree_map(lambda *leaves: torch.stack(leaves), trees[0], *trees[1:])


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Dict:
    """Params drawn from ``gen`` (they land on its device), in the
    reference's tree: ``blocks`` is a tuple with one entry per pattern
    layer, each leaf stacked on a leading ``repeats`` axis."""
    dtype = dtype_of(cfg.param_dtype)
    params: Dict = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), 0, dtype)
    if cfg.prefix:
        params["prefix"] = tuple(init_layer(gen, cfg, s) for s in cfg.prefix)
    params["blocks"] = tuple(
        _stack([init_layer(gen, cfg, spec) for _ in range(cfg.repeats)])
        for spec in cfg.pattern)
    if cfg.remainder:
        params["remainder"] = tuple(init_layer(gen, cfg, s) for s in cfg.remainder)
    if cfg.frontend != "none":
        # projector stub: the frontend embeddings are already d_model wide
        params["frontend_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model), 0, dtype)
    return params


def _unbound(tree) -> list:
    """One tree a repeat, each leaf the repeat's slice of its stack by a
    single ``torch.unbind`` per leaf."""
    parts = [t.unbind(0) for t in tree_leaves(tree)]
    out = []
    for r in range(len(parts[0]) if parts else 0):
        it = iter([p[r] for p in parts])
        out.append(tree_map(lambda _: next(it), tree))
    return out


def _layers(tree, cfg: ArchConfig):
    """(params-or-cache, spec, in_blocks) for every layer in order. Each
    stacked ``blocks`` leaf is split once into views (``torch.unbind``),
    whose backward stacks the layers' gradients in one op, where indexing
    would give every layer's gradient a zero-filled copy of the whole stack
    to add up. Decode writes its caches' views in place, which autograd
    allows on ``unbind``'s views while no gradient flows into them: decode
    records none (its params and caches do not require grad)."""
    for i, spec in enumerate(cfg.prefix):
        yield tree["prefix"][i], spec, False
    split = [_unbound(b) for b in tree["blocks"]]
    for r in range(cfg.repeats):
        for pi, spec in enumerate(cfg.pattern):
            yield split[pi][r], spec, True
    for i, spec in enumerate(cfg.remainder):
        yield tree["remainder"][i], spec, False


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _layer_specs(specs, cfg: ArchConfig):
    """Each layer's spec tree in ``_layers`` order (a stacked leaf's spec
    without its repeat entry); Nones without specs."""
    n = len(cfg.prefix) + len(cfg.pattern) * cfg.repeats + len(cfg.remainder)
    if specs is None:
        yield from [None] * n
        return
    for i, _ in enumerate(cfg.prefix):
        yield specs["prefix"][i]
    unstacked = [tree_map(lambda sp: sharding.P(*sp[1:]), b) for b in specs["blocks"]]
    for _ in range(cfg.repeats):
        yield from unstacked
    for i, _ in enumerate(cfg.remainder):
        yield specs["remainder"][i]


def _vocab(params, specs, name: str, vocab_dim: int):
    """``params[name]`` as the embedding or head uses it: the rank's vocab
    block where ``model`` splits the vocab (kept, with its first id), every
    other sharded dim gathered. Returns (leaf, first id or None)."""
    spec = specs[name]
    split = spec[vocab_dim] == "model" and pshard.axis_size("model") > 1
    w = pshard.materialize(params[name], spec, keep=(vocab_dim,) if split else (),
                           mode="replicated")
    return w, (pshard.index("model") * w.shape[vocab_dim] if split else None)


def _head(params, tied: bool, specs=None):
    """(head (d, V or the rank's V block), the block's first id or None)."""
    if specs is None:
        return (params["embed"].T if tied else params["lm_head"]), None
    if tied:
        w, lo = _vocab(params, specs, "embed", 0)
        return w.T, lo
    return _vocab(params, specs, "lm_head", 1)


def lookup(params, tokens, specs=None):
    """Rows of ``params["embed"]`` for ``tokens``. Under a mesh splitting the
    vocab, each rank looks up the tokens of its block, zeros for the rest,
    and the ranks psum."""
    if specs is None:
        return params["embed"][tokens]
    emb, lo = _vocab(params, specs, "embed", 0)
    if lo is None:
        return emb[tokens]
    local = tokens.long() - lo
    own = (local >= 0) & (local < emb.shape[0])
    x = torch.where(own[..., None], emb[local.clamp(0, emb.shape[0] - 1)],
                    torch.zeros((), dtype=emb.dtype, device=emb.device))
    return pshard.psum(x, "model")


def _embed_tokens(params, cfg: ArchConfig, tokens, extra_embeds=None, specs=None):
    """Token embeddings (scaled by sqrt(d_model) where the arch says so),
    with the frontend stub's ``extra_embeds`` (B, P, d) projected and
    prepended (``lookup``: vocab-parallel under a mesh)."""
    x = lookup(params, tokens, specs)
    if cfg.embed_scale:
        # the scale rounded to the activation dtype first, as in the reference
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype).item()
    if extra_embeds is not None:
        proj = params["frontend_proj"]
        if specs is not None:
            proj = pshard.materialize(proj, specs["frontend_proj"], mode="replicated")
        fe = extra_embeds.to(x.dtype) @ proj
        x = torch.cat([fe, x], dim=1)
    return x


def _checkpointed(p, x, cfg, spec, ropes, positions, pspec=None, explicit_tp=False,
                  save_outputs=False):
    """One train-mode layer whose activations autograd does not keep: they
    are recomputed in the backward (``torch.utils.checkpoint``). Returns
    (x, moe_aux_loss). ``save_outputs``: each branch is checkpointed on
    its own, so its output is kept for the backward and the recompute
    stops before the branch's closing sum over ``model`` (the reference's
    ``remat_save_outputs``: a split checkpoint)."""
    from torch.utils.checkpoint import checkpoint

    kw = dict(use_reentrant=False, preserve_rng_state=False)
    ctx = pshard.captured()  # the recompute runs in the backward, outside this call
    if not save_outputs:
        def run(p_, x_):
            with ctx():
                x_, _, aux = apply_layer(p_, x_, cfg, spec, ropes, positions, "train",
                                         pspec=pspec, explicit_tp=explicit_tp)
            return x_, aux  # aux None without MoE: checkpoint passes it through

        return checkpoint(run, p, x, **kw)

    def mixer(p_, x_):
        with ctx():
            return _mixer(p_, x_, cfg, spec, ropes, positions, "train", None, True,
                          pspec)[0]

    x = x + checkpoint(mixer, p, x, **kw)
    if spec.mlp.kind == "none":
        return x, None

    def ffn(p_, x_):
        with ctx():
            return _ffn(p_, x_, cfg, spec, "train", moe_mod.DEFAULT_GROUP, pspec,
                        explicit_tp)

    y, aux = checkpoint(ffn, p, x, **kw)
    return x + y, aux


def forward(
    params: Dict,
    cfg: ArchConfig,
    tokens: torch.Tensor,  # (B, S_text)
    extra_embeds: Optional[torch.Tensor] = None,  # (B, P, d) stub frontend
    mode: str = "train",
    remat: bool = True,
    specs: Optional[Dict] = None,
    seq_shard: bool = False,
    explicit_tp: bool = False,
    remat_save_outputs: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Returns (final_hidden (B,S,d), total_moe_aux (the MoE layers' aux
    losses summed in layer order, f32; 0 without MoE layers),
    caches|None). ``mode`` is ``train`` or ``prefill``; ``extra_embeds`` are
    the vision stub's embeddings, prepended (S = P + S_text).

    ``remat`` (train mode): each layer of the repeated ``blocks`` runs
    under ``torch.utils.checkpoint`` when autograd records it, so the
    backward recomputes its activations instead of keeping them, as the
    reference's ``jax.checkpoint`` of its scan body does (the reference
    checkpoints the pattern group of one repeat, one layer for tinyllama).
    ``torch.func`` transforms do not take checkpointing, so under them (the
    FL clients' ``vmap(grad)``) the layers run unwrapped: the values are
    the same, only the memory differs. The layers' recompute calls K4's
    forward a second time.

    Under a mesh (``pshard.mesh_context``), ``params`` are the rank's
    blocks laid out by ``specs`` (``sharding.params_pspecs``) and the batch
    the rank's rows; each layer runs the rank's part. ``seq_shard``: the
    residual stream between layers is split over the sequence on
    ``model`` (each branch ends in a reduce-scatter and the next gathers);
    ``explicit_tp``: the MLP's ``explicit_tp`` path; the prefill's caches
    come in ``sharding.compute_cache_pspecs``' layout."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward runs mode train or prefill, got {mode!r}")
    x = _embed_tokens(params, cfg, tokens, extra_embeds, specs)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    ropes = build_ropes(cfg, x.device)
    remat = (remat and mode == "train" and torch.is_grad_enabled()
             and not under_torch_func())
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    tp = pshard.axis_size("model")
    seq_shard = seq_shard and specs is not None and tp > 1
    if seq_shard:
        if S % tp:
            raise NotImplementedError(f"sequence sharding: {S} positions over {tp} ranks")
        x = pshard.split(x, "model", 1)
    with pshard.seq_sharded(seq_shard):
        for (p, spec, in_blocks), ps in zip(_layers(params, cfg), _layer_specs(specs, cfg)):
            if remat and in_blocks:
                (x, a), c = _checkpointed(p, x, cfg, spec, ropes, positions, ps,
                                          explicit_tp, remat_save_outputs), None
            else:
                x, c, a = apply_layer(p, x, cfg, spec, ropes, positions, mode, pspec=ps,
                                      explicit_tp=explicit_tp)
            if a is not None:
                aux = aux + a
            caches.append(c)
    if seq_shard:
        x = pshard.all_gather(x, "model", 1, grad="split")
    norm = params["final_norm"]
    if specs is not None:
        norm = pshard.materialize_tree(norm, specs["final_norm"], mode="replicated")
    x = apply_norm(norm, x, cfg.norm, cfg.norm_eps)
    if mode != "prefill":
        return x, aux, None
    return x, aux, _regroup(caches, cfg)


def _regroup(per_layer: list, cfg: ArchConfig) -> Dict:
    """Per-layer caches (in ``_layers`` order) into the reference's tree:
    ``blocks`` stacked on the repeats axis, ``prefix``/``remainder`` lists."""
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    out: Dict = {}
    if cfg.prefix:
        out["prefix"] = per_layer[:n_pre]
    body = per_layer[n_pre:n_pre + n_pat * cfg.repeats]
    out["blocks"] = tuple(_stack(body[pi::n_pat]) for pi in range(n_pat))
    if cfg.remainder:
        out["remainder"] = per_layer[n_pre + n_pat * cfg.repeats:]
    return out


# ---------------------------------------------------------------------------
# Logits / loss
# ---------------------------------------------------------------------------


def logits_of(x, w, lo, softcap: float = 0.0) -> torch.Tensor:
    """``x @ w`` (soft-capped); with ``lo`` (``w`` the rank's vocab block) the
    ranks' blocks all-gathered."""
    if lo is not None:
        x = pshard.copy(x, "model")
    logits = x @ w
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if lo is not None:
        logits = pshard.all_gather(logits, "model", logits.dim() - 1, grad="split")
    return logits


def unembed(params, cfg: ArchConfig, x: torch.Tensor, specs=None) -> torch.Tensor:
    """Logits (B, S, V); under a mesh splitting the vocab, the ranks' blocks
    all-gathered."""
    return logits_of(x, *_head(params, cfg.tie_embeddings, specs), cfg.logits_softcap)


def _vocab_parallel_loss(xc, lc, vc, w, lo, cfg):
    """Summed cross entropy of a chunk against the rank's vocab block: the
    max all-gathered and reduced exactly, the sum of exponentials and the
    gold logit summed over ``model`` in rank order."""
    xc = pshard.copy(xc, "model", torch.float32)
    logits = (xc @ w).float()
    if cfg.logits_softcap:
        logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
    m = logits.detach().amax(-1, keepdim=True)
    m = torch.stack(pshard.gather_parts(m, "model", kind="all_gather")).amax(0)
    lse = m[..., 0] + torch.log(pshard.psum(torch.exp(logits - m).sum(-1), "model"))
    n = logits.shape[-1]
    local = lc - lo
    own = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = pshard.psum(torch.where(own, gold, torch.zeros((), device=gold.device)), "model")
    return ((lse - gold) * vc).sum()


def lm_loss(
    params: Dict,
    cfg: ArchConfig,
    x_final: torch.Tensor,  # (B, S, d)
    labels: torch.Tensor,  # (B, S) int; -1 = ignore
    vocab_chunk: int = 0,
    specs: Optional[Dict] = None,
) -> torch.Tensor:
    """Mean causal-LM cross entropy. ``vocab_chunk`` > 0 walks sequence
    chunks so only (B, chunk, V) logits are ever live. Under a mesh
    (``specs``) the batch is the rank's rows: the sums and the count are
    summed over the data axes; a vocab split over ``model`` runs the
    vocab-parallel cross entropy (gemma's soft cap included)."""
    w, lo = _head(params, cfg.tie_embeddings, specs)
    valid = (labels >= 0).float()
    safe_labels = torch.clamp(labels, min=0).long()

    def chunk_loss(xc, lc, vc):
        if lo is not None:
            return _vocab_parallel_loss(xc, lc, vc, w, lo, cfg)
        logits = (xc @ w).float()
        if cfg.logits_softcap:
            logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        return ((lse - gold) * vc).sum()

    S = x_final.shape[1]
    if vocab_chunk and S > vocab_chunk and S % vocab_chunk == 0:
        total = torch.zeros((), dtype=torch.float32, device=x_final.device)
        for c in range(0, S, vocab_chunk):
            sl = slice(c, c + vocab_chunk)
            total = total + chunk_loss(x_final[:, sl], safe_labels[:, sl], valid[:, sl])
    else:
        total = chunk_loss(x_final, safe_labels, valid)
    count = valid.sum()
    if specs is not None:
        total, count = pshard.psum(total, pshard.dp()), pshard.psum(count, pshard.dp())
    return total / torch.clamp(count, min=1.0)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_decode_caches(cfg: ArchConfig, batch: int, seq_len: int,
                       device=None) -> Dict:
    """Caches for every layer at context length ``seq_len``."""
    dtype = dtype_of(cfg.compute_dtype)

    def one(spec: LayerSpec):
        if spec.kind == "attn":
            return attn_mod.init_cache(spec.attn, batch, seq_len, dtype, device)
        return ssm_mod.init_ssm_cache(spec.ssm, batch, dtype, device)

    caches: Dict = {}
    if cfg.prefix:
        caches["prefix"] = [one(s) for s in cfg.prefix]
    caches["blocks"] = tuple(_stack([one(spec)] * cfg.repeats) for spec in cfg.pattern)
    if cfg.remainder:
        caches["remainder"] = [one(s) for s in cfg.remainder]
    return caches


def decode_step(
    params: Dict,
    cfg: ArchConfig,
    caches: Dict,
    token: torch.Tensor,  # (B, 1) int
    mla_absorb: bool = True,
    moe_group: int = moe_mod.DEFAULT_GROUP,
    specs: Optional[Dict] = None,
    cache_layout: Optional[Tuple] = None,
) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. Returns (logits (B,1,V), caches).

    The caches are updated IN PLACE (each attention layer's K/V row written
    at its ring slot and its index incremented, each SSM layer's state and
    conv window advanced) and returned; the caller must not
    reuse the tree it passed in as the old state. No host sync. MoE layers
    route the B tokens in groups of ``min(moe_group, B)``, as the
    reference's batch-B step; the slot pool passes 1, the reference's
    vmapped batch-1 tick. Under a mesh (``specs``) the rank's rows and
    blocks, and its caches laid out by ``cache_layout`` (the stored specs,
    the compute specs): each layer's moved to the compute layout at use and
    written back after it (``sharding.cache_at_use``)."""
    x = _embed_tokens(params, cfg, token, specs=specs)
    ropes = build_ropes(cfg, x.device)
    store, comp = cache_layout if cache_layout is not None else (None, None)
    mesh = pshard.current_mesh()
    for (p, spec, _), (cache, _, _), ps, st, cp in zip(
            _layers(params, cfg), _layers(caches, cfg), _layer_specs(specs, cfg),
            _layer_specs(store, cfg), _layer_specs(comp, cfg)):
        with sharding.cache_at_use(cache, st, cp, mesh) as work:
            x, _, _ = apply_layer(p, x, cfg, spec, ropes, None, "decode", work,
                                  mla_absorb=mla_absorb, moe_group=moe_group, pspec=ps)
    norm = params["final_norm"]
    if specs is not None:
        norm = pshard.materialize_tree(norm, specs["final_norm"], mode="replicated")
    x = apply_norm(norm, x, cfg.norm, cfg.norm_eps)
    return unembed(params, cfg, x, specs), caches
