"""Sharding rules: logical parameter/activation axes -> partition specs.

Port of ``repro.sharding``. Mesh axes:
  single pod : ("data", "model")            = (16, 16)
  multi-pod  : ("pod", "data", "model")     = (2, 16, 16)

Batch shards over ("pod","data"); tensor-parallel dims (heads / ffn hidden
/ experts / vocab) over "model"; the d_model dim of weight matrices over
"data" (FSDP-style). Every rule degrades gracefully: an axis is sharded
only if its size divides the mesh axis (e.g. whisper's vocab 51865 and
llama4's 40 query heads fall back to the next candidate or replicate).

The rules are pure Python over ``mesh.shape`` (a ``launch.mesh.Mesh``,
live or abstract, or anything with a ``shape`` dict) and return ``P``, the
port's partition spec: one entry per dimension, ``None``, an axis name or
a tuple of names, equal entry by entry to JAX's ``PartitionSpec``. Leaves
are named by path as the reference names them: the last string key, and
stacked (a leading repeat dimension, replicated) under ``blocks`` or
``*_layers``.

The reference's ``to_named`` places arrays on devices; here each rank
holds its blocks itself: ``local_shape`` gives a block's shape,
``shard_tree`` cuts this rank's blocks out of a full tree (with
``convert.lm_params_from_jax`` that is how the reference's weights reach a
sharded run), ``unshard_tree`` gathers the full tree back, and
``relayout`` moves a block between two specs (decode caches).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from repro_torch.core.tree import tree_map, tree_map_with_path


class P:
    """A partition spec: per dimension ``None``, an axis name or a tuple of
    axis names (a tuple of one name is stored as the name, as JAX stores
    it). Iterates, indexes and compares as the tuple of its entries (so
    ``P(None, "model") == (None, "model")``); a leaf to the port's tree
    functions, which descend into tuples."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                           for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        return tuple(self) == tuple(other) if isinstance(other, (P, tuple)) else NotImplemented

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"P{self.parts!r}"


def mesh_axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= mesh_axis_size(mesh, n)
        return out
    return mesh.shape[name] if name in mesh.shape else 1


def dp_axes(mesh):
    """Axes used for batch/data parallelism."""
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def _fits(dim: int, mesh, axis) -> bool:
    return dim % mesh_axis_size(mesh, axis) == 0


def _pick(dims: Dict[int, int], mesh, prefs: Tuple[Tuple[int, object], ...]) -> P:
    """Build a spec list for an array with dims {axis_index: size}; prefs is
    a priority list of (axis_index, mesh_axis). Each mesh axis is used at
    most once; an axis is skipped unless it divides."""
    ndim = len(dims)
    spec = [None] * ndim
    used = set()
    for ax, mesh_axis in prefs:
        key = mesh_axis if isinstance(mesh_axis, str) else tuple(mesh_axis)
        if key in used or spec[ax] is not None:
            continue
        if _fits(dims[ax], mesh, mesh_axis):
            spec[ax] = mesh_axis
            used.add(key)
    return P(*spec)


# ---------------------------------------------------------------------------
# Parameter rules (by leaf name inside the layer structures)
# ---------------------------------------------------------------------------


def _param_spec(name: str, shape: Tuple[int, ...], mesh, stacked: bool) -> P:
    """name = leaf key (e.g. 'w_q'); shape excludes the stacked repeat dim."""
    dims = dict(enumerate(shape))
    n = len(shape)

    def pick(*prefs):
        spec = _pick(dims, mesh, prefs)
        if stacked:
            return P(None, *spec)
        return spec

    if name in ("embed",):  # (V, d)
        return pick((0, "model"), (1, "data"))
    if name == "lm_head":  # (d, V)
        return pick((1, "model"), (0, "data"))
    if name in ("w_q", "w_k", "w_v"):  # (d, H, Dh)
        return pick((1, "model"), (2, "model"), (0, "data"))
    if name == "w_o":  # (H, Dh, d)
        return pick((0, "model"), (1, "model"), (2, "data"))
    if name in ("w_uq", "w_uk", "w_uv"):  # (r, H, e)
        return pick((1, "model"), (0, "data"))
    if name in ("w_dq", "w_dkv", "w_k_rope"):  # (d, r)
        return pick((0, "data"))
    if name in ("w_in", "w_gate"):
        if n == 2:  # dense (d, f)
            return pick((1, "model"), (0, "data"))
        return pick((0, "model"), (1, "data"))  # moe (E, d, f)
    if name == "w_out":
        if n == 2:  # dense (f, d) — or ssm (di, d)
            return pick((0, "model"), (1, "data"))
        return pick((0, "model"), (2, "data"))  # moe (E, f, d)
    if name in ("shared_in", "shared_gate"):  # (d, f)
        return pick((1, "model"), (0, "data"))
    if name == "shared_out":  # (f, d)
        return pick((0, "model"), (1, "data"))
    if name == "router":  # (d, E)
        return pick((0, "data"))
    if name == "conv_w":  # (W, ch)
        return pick((1, "model"))
    if name in ("conv_b", "norm_scale"):  # (ch,)
        return pick((0, "model"))
    if name in ("A_log", "dt_bias", "D"):  # (nh,)
        return pick((0, "model"))
    if name == "frontend_proj":  # (d, d)
        return pick((1, "model"), (0, "data"))
    # norms / scalars / small vectors: replicate
    return P(*([None] * (n + (1 if stacked else 0))))


def _names(path: str):
    """The string keys of a ``tree_map_with_path`` path (positions dropped)."""
    return [p for p in path.split("/") if p and not p.isdigit()]


def params_pspecs(params, mesh):
    """Spec tree matching a params tree (stacked block leaves get a leading
    replicated repeat dim). Reads only the leaves' shapes: a tree on the
    meta device (``models.factory.abstract_params``) serves."""

    def visit(path, leaf):
        names = _names(path)
        name = names[-1] if names else ""
        # stacked iff under 'blocks' or (encdec) '*_layers'
        stacked = any(p == "blocks" or p.endswith("_layers") for p in names)
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        return _param_spec(name, shape, mesh, stacked)

    return tree_map_with_path(visit, params)


# ---------------------------------------------------------------------------
# Activation / batch / cache rules
# ---------------------------------------------------------------------------


def batch_pspecs(batch, mesh):
    dp = dp_axes(mesh)

    def visit(leaf):
        dims = dict(enumerate(leaf.shape))
        return _pick(dims, mesh, ((0, dp),))

    return tree_map(visit, batch)


def cache_pspecs(caches, mesh):
    """Decode caches. Layout conventions (possibly with a leading stacked
    repeat dim): k/v (B, L, Hk, D); c_kv/k_rope (B, L, r); ssm h
    (B, nh, hd, ds); conv (B, W-1, ch); cross_k/v (n_dec, B, T, Hk, D);
    index scalar. Batch shards over dp when divisible; otherwise the cache
    length L shards over ("data") and heads over "model"."""
    dp = dp_axes(mesh)

    def visit(path, leaf):
        names = _names(path)
        name = names[-1] if names else ""
        stacked = "blocks" in names
        off = 1 if stacked else 0
        shape = tuple(leaf.shape)
        dims = dict(enumerate(shape))
        if name == "index":
            return P(*([None] * leaf.ndim))
        if name in ("k", "v", "c_kv", "k_rope"):
            b_ax, l_ax = off, off + 1
            prefs = [(b_ax, dp)]
            if shape[b_ax] % mesh_axis_size(mesh, dp) != 0:
                prefs = [(l_ax, "data")]
            if len(shape) - off == 4:  # k/v with heads
                prefs.append((off + 2, "model"))
                prefs.append((l_ax, "model"))  # fallback: L over model too
            else:
                prefs.append((l_ax, "model"))
            return _pick(dims, mesh, tuple(prefs))
        if name in ("cross_k", "cross_v"):  # (n_dec, B, T, Hk, D)
            return _pick(dims, mesh, ((1, dp), (3, "model")))
        if name == "h":  # (B, nh, hd, ds)
            prefs = [(off, dp), (off + 1, "model")]
            return _pick(dims, mesh, tuple(prefs))
        if name == "conv":  # (B, W-1, ch)
            return _pick(dims, mesh, ((off, dp), (off + 2, "model")))
        return P(*([None] * leaf.ndim))

    return tree_map_with_path(visit, caches)


def compute_cache_pspecs(caches, mesh):
    """The layout the model's decode step computes on (its caches
    all-gathered or cut to it from ``cache_pspecs``' layout, and back): batch
    over the data axes where it divides, attention kv heads and SSM heads
    over ``model`` where they divide (each rank's own heads, as its layer
    runs them), every other dimension whole. Stacked leaves sit under
    ``blocks`` or (the encoder-decoder's self-attention rings) ``self``."""
    dp = dp_axes(mesh)

    def visit(path, leaf):
        names = _names(path)
        name = names[-1] if names else ""
        off = 1 if ("blocks" in names or "self" in names) else 0
        dims = dict(enumerate(leaf.shape))
        if name in ("k", "v"):
            return _pick(dims, mesh, ((off, dp), (off + 2, "model")))
        if name in ("c_kv", "k_rope", "conv"):
            return _pick(dims, mesh, ((off, dp),))
        if name == "h":
            return _pick(dims, mesh, ((off, dp), (off + 1, "model")))
        if name in ("cross_k", "cross_v"):
            return _pick(dims, mesh, ((1, dp), (3, "model")))
        return P(*([None] * leaf.ndim))

    return tree_map_with_path(visit, caches)


# ---------------------------------------------------------------------------
# Blocks of a live mesh's ranks
# ---------------------------------------------------------------------------


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` array laid out by
    ``spec``."""
    out = []
    for i, n in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        d = 1 if ax is None else mesh_axis_size(mesh, ax)
        if n % d:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split over {ax} ({d})")
        out.append(n // d)
    return tuple(out)


def local_block(t: torch.Tensor, spec, mesh, skip=()) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` (a view), every dimension
    that ``spec`` shards and ``skip`` does not name cut to the rank's
    index along its axes."""
    for i, ax in enumerate(spec):
        if ax is None or i in skip or mesh_axis_size(mesh, ax) == 1:
            continue
        n = t.shape[i] // mesh_axis_size(mesh, ax)
        t = t.narrow(i, mesh.index(ax) * n, n)
    return t


def shard_tree(tree, specs, mesh):
    """This rank's blocks of a full tree (each a contiguous copy)."""
    return tree_map(lambda t, s: local_block(t, s, mesh).contiguous(), tree, specs)


def _gather_dim(t: torch.Tensor, ax, dim: int, mesh) -> torch.Tensor:
    from repro_torch.models import pshard

    return torch.cat(pshard.gather_parts(t, ax, mesh, kind="all_gather"), dim)


def unshard_tree(tree, specs, mesh):
    """The full tree from every rank's blocks (all-gathered over each
    sharded dimension; every rank gets it). For tests and reports: it
    records no gradient."""

    def full(t, spec):
        for i, ax in enumerate(spec):
            if ax is not None and mesh_axis_size(mesh, ax) > 1:
                t = _gather_dim(t, ax, i, mesh)
        return t

    with torch.no_grad():
        return tree_map(full, tree, specs)


def gather_axes(tree, specs, mesh, axes):
    """Each block of ``tree`` all-gathered over the dims ``specs`` shards over
    ``axes`` (whole over them, still blocked over the rest): a serving
    replica's weights, used under ``models.pshard.whole_over(axes)``."""
    names = set(axes if isinstance(axes, tuple) else (axes,))

    def visit(t, spec):
        for i, ax in enumerate(spec):
            parts = ax if isinstance(ax, tuple) else (ax,)
            if ax is not None and names & set(parts) and mesh_axis_size(mesh, ax) > 1:
                t = _gather_dim(t, ax, i, mesh)
        return t

    with torch.no_grad():
        return tree_map(visit, tree, specs)


def relayout(t: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """``t``, this rank's block laid out by spec ``src``, as its block under
    ``dst``: dimensions sharded in ``src`` and not in ``dst`` are
    all-gathered, those sharded in ``dst`` alone are cut. Equal specs give
    ``t`` itself (no copy)."""
    if tuple(src) == tuple(dst):
        return t
    with torch.no_grad():
        for i, (a, b) in enumerate(zip(src, dst)):
            if a is not None and a != b and mesh_axis_size(mesh, a) > 1:
                t = _gather_dim(t, a, i, mesh)
        for i, (a, b) in enumerate(zip(src, dst)):
            if b is not None and a != b:
                n = t.shape[i] // mesh_axis_size(mesh, b)
                t = t.narrow(i, mesh.index(b) * n, n)
    return t


RING_LEAVES = ("k", "v", "c_kv", "k_rope")  # (B, L, ...): dim 1 the ring's slots


def _sharded(spec, mesh):
    return tuple(None if ax is None or mesh_axis_size(mesh, ax) == 1 else ax for ax in spec)


@contextlib.contextmanager
def cache_at_use(cache: Dict, store, comp, mesh, layer=None):
    """One layer's decode caches (a dict of leaves, the rank's blocks laid out
    by ``store``) in the layout ``comp`` the layer's decode step computes on,
    for the ``with`` body; after it, what the step wrote goes back to the
    stored blocks: of a ring leaf, the one slot at the layer's ``index`` (as
    it was before the body advanced it), on the rank that holds it; of any
    other leaf, the whole block. Leaves laid out alike are the stored blocks
    themselves, written in place. With ``layer``, the leaves and specs are a
    stack's (dim 0 the layers) and the layer is taken from the rank that
    holds it where ``store`` splits the stack. Without a layout (``store``
    None) the caches as they are."""
    if store is None:
        yield cache if layer is None else {k: t[layer] for k, t in cache.items()}
        return
    held, work, specs = {}, {}, {}
    for k, t in cache.items():
        a, b = _sharded(store[k], mesh), _sharded(comp[k], mesh)
        mine = True
        if layer is not None:
            if b[0] is not None:
                raise NotImplementedError(f"cache leaf {k}: a compute layout {comp[k]} "
                                          "that splits the layers")
            n = t.shape[0]
            held[k] = t[layer % n]
            if a[0] is not None:  # the stack split: every rank takes the holder's layer
                mine = mesh.index(a[0]) == layer // n
                from repro_torch.models import pshard

                t = pshard.gather_parts(held[k], a[0], mesh, kind="all_gather")[layer // n]
            else:
                t = held[k]
            a, b = a[1:], b[1:]
        else:
            held[k] = t
        specs[k] = (a, b, mine)
        work[k] = relayout(t, a, b, mesh)
    moved = [k for k in cache if work[k] is not held[k]]
    slot = None
    if any(k in RING_LEAVES for k in moved):
        index = work["index"]
        if index.dim():
            raise NotImplementedError("a sharded decode step writes one ring slot a "
                                      "layer, not one per row")
        slot = index.clone()
    yield work
    with torch.no_grad():
        for k in moved:
            t, w, (a, b, mine) = held[k], work[k], specs[k]
            if k not in RING_LEAVES:
                back = relayout(w, b, a, mesh)
                if mine:
                    t.copy_(back)
                continue
            at = torch.remainder(slot, w.shape[1]).reshape(1).long()
            off_ring = [None if i == 1 else ax for i, ax in enumerate(a)]
            row = relayout(w.index_select(1, at),
                           [None if i == 1 else ax for i, ax in enumerate(b)], off_ring, mesh)
            if not mine:
                continue
            n = t.shape[1]
            here = at - (0 if a[1] is None else mesh.index(a[1]) * n)
            own = (here >= 0) & (here < n)
            here = here.clamp(0, n - 1)
            t.index_copy_(1, here, torch.where(own, row, t.index_select(1, here)))
