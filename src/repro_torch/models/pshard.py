"""Activation-sharding context and the sharded LM's collectives.

Port of ``repro.models.pshard``. The launchers install a mesh
(``launch.mesh.Mesh``) with ``mesh_context``; model code reads
``axis_size``/``dp`` and runs the layer's own part of every op. Without a
mesh every helper is the identity, so the same model code runs unsharded.

The reference leaves the collectives to GSPMD. Here they are written out,
each over one axis's process group, each an ``autograd.Function`` whose
backward is its conjugate:

  * ``copy(x, axis)`` — identity; backward psums the gradient (a
    replicated activation entering a rank's own part of a layer);
  * ``psum(x, axis)`` — the ranks' partial sums added; backward identity;
  * ``all_gather(x, axis, dim)`` — the ranks' blocks concatenated in rank
    order; backward reduce-scatters the gradient (``grad="split"``: takes
    this rank's block, for a gather whose result is used alike on every
    rank);
  * ``reduce_scatter(x, axis, dim)`` — the ranks' partial sums added, this
    rank's block kept; backward all-gathers;
  * ``split(x, axis, dim)`` — this rank's block of a tensor every rank
    holds; backward all-gathers.

As in slice F (``core.distributed``) no float sum goes through
``all_reduce``, whose order is the library's: every element is summed in
rank order on one rank, so every rank gets the same bits and two runs
repeat bitwise. A psum is an all-to-all (each rank receives every rank's
copy of its 1/D of the payload and sums them in rank order: a
reduce-scatter) and an all-gather of the summed blocks: each rank receives
2 (D - 1) / D payloads from the others, what a ring all-reduce moves. Every
collective counts its calls and the bytes of the buffers it fills on this
rank (own block included), by kind (``counts``/``reset_counts``).

Where NCCL cannot serve (several ranks on one card: NCCL refuses two ranks
on one GPU) the world runs gloo, which moves host tensors only: a CUDA
tensor is staged through host memory for the collective and copied back.
The compute and every kernel stay on the card.

Under a dry mesh (``launch.mesh.make_dry_mesh``: one rank's view, no
process groups; the dry-run) the two functions that call
``torch.distributed``, ``gather_parts`` and ``_exchange``, return meta
tensors of the live shapes (D blocks; a (D, n) exchange) and every other
line, the counters included, is the live path's. A dry mesh takes a tuple
of axes by its product size, and raises on a tensor that is not on meta.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

_CTX = {"mesh": None, "seq_shard": False, "whole": ()}


@contextlib.contextmanager
def mesh_context(mesh):
    prev = _CTX["mesh"]
    _CTX["mesh"] = mesh
    try:
        yield
    finally:
        _CTX["mesh"] = prev


def current_mesh():
    return _CTX["mesh"]


def axis_size(name) -> int:
    mesh = _CTX["mesh"]
    if mesh is None:
        return 1
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= axis_size(n)
        return out
    return mesh.shape.get(name, 1)


def dp() -> Tuple[str, ...]:
    mesh = _CTX["mesh"]
    if mesh is None:
        return ()
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` hint. Eager code has no
    layout to hint: each rank already holds its block, so this returns
    ``x`` unchanged (after checking it has a dimension per named axis)."""
    if len(axes) > x.dim():
        raise ValueError(f"{len(axes)} axes for a {x.dim()}-d tensor")
    return x


@contextlib.contextmanager
def seq_sharded(enabled: bool):
    """Inside: the residual stream between layers is split over the
    sequence on ``model`` (``enter``/``leave`` gather and reduce-scatter)."""
    prev = _CTX["seq_shard"]
    _CTX["seq_shard"] = enabled and axis_size("model") > 1
    try:
        yield
    finally:
        _CTX["seq_shard"] = prev


def seq_shard() -> bool:
    return _CTX["seq_shard"]


@contextlib.contextmanager
def whole_over(axes):
    """Inside: the params are held whole over ``axes`` (each rank's blocks
    gathered over them once, ``sharding.gather_axes``, as a serving replica
    holds its weights): ``materialize`` gathers none of their dims and sums
    the leaves' gradients over them."""
    prev = _CTX["whole"]
    _CTX["whole"] = tuple(axes)
    try:
        yield
    finally:
        _CTX["whole"] = prev


def captured():
    """A context manager that restores the current mesh and sequence
    sharding: a checkpointed layer enters it, so the backward's recompute
    runs under the forward's context."""
    mesh, seq, whole = _CTX["mesh"], _CTX["seq_shard"], _CTX["whole"]

    @contextlib.contextmanager
    def ctx():
        prev = dict(_CTX)
        _CTX.update(mesh=mesh, seq_shard=seq, whole=whole)
        try:
            yield
        finally:
            _CTX.update(prev)

    return ctx


def index(axis) -> int:
    """This rank's coordinate on ``axis`` (0 without a mesh)."""
    mesh = _CTX["mesh"]
    return 0 if mesh is None or axis_size(axis) == 1 else mesh.index(axis)


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

COUNTS: Dict[str, Dict[str, int]] = {}


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> Dict[str, Dict[str, int]]:
    """{kind: {"calls": n, "bytes": b}}: the collectives since the last reset
    and the bytes of the buffers each filled on this rank (an all-gather: D
    blocks; a psum: the all-to-all's and the all-gather's, 2 payloads)."""
    return {k: dict(v) for k, v in COUNTS.items()}


@contextlib.contextmanager
def uncounted():
    """Inside: collectives leave the counts as they were (a report's gathers,
    not the step's)."""
    saved = counts()
    try:
        yield
    finally:
        COUNTS.clear()
        COUNTS.update(saved)


def _count(kind: str, nbytes: int) -> None:
    c = COUNTS.setdefault(kind, {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += nbytes


# ---------------------------------------------------------------------------
# Raw collectives (no autograd)
# ---------------------------------------------------------------------------


def gather_parts(x: torch.Tensor, axis, mesh=None, kind: Optional[str] = "all_gather"):
    """Every rank's ``x`` along ``axis``, in rank order, on ``x``'s device
    (a list of one where the axis has one rank), counted under ``kind``
    (None: not counted). A CUDA tensor in a gloo group is staged through
    host memory. A failed collective raises."""
    mesh = mesh if mesh is not None else _CTX["mesh"]
    if mesh is not None and mesh.dry:
        return _dry_parts(x, axis, mesh, kind)
    g = mesh.group(axis) if mesh is not None else None
    if g is None:
        return [x]
    d = torch.distributed.get_world_size(g)
    src = x.contiguous()
    is_bool = src.dtype == torch.bool
    if is_bool:
        src = src.to(torch.uint8)
    staged = src.is_cuda and torch.distributed.get_backend(g) == "gloo"
    if staged:
        src = src.cpu()  # host staging: gloo moves host tensors
    parts = [torch.empty_like(src) for _ in range(d)]
    torch.distributed.all_gather(parts, src, group=g)
    if kind is not None:
        _count(kind, d * src.numel() * src.element_size())
    if staged:
        parts = [p.to(x.device) for p in parts]
    if is_bool:
        parts = [p.to(torch.bool) for p in parts]
    return parts


def _dry(x: torch.Tensor) -> None:
    if not x.is_meta:
        raise ValueError(f"a dry mesh runs on meta tensors, got one on {x.device}")


def _dry_parts(x, axis, mesh, kind):
    """``gather_parts`` on a dry mesh: D meta blocks of ``x``'s shape,
    counted as the live gather counts them."""
    d = mesh.axis_size(axis)
    if d == 1:
        return [x]
    _dry(x)
    src = x.contiguous()
    if kind is not None:
        _count(kind, d * src.numel() * src.element_size())
    return [torch.empty_like(src) for _ in range(d)]


def _rank_sum(parts):
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _exchange(chunks: torch.Tensor, axis) -> torch.Tensor:
    """``chunks`` (D, n): chunk j goes to rank j; returns (D, n), row i the
    chunk rank i sent here (an all-to-all; host-staged as ``gather_parts``)."""
    mesh = _CTX["mesh"]
    if mesh.dry:
        _dry(chunks)
        return torch.empty_like(chunks.contiguous())
    g = mesh.group(axis)
    src = chunks.contiguous()
    staged = src.is_cuda and torch.distributed.get_backend(g) == "gloo"
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    torch.distributed.all_to_all_single(out, src, group=g)
    return out.to(chunks.device) if staged else out


def _reduce_blocks(x, axis, dim, kind):
    """This rank's block along ``dim`` of the ranks' ``x`` summed in rank
    order (an all-to-all of the blocks, then the sum); counted under
    ``kind`` unless None."""
    d = axis_size(axis)
    moved = x.movedim(dim, 0)
    chunks = moved.reshape(d, -1)
    got = _exchange(chunks, axis)
    if kind is not None:
        _count(kind, got.numel() * got.element_size())
    block = _rank_sum(list(got.unbind(0)))
    return block.reshape((moved.shape[0] // d,) + moved.shape[1:]).movedim(0, dim)


def _sum(x, axis, kind="psum"):
    """The ranks' ``x`` summed in rank order: reduce-scatter over a flat
    split into D blocks (padded), then all-gather the summed blocks."""
    d = axis_size(axis)
    flat = x.reshape(-1)
    pad = -flat.numel() % d
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    block = _reduce_blocks(flat, axis, 0, None)
    whole = torch.cat(gather_parts(block, axis, kind=None))
    _count(kind, 2 * whole.numel() * whole.element_size())
    return whole[:x.numel()].reshape(x.shape)


def _block(x, axis, dim):
    n = x.shape[dim] // axis_size(axis)
    return x.narrow(dim, index(axis) * n, n)


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, wire):
        ctx.axis, ctx.wire, ctx.dtype = axis, wire, x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        wired = g if ctx.wire is None else g.to(ctx.wire)
        return _sum(wired, ctx.axis).to(ctx.dtype), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, grad):
        ctx.axis, ctx.dim, ctx.grad = axis, dim, grad
        return torch.cat(gather_parts(x, axis, kind="all_gather"), dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "split":
            out = _block(g, ctx.axis, ctx.dim)
        else:
            out = _reduce_blocks(g, ctx.axis, ctx.dim, "reduce_scatter")
        return out.contiguous(), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _reduce_blocks(x, axis, dim, "reduce_scatter").contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(gather_parts(g, ctx.axis, kind="all_gather"), ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _block(x, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(gather_parts(g, ctx.axis, kind="all_gather"), ctx.dim), None, None


class _OneOwner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.owner = index(axis) == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.owner else torch.zeros_like(g)), None


def copy(x, axis, wire=None):
    """``x`` (the same on every rank of ``axis``) entering each rank's own
    part of a layer: identity; the backward psums the ranks' partial
    gradients (in dtype ``wire`` where given, cast back after the sum)."""
    if axis_size(axis) == 1:
        return x
    return _Copy.apply(x, axis, wire)


def psum(x, axis):
    """The ranks' partial ``x`` summed in rank order (every rank the same
    bits); the backward passes the gradient through."""
    if axis_size(axis) == 1:
        return x
    return _Psum.apply(x, axis)


def all_gather(x, axis, dim, grad: str = "reduce_scatter"):
    """The ranks' blocks of ``x`` concatenated along ``dim`` in rank order.
    The backward reduce-scatters (each rank's use is its own part) or, with
    ``grad="split"``, keeps this rank's block of the gradient (every rank
    used the result alike)."""
    if axis_size(axis) == 1:
        return x
    return _AllGather.apply(x, axis, dim, grad)


def reduce_scatter(x, axis, dim):
    """The ranks' partial ``x`` summed in rank order, this rank's block along
    ``dim`` kept; the backward all-gathers."""
    if axis_size(axis) == 1:
        return x
    return _ReduceScatter.apply(x, axis, dim)


def split(x, axis, dim):
    """This rank's block along ``dim`` of ``x`` (the same on every rank);
    the backward all-gathers the ranks' gradients of their blocks."""
    if axis_size(axis) == 1:
        return x
    return _Split.apply(x, axis, dim)


def one_owner(x, axis):
    """``x``, computed alike on every rank of ``axis``, with its gradient
    taken on the axis's rank 0 alone: where the params' gradients are summed
    over ``axis`` (``materialize``), a term every rank adds counts once."""
    if axis_size(axis) == 1:
        return x
    return _OneOwner.apply(x, axis)


# ---------------------------------------------------------------------------
# A layer's branch: in, out, and the leaves it uses
# ---------------------------------------------------------------------------


def enter(x, wire=None):
    """A branch's input (the normed residual, the same on every model rank)
    entering the rank's own part: ``copy`` over ``model``, or, with the
    sequence sharded, the rank's rows all-gathered."""
    if axis_size("model") == 1:
        return x
    if seq_shard():
        return all_gather(x, "model", 1)
    return copy(x, "model", wire)


def leave(y):
    """A branch's partial output summed over ``model`` (the rank's rows of
    the sum with the sequence sharded)."""
    if axis_size("model") == 1:
        return y
    if seq_shard():
        return reduce_scatter(y, "model", 1)
    return psum(y, "model")


def leave_rows(y):
    """A branch output whose rows (dim 1) are the rank's own, whole: gathered
    to every rank (grad: the rank's rows), or kept with the sequence
    sharded (the same rows)."""
    if axis_size("model") == 1 or seq_shard():
        return y
    return all_gather(y, "model", 1, grad="split")


def _has(spec, names) -> bool:
    for ax in spec:
        parts = ax if isinstance(ax, tuple) else (ax,)
        if any(p in names for p in parts):
            return True
    return False


def materialize(leaf, spec, keep=(), mode: str = "parallel"):
    """A leaf block (laid out by ``spec``) as the layer uses it: every
    sharded dimension not in ``keep`` (the dimensions the layer's parallel
    math consumes as they lie, over ``model``) all-gathered. Gradients:

    * a dimension over the data axes is reduce-scattered back (the FSDP
      layout); a leaf with none is ``copy``'d over them, so its gradient is
      summed over the data ranks, whose batches differ;
    * ``mode="parallel"`` (a leaf used inside a branch's own part, after
      ``enter``): a ``model`` dimension gathered is reduce-scattered back,
      and a leaf replicated over ``model`` is ``copy``'d over it: each rank's
      gradient is its part;
    * ``mode="replicated"`` (used alike on every model rank): a ``model``
      dimension gathered keeps its block of the gradient.
    """
    mesh = _CTX["mesh"]
    if mesh is None:
        return leaf
    dpax = dp()
    spec = [None if _has((ax,), _CTX["whole"]) else ax for ax in spec]
    for i, ax in enumerate(spec):
        if ax is None or i in keep or axis_size(ax) == 1:
            continue
        on_model = _has((ax,), ("model",))
        grad = "split" if (on_model and mode != "parallel") else "reduce_scatter"
        leaf = all_gather(leaf, ax, i, grad=grad)
    if not _has(spec, dpax):
        leaf = copy(leaf, dpax)
    if mode == "parallel" and not _has(spec, ("model",)):
        leaf = copy(leaf, "model")
    return leaf


def materialize_tree(tree: Dict, specs: Dict, keep: Optional[Dict] = None,
                     mode: str = "parallel") -> Dict:
    """``materialize`` over a layer's dict of leaves; ``keep`` maps a leaf
    name to the dimensions kept as they lie."""
    keep = keep or {}
    return {k: materialize(v, specs[k], keep.get(k, ()), mode) for k, v in tree.items()}
