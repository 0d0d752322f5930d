"""Meshes of ranks for the sharded LM (``sharding.py``, ``models/pshard.py``).

Port of ``repro.launch.mesh``. A mesh is a value: its axis names and sizes
(``shape``, an ordered dict, as the reference's ``Mesh.shape``), this
rank's coordinate on each axis, and one process subgroup per axis (the
ranks that differ from this one on that axis alone). Ranks are laid out
row-major over the axes, the last axis fastest: on a (data, model) mesh
rank ``r`` sits at ``data = r // model``, ``model = r % model``.

``make_host_mesh(model_axis)`` spans the default process group (a world of
one is started when there is none, as ``core.distributed.fleet_mesh``
does). ``make_production_mesh`` is abstract: the reference's 16 x 16 and
2 x 16 x 16 logical shapes with no ranks and no groups; the sharding rules
read its ``shape`` alone. Given a ``rank`` it is dry instead (as is any
``make_dry_mesh``): one rank's view of the mesh, its coordinates and no
process groups, for the dry-run (``launch.dryrun``). Under a dry mesh the
model runs the rank's part on meta tensors and every collective
(``models.pshard``) returns meta tensors of the live shapes and counts
what the live one would; a tuple of axes (the multi-pod mesh's
``("pod", "data")``) spans their product. A dry mesh is never taken for a
mesh without groups: it is marked ``dry``, and ``group`` raises on it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    shape: Dict[str, int]
    coords: Optional[Dict[str, int]] = None  # None: an abstract mesh
    groups: Optional[Dict[str, object]] = None  # axis -> process group (None: size 1)
    dry: bool = False  # one rank's view with no process groups (the dry-run)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        out = 1
        for n in self.shape.values():
            out *= n
        return out

    @property
    def abstract(self) -> bool:
        return self.coords is None

    def _names(self, axis) -> Tuple[str, ...]:
        names = axis if isinstance(axis, tuple) else (axis,)
        return tuple(n for n in names if n in self.shape)

    def axis_size(self, axis) -> int:
        out = 1
        for n in self._names(axis):
            out *= self.shape[n]
        return out

    def index(self, axis) -> int:
        """This rank's block index along ``axis`` (a tuple of axes: row-major
        over them, as a multi-axis ``PartitionSpec`` entry lays blocks)."""
        if self.abstract:
            raise ValueError("an abstract mesh has no ranks")
        out = 0
        for n in self._names(axis):
            out = out * self.shape[n] + self.coords[n]
        return out

    def group(self, axis):
        """The process group of ``axis``: None where the axis has one rank.
        A tuple of more than one axis of size > 1 has no group here (the host
        mesh has no ``pod`` axis)."""
        if self.abstract:
            raise ValueError("an abstract mesh has no process groups")
        if self.dry:
            raise ValueError("a dry mesh has no process groups")
        names = [n for n in self._names(axis) if self.shape[n] > 1]
        if not names:
            return None
        if len(names) > 1:
            raise NotImplementedError(f"no process group spans the axes {names}")
        return self.groups[names[0]]


def make_production_mesh(*, multi_pod: bool = False, rank: Optional[int] = None) -> Mesh:
    """The reference's logical production shapes: (data 16, model 16), or
    (pod 2, data 16, model 16) with ``multi_pod``. Abstract (no ranks, no
    devices; the sharding rules read its ``shape``), or, given ``rank``,
    that rank's dry mesh (``make_dry_mesh``)."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    return Mesh(shape) if rank is None else make_dry_mesh(shape, rank)


def make_dry_mesh(shape: Dict[str, int], rank: int = 0) -> Mesh:
    """Rank ``rank``'s dry view of a mesh of ``shape`` (ranks row-major over
    the axes, the last fastest, as ``make_host_mesh`` lays them): its
    coordinates, no process groups."""
    size = 1
    for n in shape.values():
        size *= n
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is not on a mesh of {size}")
    coords, r = {}, rank
    for name in reversed(list(shape)):
        coords[name] = r % shape[name]
        r //= shape[name]
    return Mesh(dict(shape), {n: coords[n] for n in shape}, dry=True)


def make_host_mesh(model_axis: int = 1, device=None) -> Mesh:
    """A (data, model) mesh over the default process group: ``model_axis``
    ranks on ``model``, the world's other factor on ``data``. Every rank of
    the group must call it (it makes the axes' subgroups). Without a group, a
    world of one is started on ``device`` (NCCL on CUDA, gloo on the CPU)."""
    from repro_torch.core.distributed import init_world_of_one

    dist = torch.distributed
    if not dist.is_initialized():
        init_world_of_one(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"a model axis of {model_axis} does not divide a world of {world}")
    shape = {"data": world // model_axis, "model": model_axis}
    coords = {"data": rank // model_axis, "model": rank % model_axis}
    return Mesh(shape, coords, _axis_groups(shape, coords))


def _axis_groups(shape: Dict[str, int], coords: Dict[str, int]) -> Dict[str, object]:
    """One subgroup per axis of size > 1: every rank makes every group (in the
    same order, as ``new_group`` requires) and keeps its own."""
    dist = torch.distributed
    names = list(shape)
    strides, s = {}, 1
    for n in reversed(names):
        strides[n] = s
        s *= shape[n]
    groups: Dict[str, object] = {}
    for n in names:
        if shape[n] == 1:
            groups[n] = None
            continue
        if shape[n] == s:  # the axis is the whole world
            groups[n] = dist.group.WORLD
            continue
        others = [m for m in names if m != n]
        mine = None
        for base in _grid(others, shape):
            start = sum(base[m] * strides[m] for m in others)
            ranks = [start + i * strides[n] for i in range(shape[n])]
            g = dist.new_group(ranks)
            if all(base[m] == coords[m] for m in others):
                mine = g
        groups[n] = mine
    return groups


def _grid(names, shape):
    """Every coordinate of the axes ``names``, row-major."""
    out = [{}]
    for n in names:
        out = [{**c, n: i} for c in out for i in range(shape[n])]
    return out
