"""Eager cost model: the FLOPs, bytes, kernels, collectives and memory of one
call, counted as it runs.

The port's counterpart of ``repro.roofline.hlo_cost``, which re-derives
FLOPs, bytes written and collective bytes from XLA's optimized HLO text and
multiplies every while-loop body by its trip count. The port has no
compiler and no HLO, and it has no loops to multiply: eager code runs every
layer and counts each once. ``analyze(fn, *args)`` runs ``fn`` under a
``TorchDispatchMode`` that sees every aten op after autograd (the backward,
and a checkpoint's recompute, included) and tallies:

* FLOPs: the ops ``torch.utils.flop_counter`` counts (matmuls, batched
  matmuls, einsum's bmm, convolutions), by its formulas;
* bytes written: each op's outputs, since eager code writes every result
  to memory (the reference's proxy for HBM traffic). Views and aliases
  (``_SKIP_BYTES_OPS``, and any op whose schema returns a view) and
  allocations (``empty``) write nothing, nor does a host tensor's upload
  (``torch.tensor``, ``as_tensor`` on a device: the card runs it below the
  dispatcher, out of any mode's sight). An in-place op writes what it
  mutates, and a slot write into a decode ring (``index_copy_``,
  ``index_put_``) writes its source, the slot, not the whole buffer, as
  the reference counts a ``dynamic-update-slice`` by its update;
* kernels: a hand-written kernel's launch goes through ctypes, which no
  dispatch mode sees, so each kernel wrapper reports its own work through
  ``kernels._report`` (launches, FLOPs, and bytes read and written, from
  the kernel module's ``cost``), on the card and on the meta device alike;
  a kernel's ``bytes`` are its outputs, as an op's are, and its inputs go
  to ``read_bytes`` beside them. The aten ops a wrapper runs around its
  launch (outputs, workspaces, layout copies) are the kernel's and are not
  counted again;
* collectives: the difference of ``models.pshard.counts()`` over the call;
* memory: the bytes of the arguments' storages, of the result's, and the
  peak of the live storages created during the call (tracked from each
  storage's creation to its release) above the arguments.

It works the same on meta and on CUDA tensors: the same model code
dispatches the same ops with the same shapes, so a step's FLOPs, bytes and
kernel tally on the meta device equal its run on the card
(``chip_smoke.py``'s ``dryrun`` phase holds them equal).
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _report

# ops that return a view or an alias of an input, or write nothing
_SKIP_BYTES_OPS = frozenset({
    "view", "_unsafe_view", "_reshape_alias", "reshape", "view_as", "transpose", "t",
    "permute", "expand", "expand_as", "slice", "select", "as_strided", "detach", "alias",
    "unsqueeze", "squeeze", "unbind", "split", "split_with_sizes", "chunk", "narrow",
    "movedim", "diagonal", "unfold", "view_as_real", "view_as_complex",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_local_scalar_dense", "set_", "resize_", "record_stream",
})
# a tensor made from host data (``torch.tensor``, ``as_tensor``): on the
# card its upload runs below the dispatcher and no mode sees it, so it is
# not counted on any device (meta shows it as ``lift_fresh`` and a
# ``_to_copy`` from the CPU)
_HOST_DATA_OPS = frozenset({"lift_fresh", "lift_fresh_copy"})
# in-place slot writes: the argument that holds what is written
_SLOT_WRITES = {"index_copy_": ("source", 3), "index_put_": ("values", 2),
                "_index_put_impl_": ("values", 2)}



def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):  # a tensor with no storage
        return None


class Tally:
    """The counts of one ``analyze`` call."""

    def __init__(self, args):
        self.flops = 0
        self.bytes = 0
        self.ops: Dict[str, List[int]] = {}  # aten name -> [calls, flops, bytes]
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}  # storage key -> bytes, created during the call
        self._seen = set()
        self._final: List[weakref.finalize] = []
        self.argument_bytes = 0
        for t in _tensors(args):
            st = _storage(t)
            if st is not None and st._cdata not in self._seen:
                self._seen.add(st._cdata)
                self.argument_bytes += st.nbytes()

    def kernel(self, name: str, flops: int, nread: int, nwritten: int) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0, "bytes": 0,
                                           "read_bytes": 0})
        k["launches"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nwritten)
        k["read_bytes"] += int(nread)

    def _release(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)
        self._seen.discard(key)

    def _track(self, outs) -> None:
        for t in outs:
            st = _storage(t)
            if st is None or st._cdata in self._seen:
                continue
            key, n = st._cdata, st.nbytes()
            self._seen.add(key)
            self._held[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            self._final.append(weakref.finalize(st, self._release, key))

    def op(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        self._track(outs)
        if _report.inside():
            return  # the kernel's own aten ops: its cost is reported whole
        name = func._schema.name.split("::")[-1]
        if name in _HOST_DATA_OPS or (name == "_to_copy" and _uploads(args, outs)):
            return
        flops = 0
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        if name in _SKIP_BYTES_OPS or func.is_view:
            nbytes = 0
        elif name in _SLOT_WRITES:
            key, pos = _SLOT_WRITES[name]
            src = kwargs.get(key, args[pos] if len(args) > pos else None)
            nbytes = _nbytes(src) if isinstance(src, torch.Tensor) else 0
        else:
            nbytes = sum(_nbytes(t) for t in outs)
        row = self.ops.setdefault(f"aten::{name}", [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def close(self) -> None:
        for f in self._final:
            f.detach()
        self._final.clear()


def _uploads(args, outs) -> bool:
    """A copy of a host tensor to another device."""
    src = args[0] if args and isinstance(args[0], torch.Tensor) else None
    return (src is not None and src.device.type == "cpu"
            and any(t.device.type != "cpu" for t in outs))


class _Mode(TorchDispatchMode):
    def __init__(self, tally: Tally):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.tally.op(func, args, kwargs, out)
        return out


def counts_since(before: Dict) -> Dict[str, Dict[str, int]]:
    """The collectives ``models.pshard`` counted since its ``counts()`` were
    ``before``, by kind ({"calls", "bytes"}; kinds with no call left out)."""
    from repro_torch.models import pshard

    out = {}
    for kind, c in pshard.counts().items():
        b = before.get(kind, {"calls": 0, "bytes": 0})
        calls, nbytes = c["calls"] - b["calls"], c["bytes"] - b["bytes"]
        if calls:
            out[kind] = {"calls": calls, "bytes": nbytes}
    return out


def analyze(fn: Callable, *args, **kwargs) -> Dict:
    """Run ``fn(*args, **kwargs)`` and count its cost (module docstring).
    Returns {"out": fn's result, "flops", "bytes", "ops" ({aten name:
    {"calls", "flops", "bytes"}}), "kernels" ({name: {"launches", "flops",
    "bytes"}}), "collectives" (pshard's kinds: {"calls", "bytes"}),
    "memory" ({"argument_bytes", "output_bytes", "peak_bytes"}: the
    arguments' storages and the peak of the live storages created during
    the call above them)}."""
    from repro_torch.models import pshard

    tally = Tally((args, kwargs))
    before = pshard.counts()
    _report.listen(tally.kernel)
    try:
        with _Mode(tally):
            out = fn(*args, **kwargs)
    finally:
        _report.unlisten(tally.kernel)
        tally.close()
    seen, out_bytes = set(), 0
    for t in _tensors(out):
        st = _storage(t)
        if st is not None and st._cdata not in seen:
            seen.add(st._cdata)
            out_bytes += st.nbytes()
    return {
        "out": out,
        "flops": tally.flops,
        "bytes": tally.bytes,
        "ops": {k: {"calls": c, "flops": f, "bytes": b} for k, (c, f, b) in tally.ops.items()},
        "kernels": {k: dict(v) for k, v in tally.kernels.items()},
        "collectives": counts_since(before),
        "memory": {"argument_bytes": tally.argument_bytes, "output_bytes": out_bytes,
                   "peak_bytes": tally.argument_bytes + tally.peak},
    }


def top_contributors(cost: Dict, n: int = 15) -> List[Dict]:
    """The largest rows of an ``analyze`` result, by aten op and by kernel,
    bytes first (then FLOPs): the dry-run's profile."""
    rows = [{"name": k, "kind": "op", "calls": v["calls"], "flops": v["flops"],
             "bytes": v["bytes"]} for k, v in cost["ops"].items()]
    rows += [{"name": k, "kind": "kernel", "calls": v["launches"], "flops": v["flops"],
              "bytes": v["bytes"]} for k, v in cost["kernels"].items()]
    rows.sort(key=lambda r: (-r["bytes"], -r["flops"], r["name"]))
    return rows[:n]
