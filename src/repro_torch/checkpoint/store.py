"""Checkpoint store: a tree of tensors -> sharded .npz files + JSON manifest.

The port of ``repro.checkpoint.store``, in the same format: leaves named
by their path in the reference's pytree order (``core.tree.tree_paths``),
``.npz`` shards of at most ``_SHARD_BYTES``, a JSON manifest with every
leaf's dtype and shape, bf16 stored as its uint16 bit patterns, and each
shard's sha256 — re-checked on load, so a corrupted or truncated shard
fails loudly (``ValueError``) instead of silently resuming from garbage. A
checkpoint of plain tensors therefore loads with the reference's
``load_checkpoint``, and the reference's loads here.

``torch.Generator`` leaves (``Draws.get_state()`` gives one per stream)
take the place of the reference's typed PRNG keys: the generator's state
is stored as a uint8 leaf and tagged ``"generator"`` in the manifest, so a
mid-run engine state and its random streams restore bit for bit and the
run continues exactly where it crashed.
"""
from __future__ import annotations

import hashlib
import json
import os
import zipfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_map_with_path, tree_paths

_SHARD_BYTES = 512 * 1024 * 1024


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _to_numpy(leaf) -> Tuple[np.ndarray, Dict]:
    """The stored array of a leaf and its manifest fields."""
    if isinstance(leaf, torch.Generator):
        arr = leaf.get_state().numpy()
        return arr, {"dtype": str(arr.dtype), "shape": list(arr.shape),
                     "generator": leaf.device.type}
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16)
            return arr, {"dtype": "bfloat16", "shape": list(arr.shape),
                         "stored_as": "uint16_bf16"}
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, {"dtype": str(arr.dtype), "shape": list(arr.shape)}


def save_checkpoint(directory: str, tree: Any, step: int = 0) -> str:
    os.makedirs(directory, exist_ok=True)
    manifest: Dict = {"step": step, "leaves": [], "shards": []}
    shard_arrays: Dict[str, np.ndarray] = {}
    shard_id, shard_bytes = 0, 0
    for name, leaf in tree_paths(tree):
        arr, fields = _to_numpy(leaf)
        entry = {"name": name, **fields}
        if shard_bytes + arr.nbytes > _SHARD_BYTES and shard_arrays:
            _flush(directory, shard_id, shard_arrays, manifest)
            shard_arrays, shard_bytes = {}, 0
            shard_id += 1
        key = f"a{len(shard_arrays)}"
        shard_arrays[key] = arr
        entry["shard"] = shard_id
        entry["key"] = key
        shard_bytes += arr.nbytes
        manifest["leaves"].append(entry)
    if shard_arrays:
        _flush(directory, shard_id, shard_arrays, manifest)
    mpath = os.path.join(directory, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
    return mpath


def _flush(directory, shard_id, arrays, manifest):
    fname = f"shard_{shard_id:04d}.npz"
    fpath = os.path.join(directory, fname)
    np.savez(fpath, **arrays)
    manifest["shards"].append({"file": fname, "sha256": _sha256(fpath)})


def _load_shard(directory: str, entry) -> Any:
    fname = entry["file"]
    fpath = os.path.join(directory, fname)
    got = _sha256(fpath)
    if got != entry["sha256"]:
        raise ValueError(
            f"checkpoint shard {fname} is corrupted: sha256 {got} != "
            f"manifest {entry['sha256']} — refusing to restore"
        )
    try:
        shard = np.load(fpath)
        shard.files  # force the zip directory read
        return shard
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise ValueError(
            f"checkpoint shard {fname} is unreadable (truncated or "
            f"corrupted): {e}"
        ) from None


def _restore(name: str, arr: np.ndarray, entry: Dict, like):
    """One leaf of ``like``'s kind from its stored array: a tensor on
    ``like``'s device, or a generator on ``like``'s device."""
    if isinstance(like, torch.Generator):
        if "generator" not in entry:
            raise ValueError(f"{name}: the checkpoint holds no generator state")
        gen = torch.Generator(device=like.device)
        gen.set_state(torch.from_numpy(np.array(arr)))
        return gen
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {like.shape}")
    if entry.get("stored_as") == "uint16_bf16":
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def load_checkpoint(directory: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of tensors and
    generators): each tensor onto the device of its counterpart in
    ``like``, with the stored dtype."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    shards = [_load_shard(directory, e) for e in manifest["shards"]]
    by_name = {e["name"]: e for e in manifest["leaves"]}

    def one(name, leaf):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        e = by_name[name]
        return _restore(name, shards[e["shard"]][e["key"]], e, leaf)

    return tree_map_with_path(one, like), manifest["step"]
