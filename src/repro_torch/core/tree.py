"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Params and engine state are plain (possibly nested) dicts of tensors, so
checkpoints and the reference's trees convert key for key.
"""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]
