"""Parameter trees: the port's stand-in for JAX pytrees.

Params, engine state and LM decode caches are plain nested dicts, tuples
and lists of tensors (an LM's ``params["blocks"]`` is a tuple with one
entry per pattern layer; its ``prefix``/``remainder`` caches are lists),
so checkpoints and the reference's trees convert key for key.
"""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of the same structure; dicts keep
    their keys, tuples and lists their type."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in key order (dicts) and position order (tuples, lists)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
