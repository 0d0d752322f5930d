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


def tree_paths(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs in the reference's pytree order: dict keys
    sorted (``jax.tree_util`` flattens dicts that way), tuples and lists by
    position; ``path`` joins the keys and positions with ``/``, as the
    checkpoint manifest names leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in tree_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_map_with_path(fn: Callable, tree, *rest, prefix: str = ""):
    """``tree_map`` whose ``fn`` also takes the leaf's path (as
    ``tree_paths`` names it) as its first argument."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      prefix=f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                             prefix=f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree, *rest)
