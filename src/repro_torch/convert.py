"""Carry weights and state between the JAX reference and the port.

Both packages keep the same dict keys and layouts (HWIO conv weights,
``(in, out)`` fc weights, int32 ages and versions, f32 times), so a
conversion is a key-for-key copy through numpy. The one dtype that
differs: indices are int64 in the port (torch's index type).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.tree import tree_map

# the CNN's leaves and the ndim each must have (4-D HWIO conv weights)
_CNN_NDIM = {"conv1": (4, 1), "conv2": (4, 1), "fc1": (2, 1), "fc2": (2, 1)}


def _to_torch(tree, device):
    return tree_map(lambda a: torch.as_tensor(np.array(a), device=device), tree)


def _to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def params_from_jax(tree: Dict, device) -> Dict:
    """Port params from a reference param tree (numpy leaves, or anything
    ``np.array`` takes), same keys and layouts, on ``device``."""
    for name, (w_ndim, b_ndim) in _CNN_NDIM.items():
        if name in tree and (np.ndim(tree[name]["w"]), np.ndim(tree[name]["b"])) \
                != (w_ndim, b_ndim):
            raise ValueError(f"{name}: expected a {w_ndim}-D weight and a "
                             f"{b_ndim}-D bias in the reference layout")
    return _to_torch(tree, device)


def params_to_jax(params: Dict) -> Dict:
    """The inverse of ``params_from_jax``: a tree of numpy arrays that
    ``jax.numpy.asarray`` takes leaf by leaf."""
    return _to_numpy(params)


def state_from_jax(state: Dict, device) -> Dict:
    """Event state (``sim.events``) or scheduler state (``core.selection``)
    from the reference's dict of arrays, dtypes kept."""
    return _to_torch(state, device)


def state_to_jax(state: Dict) -> Dict:
    """The inverse of ``state_from_jax``."""
    return _to_numpy(state)
