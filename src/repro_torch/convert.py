"""Carry weights and state between the JAX reference and the port.

Both packages keep the same dict keys and layouts (HWIO conv weights,
``(in, out)`` fc weights, int32 ages and versions, f32 times, the LM's
``(d_model, H, D)`` einsum weights stacked on a leading ``repeats`` axis,
``(B, L, Hk, D)`` ring caches with an int32 index, optimizer state as
``{m, v, t}``), so a conversion is a key-for-key copy through numpy. One
dtype that differs: indices are int64 in the port (torch's index type). bf16 leaves cross bit for bit: numpy
holds them as ``ml_dtypes.bfloat16``, which torch does not take, so they
go through an int16 view.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.tree import tree_map

# the CNN's leaves and the ndim each must have (4-D HWIO conv weights)
_CNN_NDIM = {"conv1": (4, 1), "conv2": (4, 1), "fc1": (2, 1), "fc2": (2, 1)}


def _leaf_to_torch(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(arr), device=device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only the way back to the reference needs it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _to_torch(tree, device):
    return tree_map(lambda a: _leaf_to_torch(a, device), tree)


def _to_numpy(tree):
    return tree_map(_leaf_to_numpy, tree)


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


def lm_params_from_jax(tree, device) -> Dict:
    """Port LM params (``models.transformer.init_params`` layout) from a
    reference param tree: dicts stay dicts, the ``blocks``/``prefix``/
    ``remainder`` tuples stay tuples, every dtype (bf16 too) bit for bit."""
    return _to_torch(tree, device)


def lm_params_to_jax(params) -> Dict:
    """The inverse of ``lm_params_from_jax``: numpy leaves (bf16 as
    ``ml_dtypes.bfloat16``) that ``jax.numpy.asarray`` takes."""
    return _to_numpy(params)


def lm_caches_from_jax(caches, device) -> Dict:
    """Port decode caches from the reference's (``init_decode_caches`` or
    ``prefill`` output): ``(B, L, Hk, D)`` K/V or MLA's ``c_kv``/``k_rope``
    latents, SSM states, whisper's ``self``/``cross_k``/``cross_v`` tree,
    and the int32 ``index``."""
    return _to_torch(caches, device)


def lm_caches_to_jax(caches) -> Dict:
    """The inverse of ``lm_caches_from_jax``."""
    return _to_numpy(caches)


def opt_state_from_jax(state, device) -> Dict:
    """Port optimizer state (``optim.optimizers``) from the reference's:
    AdamW's f32 moments ``m``/``v`` (trees shaped as the params) and its
    int32 step ``t``, SGD's momentum ``m``, or plain SGD's empty dict."""
    return _to_torch(state, device)


def opt_state_to_jax(state) -> Dict:
    """The inverse of ``opt_state_from_jax``."""
    return _to_numpy(state)
