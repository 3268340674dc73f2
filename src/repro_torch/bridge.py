"""Carry weights and caches between the JAX package and the port.

The port keeps the reference's tree paths and layouts (``wq`` (d, H, hd),
``wo`` (H, hd, d), MLP ``wg``/``wu`` (d, f), the leading ``layers`` axis of
stacked segments, caches as a list per segment of per-unit dicts), so a
tree copies leaf for leaf and nothing is transposed.  The trees on the JAX
side are host numpy arrays (``jax.tree.map(np.asarray, tree)``); this module
imports neither jax nor the JAX package.

numpy has no bfloat16 of its own: JAX hands bf16 leaves over as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` rejects, so they
go through float32 (exact) and are cast to ``torch.bfloat16``;
:func:`params_to_numpy` returns bf16 leaves as float32 arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .tree import tree_map


def tensor_from_numpy(arr, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def params_from_jax_numpy(tree: Dict[str, Any], model, device) -> Any:
    """Install a reference parameter tree (numpy leaves) into ``model``,
    path for path; the tree's structure must equal ``model.param_specs()``.
    Returns the model."""
    specs = model.param_specs()
    if _structure(tree) != _structure(specs):
        raise ValueError("parameter tree does not match the model's specs")
    return model.set_params(tree_map(lambda a: tensor_from_numpy(a, device),
                                     tree))


def params_to_numpy(model) -> Dict[str, Any]:
    """The model's parameters as a nested dict of numpy arrays."""
    return tree_map(tensor_to_numpy, model.params.to_dict())


def cache_from_jax_numpy(caches, device):
    """A reference cache tree (list per segment of per-unit dicts, numpy
    leaves) as tensors; or an encoder-decoder model's state ``(caches,
    (k, v))`` (the stacked self-attention cache and every layer's cross
    K/V), tuples kept as tuples."""
    if isinstance(caches, tuple):
        return tuple(cache_from_jax_numpy(c, device) for c in caches)
    return tree_map(lambda a: tensor_from_numpy(a, device), caches)


def cache_to_numpy(caches):
    """Inverse of :func:`cache_from_jax_numpy`: numpy leaves, tuples kept."""
    if isinstance(caches, tuple):
        return tuple(cache_to_numpy(c) for c in caches)
    return tree_map(tensor_to_numpy, caches)


def _structure(tree):
    """Paths and shapes of a tree's leaves (specs or arrays)."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in sorted(tree.items())}
    return tuple(tree.shape)
