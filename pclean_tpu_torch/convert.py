"""State exchange with the JAX package, as numpy.

The JAX package's (arenas, params) and relational state are nested dicts of
arrays with the same keys as the port's; these helpers move them across as
numpy so both packages can be fed the same state (the parity tests do).
Nothing here imports jax: callers pass `np.asarray`-able leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils import resolve_device


def to_torch(tree, device=None):
    """Nested dicts/tuples/lists of array-likes -> the same of tensors on
    `device` (the card unless the caller asks for "cpu", as the entry points
    resolve it)."""
    return _to_torch(tree, resolve_device(device))


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v, device) for v in tree)
    return torch.as_tensor(np.asarray(tree), device=device)


def to_numpy(tree):
    """Nested dicts/tuples/lists of tensors -> the same of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
