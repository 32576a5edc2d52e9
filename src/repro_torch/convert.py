"""Weights from the JAX package into the port.

The tests make params with the reference's ``init_params`` or ``init_cnn``,
take them to numpy (``jax.tree.map(np.asarray, params)``) and hand both
packages the same numbers through ``params_from_numpy``: the port's own
draws (``prng.py`` reproduces jax's threefry bit for bit, and its
``normal`` to within 3 ulp) are not needed for a comparison of what a
model computes. Trees of dicts, tuples and lists cross as they are: a
CNN's list of per-stage dicts keeps its ``{}`` for a pool. Only numpy
crosses the boundary; this module imports neither JAX nor the reference
package.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device=None):
    """Nested dicts/tuples of numpy arrays -> the same tree of torch tensors
    (same paths, so the same sealing nonces)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
