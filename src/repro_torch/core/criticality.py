"""Criticality-aware Smart Encryption (SE) — paper §3.1. Port of
``row_importance`` and ``encryption_mask`` from ``repro/core/criticality.py``.

Rank the input rows of each weight by ℓ1 norm and encrypt the top-r
fraction; rows with the smallest |w| sums may ship in plaintext.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def row_importance(w: torch.Tensor, row_axes: Sequence[int],
                   batch_axes: Sequence[int] = ()) -> torch.Tensor:
    """ℓ1 importance per input row, shape batch_axes + (prod(row_axes),)."""
    keep = tuple(batch_axes) + tuple(row_axes)
    reduce_axes = tuple(a for a in range(w.ndim) if a not in keep)
    imp = w.to(torch.float32).abs()
    if reduce_axes:
        imp = imp.sum(dim=reduce_axes)
    # remaining dims are the kept axes in ascending order; move them into
    # batch..., rows... order
    asc = sorted(keep)
    imp = imp.permute([asc.index(a) for a in keep])
    b = len(batch_axes)
    return imp.reshape(tuple(imp.shape[:b]) + (-1,))


def encryption_mask(importance: torch.Tensor, ratio: float) -> torch.Tensor:
    """Bool mask (True = encrypt) over the last axis: the top-⌈ratio·n⌉ rows
    by ℓ1 importance, ties broken by rank (stable sort), exactly k rows."""
    n = importance.shape[-1]
    k = int(np.ceil(ratio * n))
    if k <= 0:
        return torch.zeros(importance.shape, dtype=torch.bool,
                           device=importance.device)
    if k >= n:
        return torch.ones(importance.shape, dtype=torch.bool,
                          device=importance.device)
    order = torch.argsort(-importance, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return ranks < k
