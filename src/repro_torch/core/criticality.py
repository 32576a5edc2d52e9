"""Criticality-aware Smart Encryption (SE) — paper §3.1. Port of
``repro/core/criticality.py``.

Rank the input rows of each weight by ℓ1 norm and encrypt the top-r
fraction; rows with the smallest |w| sums may ship in plaintext. For conv
kernels (k, k, c_in, c_out) a row is an input channel; for matmul weights
an input feature.
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


def _l1_rows(w: torch.Tensor, row_axis: int) -> torch.Tensor:
    """ℓ1 of each index of ``row_axis``, summed in f64 and rounded to f32.

    The reference sums in f32. A CNN channel's ℓ1 runs over up to 4,608
    weights, and at 512 channels the two at a mask's edge can lie closer
    than the f32 sums' reduction-order error, which differs between the
    CPU and the card. The f64 sum rounded once is the same on both and
    ranks by the exact ℓ1; where the reference's f32 rounding ranks two
    such rows the other way, the masks part on those two rows."""
    dims = tuple(a for a in range(w.ndim) if a != row_axis)
    return w.double().abs().sum(dim=dims).float()


def conv_row_importance(w: torch.Tensor) -> torch.Tensor:
    """w: (k, k, c_in, c_out) -> (c_in,) ℓ1 per input channel."""
    return _l1_rows(w, 2)


def cnn_channel_masks(cfg, params, ratio: float,
                      protect_boundary: bool = True) -> dict:
    """Per weight layer (stage index -> bool row mask, True = encrypt).

    Paper §3.4.1: full encryption on the first two CONV layers, the last
    CONV layer, and the FC layers; SE on the rest. The encrypted input-FM
    channels of layer l are exactly the encrypted kernel rows of layer l
    (each kernel row convolves only its own input channel)."""
    conv_ids = [i for i, sp in enumerate(cfg.stages) if sp.kind == "conv"]
    fc_ids = [i for i, sp in enumerate(cfg.stages) if sp.kind == "fc"]
    always_full = set()
    if protect_boundary:
        always_full |= set(conv_ids[:2] + conv_ids[-1:] + fc_ids)
    masks = {}
    for i, sp in enumerate(cfg.stages):
        if sp.kind == "pool":
            continue
        w = params[i]["w"]
        r = 1.0 if i in always_full else ratio
        imp = conv_row_importance(w) if sp.kind == "conv" else _l1_rows(w, 0)
        masks[i] = encryption_mask(imp, r)
    return masks
