"""EncryptionPlan: the SE policy (paper §3.1) over a parameter tree. Port of
``repro/core/plan.py``.

Every leaf is ``rows`` (weight matrices whose input rows are ℓ1-ranked, the
top-r fraction encrypted) or ``full`` (small tensors, always encrypted).
The embedding, the LM head and the first/last super-block are always fully
encrypted (the LM analogue of the paper's boundary-layer rule, §3.4.1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import SealConfig
from repro_torch.core.criticality import encryption_mask, row_importance
from repro_torch.tree import flatten_with_path


@dataclasses.dataclass
class LeafPlan:
    path: str
    mode: str                       # rows | full
    batch_axes: Tuple[int, ...]     # layer-stack axis
    row_axes: Tuple[int, ...]
    mask: Optional[torch.Tensor]    # (batch..., n_rows) bool; None for full
    total_bytes: int
    enc_bytes: int

    @property
    def enc_fraction(self) -> float:
        return self.enc_bytes / max(self.total_bytes, 1)


def _classify(path: Tuple[str, ...], ndim: int):
    """(batch_axes, row_axes) of a ``rows`` leaf, or None for ``full``."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    if name in ("wq", "wk", "wv"):
        return (0,), (1,)
    if parent == "attn" and name == "wo":
        return (0,), (1, 2)          # rows = (head, head_dim) inputs
    if parent == "mlp" and name in ("wi", "wg", "wo"):
        if ndim == 4:                # MoE: (n, e, d_in, d_out)
            return (0, 1), (2,)
        return (0,), (1,)
    if name == "router":
        return (0,), (1,)
    if parent == "rec" and name in ("w_x", "w_gate", "w_rg", "w_ig", "w_out"):
        return (0,), (1,)
    if parent == "ssd" and name in ("w_in", "w_out"):
        return (0,), (1,)
    if path[0] == "embed" and name == "w":
        return (), (0,)
    if path[0] == "head" and name == "w":
        return (), (0,)
    return None


def make_plan(params, seal: SealConfig) -> Dict[str, LeafPlan]:
    """The per-leaf plan, in flatten order (which ``seal_params`` keeps)."""
    plans: Dict[str, LeafPlan] = {}
    ratio = 1.0 if seal.mode == "none" else seal.smart_ratio
    for path, leaf in flatten_with_path(params):
        pstr = "/".join(path)
        nbytes = leaf.numel() * leaf.element_size()
        cls = _classify(path, leaf.ndim)
        boundary = seal.protect_boundary_layers and path[0] in ("embed", "head")
        if cls is None or ratio >= 1.0 or boundary:
            plans[pstr] = LeafPlan(pstr, "full", (), (), None, nbytes, nbytes)
            continue
        batch_axes, row_axes = cls
        mask = encryption_mask(row_importance(leaf, row_axes, batch_axes),
                               ratio)
        if seal.protect_boundary_layers and path[0] == "blocks" and \
                mask.ndim >= 1 and batch_axes[:1] == (0,):
            mask[0] = True               # first & last super-block
            mask[-1] = True
        frac = float(mask.to(torch.float32).mean())
        plans[pstr] = LeafPlan(pstr, "rows", batch_axes, row_axes, mask,
                               nbytes, int(round(nbytes * frac)))
    return plans


def plan_totals(plans: Dict[str, LeafPlan]) -> Dict[str, float]:
    tot = sum(p.total_bytes for p in plans.values())
    enc = sum(p.enc_bytes for p in plans.values())
    return {"total_bytes": tot, "enc_bytes": enc,
            "enc_fraction": enc / max(tot, 1)}


def expand_mask(plan: LeafPlan, shape) -> torch.Tensor:
    """Broadcast the row mask to the full leaf shape (True = encrypted)."""
    if plan.mask is None:
        return torch.ones(shape, dtype=torch.bool)
    row_shape = tuple(shape[a] for a in plan.row_axes)
    m = plan.mask.reshape(tuple(plan.mask.shape[:len(plan.batch_axes)])
                          + row_shape)
    src_axes = tuple(plan.batch_axes) + tuple(plan.row_axes)
    for a in range(len(shape)):
        if a not in src_axes:
            m = m.unsqueeze(a)
    return m.expand(shape)
