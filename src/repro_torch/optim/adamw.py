"""Functional AdamW with global-norm clipping. Port of
``repro/optim/adamw.py``: params f32, m and v f32, the bias corrections
``b ** step`` in f32, weight decay on every leaf, the global norm summed
over the leaves in flatten order (``tree.leaves`` sorts dict keys as jax
does), and ``step`` an int32 tensor (the checkpoint's ``opt/step`` leaf).

``update`` is the PyTorch idiom: it writes params, m and v in place under
``torch.no_grad()``, leaf by leaf, where the reference returns new trees,
and returns the same tree objects. The arithmetic and its order per
element are the reference's; clipping scales each leaf's gradient inside
its own update instead of building a clipped copy of the whole tree. A
caller that must keep the pre-step values (a checkpoint snapshot) copies
them first.

Over DTensor leaves (a sharded run) m and v take their parameter's
placements, as the reference's ``opt_pspecs`` mirror ``param_pspecs``,
and ``step`` is replicated; the global norm's per-leaf sums come back
partial and are reduced, and each gradient arrives laid out as its
parameter (``train.step`` places it), so the in-place update is local.
"""
from __future__ import annotations

import torch

from repro_torch.config import TrainConfig
from repro_torch.sharding.api import is_dtensor
from repro_torch.tree import leaves, map_leaves


def init(params):
    z = map_leaves(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params)
    p0 = leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=p0.device)
    if is_dtensor(p0):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = p0.device_mesh
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return {"m": z, "v": map_leaves(torch.zeros_like, z), "step": step}


def global_norm(tree) -> torch.Tensor:
    total = 0
    for g in leaves(tree):
        total = total + g.float().square().sum()
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return map_leaves(lambda g: g * scale, grads), norm


@torch.no_grad()
def update(params, opt_state, grads, lr, tc: TrainConfig):
    """One AdamW step in place. Returns (params, opt_state, grad_norm),
    the trees the caller passed, updated."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, tc.grad_clip)
    step = opt_state["step"] + 1
    b1, b2 = tc.b1, tc.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, m, v, g in zip(leaves(params), leaves(opt_state["m"]),
                          leaves(opt_state["v"]), leaves(grads)):
        g = (g * scale).float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        upd = (m / bc1) / ((v / bc2).sqrt() + tc.eps) + tc.weight_decay * p
        p.sub_((lr * upd).to(p.dtype))
    opt_state["step"] = step
    return params, opt_state, gnorm
