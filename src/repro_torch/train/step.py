"""The train step. Port of ``make_loss_fn`` and ``make_train_step`` from
``repro/train/step.py``.

The reference's ``jax.value_and_grad`` is autograd here (``make_grad_fn``),
its microbatch ``lax.scan`` a Python loop, and its donated buffers an
in-place AdamW update. ``make_prefill_step`` (the dry run's) waits for the
sharding slice (ROADMAP §1 item 6).
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, schedule
from repro_torch.tree import leaves, unflatten


def make_loss_fn(cfg: ModelConfig, remat: str):
    def loss_fn(params, batch):
        loss, metrics = T.forward(cfg, params, batch, remat=remat)
        return loss, metrics
    return loss_fn


def make_grad_fn(cfg: ModelConfig, remat: str):
    """grad_fn(params, batch) -> ((loss, metrics), grads): the reference's
    ``jax.value_and_grad(loss_fn, has_aux=True)``. The params are not
    modified; the values returned are detached, and a leaf the loss does
    not reach gets a zero gradient."""
    loss_fn = make_loss_fn(cfg, remat)

    def grad_fn(params, batch):
        ps = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(unflatten(params, ps), batch)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(ps, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), unflatten(params, grads)

    return grad_fn


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params', opt',
    metrics); params and opt_state are updated in place and returned.

    Gradient accumulation: the batch (a dict of tensors) is split on axis 0
    into ``tc.microbatches`` microbatches run in order; their gradients
    are summed in f32 as ``acc + g / n`` and the loss as ``acc + loss / n``,
    and the metrics are the last microbatch's, as the reference's scan
    gives them. ``lr`` is the schedule's at the step count before the
    update. The metrics are 0-d tensors: ``ce``, ``aux``, ``accuracy``,
    ``loss``, ``grad_norm`` and ``lr``."""
    grad_fn = make_grad_fn(cfg, tc.remat)

    def train_step(params, opt_state, batch):
        n = tc.microbatches
        if n > 1:
            micro = {k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
                     for k, x in batch.items()}
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=acc[0].device)
            for i in range(n):
                (loss_i, metrics), g = grad_fn(
                    params, {k: x[i] for k, x in micro.items()})
                for a, gi in zip(acc, leaves(g)):
                    a.add_(gi.float() / n)
                del g
                loss = loss + loss_i / n
            grads = unflatten(params, acc)
        else:
            (loss, metrics), grads = grad_fn(params, batch)
        lr = schedule.lr_at(opt_state["step"], tc)
        params, opt_state, gnorm = adamw.update(params, opt_state, grads,
                                                lr, tc)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return train_step
