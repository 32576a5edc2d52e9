"""The train and prefill steps. Port of ``make_loss_fn``,
``make_train_step`` and ``make_prefill_step`` from ``repro/train/step.py``.

The reference's ``jax.value_and_grad`` is autograd here (``make_grad_fn``),
its microbatch ``lax.scan`` a Python loop, its donated buffers an in-place
AdamW update, and its prefill's ``lax.map`` over batch chunks a loop. The
same steps run on plain tensors and on DTensors (a sharded run: params,
optimizer state and batch laid out by ``sharding.rules`` under
``use_mesh``).
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, schedule
from repro_torch.sharding.api import constrain, dtensor_scope, is_dtensor
from repro_torch.tree import flatten_with_path, leaves, unflatten


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
        # the backward of a DTensor forward meets the plain masks and
        # tables its forward saved, so it runs in the same scope
        with torch.enable_grad(), dtensor_scope(ps[0]):
            loss, metrics = loss_fn(unflatten(params, ps), batch)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _placed(g, p)
                 for p, g in zip(ps, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), unflatten(params, grads)

    return grad_fn


def _placed(g, p):
    """Gradient ``g`` laid out as its parameter ``p``: over DTensors the
    all-reduce or reduce-scatter of a ``Partial`` gradient (a leaf
    replicated on the axis that shards the batch), which GSPMD inserts in
    the reference."""
    if is_dtensor(g) and list(g.placements) != list(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


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
            # each microbatch split over the batch axes (over DTensors an
            # all-to-all: the reference's microbatch axis is replicated)
            micro = {k: constrain(
                x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:])),
                None, "batch", *([None] * (x.ndim - 1)))
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


def make_prefill_step(cfg: ModelConfig, cache_len: int, batch_chunks: int = 1):
    """prefill_step(params, batch) -> (last-position logits (B, V) f32,
    contiguous cache), the request batch (a dict of ``tokens`` or
    ``embeds``, or the token tensor) optionally in ``batch_chunks``
    sequential chunks, which bounds the transient activations. The chunks'
    caches merge as the reference's: ``pos`` from chunk 0 (it is the same
    in every chunk), every other leaf concatenated on its batch axis (the
    one after the layer stack)."""
    def prefill_step(params, batch):
        if batch_chunks <= 1:
            return T.prefill(cfg, params, batch, cache_len)
        cols = batch if isinstance(batch, dict) else {"": batch}
        b = next(iter(cols.values())).shape[0]
        assert b % batch_chunks == 0, (b, batch_chunks)
        bc = b // batch_chunks
        outs = []
        for c in range(batch_chunks):
            part = {k: v[c * bc:(c + 1) * bc] for k, v in cols.items()}
            outs.append(T.prefill(cfg, params, part.get("", part),
                                  cache_len))
        logits = torch.cat([o[0] for o in outs])
        caches = [flatten_with_path(o[1]) for o in outs]
        merged = [leaf if path[-1] == "pos" else
                  torch.cat([c[i][1] for c in caches], dim=1)
                  for i, (path, leaf) in enumerate(caches[0])]
        return logits, unflatten(outs[0][1], merged)
    return prefill_step
