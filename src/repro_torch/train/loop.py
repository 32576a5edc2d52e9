"""The training loop: async sealed checkpoints, preemption handling, a
straggler watchdog and resume. Port of ``repro/train/loop.py::train``.

``mesh_or_device`` is the reference's ``mesh``: a ``DeviceMesh`` takes the
reference's path (params, AdamW state and each batch laid out by
``param_pspecs``/``opt_pspecs``/``batch_pspecs`` as DTensors, the steps
under ``use_mesh(mesh, arch_rules(...))``, a resume restored onto the
mesh); a device (one card, or the CPU when the caller asks for it) trains
on plain tensors there. Either way the parameters start from
``init_params``'s numbers, so a sharded run starts from the unsharded
run's: on a mesh ``rules.init_params`` draws one leaf at a time and each
rank keeps its block before the next leaf is drawn, the AdamW state is
made as each rank's block of zeros, and a resume copies to each card only
its block of each restored leaf. The control flow is
the reference's: resume from the newest
complete checkpoint, the loader starting at its step; a blocking save when
the watchdog raises ``StragglerTimeout``; a save every
``checkpoint_every`` steps, blocking unless ``async_checkpoint``; a
blocking save and ``event=preempted_clean_exit`` when ``PreemptionGuard``
was triggered; and in ``finally`` the loader closed, the writer joined and
the log closed (and the guard's SIGTERM handler put back, which the
reference leaves installed).
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.checkpoint.manager import (CheckpointManager, _mesh_device,
                                            rebuild_tree)
from repro_torch.config import ModelConfig, SealConfig, TrainConfig
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import lm_batch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime.fault import (PreemptionGuard, StepWatchdog,
                                       StragglerTimeout)
from repro_torch.runtime.metrics import MetricsLogger
from repro_torch.sharding import rules
from repro_torch.sharding.api import is_dtensor, use_mesh
from repro_torch.train.step import make_train_step


def train(cfg: ModelConfig, tc: TrainConfig, mesh_or_device=None, *,
          batch: int, seq: int, steps: Optional[int] = None,
          seal: Optional[SealConfig] = None, log_path: Optional[str] = None,
          resume: bool = True, watchdog: Optional[StepWatchdog] = None):
    """Run (or resume) training on a ``DeviceMesh`` or a device (``None``:
    the card); returns (params, opt_state, last_metrics), the metrics as
    numpy scalars by sorted name (params and opt_state DTensors on a
    mesh)."""
    mesh = mesh_or_device if isinstance(mesh_or_device, DeviceMesh) \
        else None
    if mesh is None:
        dev = resolve_device(mesh_or_device)
        scope = contextlib.nullcontext()
    else:
        dev = resolve_device(_mesh_device(mesh))
        scope = use_mesh(mesh, rules.arch_rules(cfg, mesh))
    with scope:
        return _train(cfg, tc, mesh, dev, batch, seq, steps, seal, log_path,
                      resume, watchdog)


def _train(cfg, tc, mesh, dev, batch, seq, steps, seal, log_path, resume,
           watchdog):
    steps = steps if steps is not None else tc.total_steps
    log = MetricsLogger(log_path)
    guard = PreemptionGuard()
    ckpt = CheckpointManager(tc.checkpoint_dir, seal=seal, device=dev)
    step_fn = make_train_step(cfg, tc)
    p_place = o_place = b_place = None
    if mesh is not None:
        p_place = (mesh, rules.param_pspecs(cfg, mesh))
        o_place = (mesh, rules.opt_pspecs(cfg, mesh))
        b_place = (mesh, rules.batch_pspecs(cfg, mesh, "train"))

    start_step = 0
    if resume and ckpt.list_steps():
        start_step, host = ckpt.restore()
        pspec = T.param_spec(cfg)
        params = rebuild_tree(pspec, host["params"], p_place or dev)
        opt = rebuild_tree(adamw.init(pspec), host["opt"], o_place or dev)
        log.log(start_step, event="resumed")
    elif mesh is None:
        params = T.init_params(cfg, tc.seed, dev)
        opt = adamw.init(params)
    else:
        params = rules.init_params(cfg, tc.seed, mesh, dev)
        opt = rules.zeros_tree(adamw.init(T.param_spec(cfg)), *o_place, dev)

    loader = PrefetchLoader(
        lambda s: lm_batch(cfg, batch, seq, s, seed=tc.seed),
        start_step=start_step, device=dev, sharding=b_place)
    metrics = {}
    try:
        for step, data in loader:
            if step >= steps:
                break
            t0 = time.time()
            params, opt, metrics = step_fn(params, opt, data)
            metrics = {k: _host(metrics[k]) for k in sorted(metrics)}
            dt = time.time() - t0
            if watchdog is not None:
                try:
                    watchdog.check(dt)
                except StragglerTimeout:
                    ckpt.save(step + 1, params, opt, blocking=True)
                    raise
            log.log(step, loss=float(metrics["loss"]),
                    ce=float(metrics["ce"]), lr=float(metrics["lr"]), sec=dt)
            if (step + 1) % tc.checkpoint_every == 0:
                ckpt.save(step + 1, params, opt,
                          blocking=not tc.async_checkpoint)
            if guard.requested:
                ckpt.save(step + 1, params, opt, blocking=True)
                log.log(step, event="preempted_clean_exit")
                break
    finally:
        loader.close()
        ckpt.wait()
        log.close()
        guard.close()
    return params, opt, metrics


def _host(v):
    return (v.full_tensor() if is_dtensor(v) else v).cpu().numpy()
