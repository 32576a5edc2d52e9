"""The training loop: async sealed checkpoints, preemption handling, a
straggler watchdog and resume. Port of ``repro/train/loop.py::train``.

The reference's ``mesh`` is ``device`` here (one card, or the CPU when the
caller asks for it); the sharding rules wait for ROADMAP §1 item 6.
Otherwise the control flow is the reference's: resume from the newest
complete checkpoint, the loader starting at its step; a blocking save when
the watchdog raises ``StragglerTimeout``; a save every
``checkpoint_every`` steps, blocking unless ``async_checkpoint``; a
blocking save and ``event=preempted_clean_exit`` when ``PreemptionGuard``
was triggered; and in ``finally`` the loader closed, the writer joined and
the log closed (and the guard's SIGTERM handler put back, which the
reference leaves installed).
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.checkpoint.manager import CheckpointManager, rebuild_tree
from repro_torch.config import ModelConfig, SealConfig, TrainConfig
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import lm_batch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime.fault import (PreemptionGuard, StepWatchdog,
                                       StragglerTimeout)
from repro_torch.runtime.metrics import MetricsLogger
from repro_torch.train.step import make_train_step


def train(cfg: ModelConfig, tc: TrainConfig, device=None, *, batch: int,
          seq: int, steps: Optional[int] = None,
          seal: Optional[SealConfig] = None, log_path: Optional[str] = None,
          resume: bool = True, watchdog: Optional[StepWatchdog] = None):
    """Run (or resume) training on ``device`` (``None``: the card); returns
    (params, opt_state, last_metrics), the metrics as numpy scalars by
    sorted name."""
    dev = resolve_device(device)
    steps = steps if steps is not None else tc.total_steps
    log = MetricsLogger(log_path)
    guard = PreemptionGuard()
    ckpt = CheckpointManager(tc.checkpoint_dir, seal=seal, device=dev)
    step_fn = make_train_step(cfg, tc)

    start_step = 0
    if resume and ckpt.list_steps():
        start_step, host = ckpt.restore()
        pspec = T.param_spec(cfg)
        params = rebuild_tree(pspec, host["params"], dev)
        opt = rebuild_tree(adamw.init(pspec), host["opt"], dev)
        log.log(start_step, event="resumed")
    else:
        params = T.init_params(cfg, tc.seed, dev)
        opt = adamw.init(params)

    loader = PrefetchLoader(
        lambda s: lm_batch(cfg, batch, seq, s, seed=tc.seed),
        start_step=start_step, device=dev)
    metrics = {}
    try:
        for step, data in loader:
            if step >= steps:
                break
            t0 = time.time()
            params, opt, metrics = step_fn(params, opt, data)
            metrics = {k: metrics[k].cpu().numpy() for k in sorted(metrics)}
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
