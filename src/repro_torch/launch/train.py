"""Training launcher. Port of ``repro/launch/train.py``:

    python -m repro_torch.launch.train --arch <id> [--device cpu|cuda] [...]
    torchrun --nproc-per-node N -m repro_torch.launch.train --arch <id>

The reduced config by default, the published one with ``--production``,
sharded over a mesh of the world's ranks: the process group starts with
NCCL on the cards (``--device cuda``, the default) or gloo on the CPU
when asked (``--device cpu``), its world from ``torchrun``'s environment
(one rank without it). Sealed checkpoints every ``--checkpoint-every``
steps, written by rank 0, and a second run with the same
``--checkpoint-dir`` resumes from the newest one. Rank 0 prints the
reference's final metrics dict.

The mesh, as the reference's: ``--multi-pod`` the 2x16x16 production mesh
(a world of 512 ranks, else it raises naming that size), ``--production``
the 16x16 one on a world of 256, and otherwise (``--production`` on any
other world, or neither flag) the host mesh ``data = max(1, n // 2)``,
``model = min(2, n)`` over the first ``data * model`` of the world's
``n`` ranks. ``--production`` refuses a config whose f32 state does not
fit one card (``card_bytes``): the params, gradients (and microbatch
accumulator) and AdamW state divided over the mesh, or, at a fresh
start, the params' blocks beside the one whole leaf that
``rules.init_params`` draws at a time. ``--checkpoint-dir`` defaults to ``repro_ckpt``
in the temporary directory (``TMPDIR``), where the reference's is
``/tmp/repro_ckpt``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.config import SealConfig, TrainConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                     make_production_mesh,
                                     shutdown_distributed, world_size)
from repro_torch.models import transformer as T
from repro_torch.runtime.fault import Heartbeat, StepWatchdog
from repro_torch.train.loop import train
from repro_torch.tree import leaves


def training_bytes(cfg, microbatches: int) -> int:
    """Bytes of f32 params, gradients, the microbatch accumulator (when
    there is one) and AdamW's m and v, before any activation."""
    n = sum(p.numel() for p in leaves(T.param_spec(cfg)))
    return n * 4 * (4 + (microbatches > 1))


def card_bytes(cfg, microbatches: int, devices: int) -> float:
    """Bytes of f32 state a card holds at the larger of two moments, before
    any activation: a step (``training_bytes`` divided over the mesh's
    ``devices``), and a fresh start (``rules.init_params``), where each
    leaf is drawn whole on the card, one at a time, beside the blocks of
    the leaves drawn before it."""
    sizes = [p.numel() for p in leaves(T.param_spec(cfg))]
    return max(training_bytes(cfg, microbatches) / devices,
               4 * (max(sizes) + sum(sizes) / devices))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--production", action="store_true",
                    help="the published config (on the 16x16 mesh when the "
                         "world has 256 ranks)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--seal", default="coloe",
                    choices=["none", "direct", "counter", "coloe"])
    ap.add_argument("--smart-ratio", type=float, default=0.5)
    ap.add_argument("--log", default=None)
    ap.add_argument("--heartbeat-dir", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    dtype = init_distributed(dev.type)
    try:
        return _run(args, dtype)
    finally:
        shutdown_distributed()


def _run(args, dtype: str) -> int:
    import torch.distributed as dist

    n = world_size()
    if args.multi_pod:
        if n != 512:
            raise SystemExit(f"--multi-pod needs a world of 512 ranks "
                             f"(2x16x16), have {n}")
        mesh = make_production_mesh(multi_pod=True, device_type=dtype)
    elif args.production and n == 256:
        mesh = make_production_mesh(device_type=dtype)
    else:
        mesh = make_host_mesh(data=max(1, n // 2), model=min(2, n),
                              device_type=dtype)
    cfg = get_config(args.arch) if args.production else get_reduced(args.arch)
    if args.production and dtype == "cuda":
        need = card_bytes(cfg, args.microbatches, mesh.size())
        have = torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory
        if need > have:
            raise SystemExit(
                f"--production {cfg.name}: f32 params, gradients and AdamW "
                f"state take {need / 2**30:.1f} GiB a card on the "
                f"{'x'.join(map(str, mesh.shape))} mesh (at a fresh start "
                f"the largest leaf is drawn whole on each card), of the "
                f"card's {have / 2**30:.1f} GiB, before activations")
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     microbatches=args.microbatches,
                     checkpoint_every=args.checkpoint_every,
                     checkpoint_dir=args.checkpoint_dir,
                     warmup_steps=max(2, args.steps // 10))
    seal = SealConfig(mode=args.seal, smart_ratio=args.smart_ratio)
    hb = None
    if args.heartbeat_dir:
        hb = Heartbeat(args.heartbeat_dir, host_id=f"host{dist.get_rank()}")
        hb.start()
    try:
        params, opt, metrics = train(
            cfg, tc, mesh, batch=args.batch, seq=args.seq, steps=args.steps,
            seal=seal if args.seal != "none" else None, log_path=args.log,
            watchdog=StepWatchdog(hard_limit_s=600))
        if dist.get_rank() == 0:
            print({k: float(v) for k, v in metrics.items()})
    finally:
        if hb:
            hb.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
