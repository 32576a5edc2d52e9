"""Training launcher. Port of ``repro/launch/train.py``:

    python -m repro_torch.launch.train --arch <id> [--device cpu|cuda] [...]

The reduced config by default, the published one with ``--production``,
on one card (``--device cuda``, the default) or on the CPU when asked
(``--device cpu``); sealed checkpoints every ``--checkpoint-every`` steps,
and a second run with the same ``--checkpoint-dir`` resumes from the newest
one. It prints the reference's final metrics dict.

The reference runs ``--production`` on its 16x16 mesh and ``--multi-pod``
on two pods. Both need the sharding slice (ROADMAP §1 item 6): here
``--multi-pod`` is refused, and ``--production`` refuses a config whose f32
params, gradients (and microbatch accumulator) and AdamW state do not fit
the card. ``--checkpoint-dir`` defaults to ``repro_ckpt`` in the temporary
directory (``TMPDIR``), where the reference's is ``/tmp/repro_ckpt``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.config import SealConfig, TrainConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.runtime.fault import Heartbeat, StepWatchdog
from repro_torch.train.loop import train
from repro_torch.tree import leaves

SHARDING = ("needs the sharding slice (ROADMAP §1 item 6), which the port "
            "does not have yet")


def training_bytes(cfg, microbatches: int) -> int:
    """Bytes of f32 params, gradients, the microbatch accumulator (when
    there is one) and AdamW's m and v, before any activation."""
    n = sum(p.numel() for p in leaves(T.param_spec(cfg)))
    return n * 4 * (4 + (microbatches > 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--production", action="store_true",
                    help="the published config on the one card")
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

    if args.multi_pod:
        raise SystemExit(f"--multi-pod {SHARDING}")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.production else get_reduced(args.arch)
    if args.production and dev.type == "cuda":
        need = training_bytes(cfg, args.microbatches)
        have = torch.cuda.get_device_properties(dev).total_memory
        if need > have:
            raise SystemExit(
                f"--production {cfg.name}: f32 params, gradients and AdamW "
                f"state take {need / 2**30:.1f} GiB of the card's "
                f"{have / 2**30:.1f} GiB before activations; training it "
                f"{SHARDING}")
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     microbatches=args.microbatches,
                     checkpoint_every=args.checkpoint_every,
                     checkpoint_dir=args.checkpoint_dir,
                     warmup_steps=max(2, args.steps // 10))
    seal = SealConfig(mode=args.seal, smart_ratio=args.smart_ratio)
    hb = None
    if args.heartbeat_dir:
        hb = Heartbeat(args.heartbeat_dir, host_id="host0")
        hb.start()
    try:
        params, opt, metrics = train(
            cfg, tc, dev, batch=args.batch, seq=args.seq, steps=args.steps,
            seal=seal if args.seal != "none" else None, log_path=args.log,
            watchdog=StepWatchdog(hard_limit_s=600))
        print({k: float(v) for k, v in metrics.items()})
    finally:
        if hb:
            hb.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
