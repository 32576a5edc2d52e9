"""End-to-end training on the PyTorch port: the steps of
``examples/train_lm.py`` through ``repro_torch`` only, a ~100M-param LM
for a few hundred steps with the full stack (the data loader, AdamW +
cosine, remat, two microbatches, sealed ColoE checkpoints, the
preemption-safe loop, resume), on a 1x1 mesh as the reference's.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
      [--device cpu]
(the card by default; ``--tiny`` for a fast smoke run). The mesh's process
group is started here (NCCL on the card, gloo on the CPU) unless one is
up, and ended after. The metrics of every step go to
``<ckpt>/metrics.jsonl``.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch.distributed as dist

from repro_torch.config import ModelConfig, SealConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                     shutdown_distributed)
from repro_torch.runtime.fault import StepWatchdog
from repro_torch.train.loop import train
from repro_torch.tree import leaves


def lm_100m() -> ModelConfig:
    """~100M-param llama-style dense LM."""
    return ModelConfig(
        name="lm-100m", family="dense", num_layers=8, d_model=640,
        num_heads=10, num_kv_heads=5, head_dim=64, d_ff=2560,
        vocab_size=32_000, pattern=("attn",), tie_embeddings=True)


def configure(args):
    """(model config, train config) of the parsed arguments, as the
    reference's ``main`` makes them (``--tiny`` changes ``args``)."""
    cfg = lm_100m()
    if args.tiny:
        cfg = cfg.with_(num_layers=2, d_model=128, d_ff=512, num_heads=4,
                        num_kv_heads=2, vocab_size=1024)
        args.steps, args.seq = min(args.steps, 20), 64
    tc = TrainConfig(learning_rate=3e-4,
                     warmup_steps=max(10, args.steps // 10),
                     total_steps=args.steps, microbatches=2,
                     checkpoint_every=max(50, args.steps // 4),
                     checkpoint_dir=args.ckpt)
    return cfg, tc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_train_lm"))
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    cfg, tc = configure(args)

    dev = resolve_device(args.device)
    started = not dist.is_initialized()
    dtype = init_distributed(dev.type)
    try:
        mesh = make_host_mesh(data=1, model=1, device_type=dtype)
        params, opt, metrics = train(
            cfg, tc, mesh, batch=args.batch, seq=args.seq, steps=args.steps,
            seal=SealConfig(mode="coloe", smart_ratio=0.5),
            log_path=os.path.join(args.ckpt, "metrics.jsonl"),
            watchdog=StepWatchdog(hard_limit_s=300))
    finally:
        if started:
            shutdown_distributed()
    n = sum(x.numel() for x in leaves(params))
    print(f"trained {cfg.name} ({n/1e6:.1f}M params) for {args.steps} steps: "
          f"final loss={float(metrics['loss']):.4f} "
          f"ce={float(metrics['ce']):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
