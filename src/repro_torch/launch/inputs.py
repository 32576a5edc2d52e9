"""``input_specs``: stand-ins for every model input of an (arch x shape)
cell, as tensors on the ``meta`` device (shapes and dtypes, nothing
allocated). Port of ``repro/launch/inputs.py``.

Frontend-stub archs (``vit_stub``, ``encodec_stub``) take precomputed
frame/patch embeddings (B, S, D) in the compute dtype in place of tokens.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models.cache import model_cache_spec


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, kind: str) -> Dict:
    b = shape.global_batch
    s = shape.seq_len if kind != "decode" else 1
    out = {}
    if cfg.frontend is not None:
        out["embeds"] = _meta((b, s, cfg.d_model), getattr(torch, cfg.dtype))
    else:
        out["tokens"] = _meta((b, s), torch.int32)
    if kind == "train":
        out["targets"] = _meta((b, s), torch.int32)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """All step inputs of the cell (not the params or optimizer state):
    the batch, and at decode the contiguous cache and the position."""
    kind = shape.kind
    specs = {"batch": batch_specs(cfg, shape, kind)}
    if kind == "decode":
        specs["cache"] = model_cache_spec(cfg, shape.global_batch,
                                          shape.seq_len)
        specs["pos"] = _meta((), torch.int32)
    return specs
