"""int8 error-feedback gradient compression for the cross-pod axis. Port of
``repro/optim/grad_compress.py`` (``compress``, ``decompress``,
``ef_step``, ``ef_init``), bit for bit: ``torch.round`` and ``jnp.round``
both round half to even.

    compressed, scale = compress(g + error)
    g_hat             = decompress(compressed, scale)
    error'            = (g + error) - g_hat          # carried to next step

The reference's ``allreduce_compressed`` (a quantized psum over a named
mesh axis) needs a process group; it waits for the sharding slice
(ROADMAP §1 item 6).
"""
from __future__ import annotations

import torch

from repro_torch.tree import map_leaves


def compress(g: torch.Tensor):
    """g: f32 -> (int8 codes, f32 scale per tensor)."""
    amax = g.abs().max()
    scale = torch.clamp(amax, min=1e-30) / 127.0
    codes = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return codes, scale


def decompress(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.float() * scale


def ef_step(g: torch.Tensor, error: torch.Tensor):
    """One error-feedback compression step. Returns (g_hat, new_error)."""
    tot = g.float() + error
    codes, scale = compress(tot)
    g_hat = decompress(codes, scale)
    return g_hat, tot - g_hat


def ef_init(params):
    return map_leaves(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)
