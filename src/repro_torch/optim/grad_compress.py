"""int8 error-feedback gradient compression for the cross-pod axis. Port of
``repro/optim/grad_compress.py`` (``compress``, ``decompress``,
``ef_step``, ``ef_init``), bit for bit: ``torch.round`` and ``jnp.round``
both round half to even.

    compressed, scale = compress(g + error)
    g_hat             = decompress(compressed, scale)
    error'            = (g + error) - g_hat          # carried to next step

``allreduce_compressed`` is the quantized mean-all-reduce over a process
group (the reference's psum over a named mesh axis inside ``shard_map``):
the int8 codes summed as int32, exact in any order, and the scales summed
in f32.
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


def allreduce_compressed(g: torch.Tensor, group=None) -> torch.Tensor:
    """Quantized mean-all-reduce over ``group`` (the default group when
    None; a mesh axis's group is ``mesh.get_group("pod")``): each rank
    contributes int8 codes and its scale; the codes are summed in int32,
    then rescaled by the mean of the scales (a 4-byte all-reduce)."""
    import torch.distributed as dist

    codes, scale = compress(g)
    n = dist.get_world_size(group)
    sum_codes = codes.to(torch.int32)
    dist.all_reduce(sum_codes, group=group)
    scale = scale.reshape(1).clone()
    dist.all_reduce(scale, group=group)
    mean_scale = scale[0] / n
    return sum_codes.float() * mean_scale / n


def ef_init(params):
    return map_leaves(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)
