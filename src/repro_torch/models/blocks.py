"""Residual attention blocks over the paged cache view. Port of
``attn_block_sub_apply`` (modes ``decode`` and ``chunk``) and
``block_apply`` from ``repro/models/blocks.py``. MoE, RG-LRU and SSD blocks
and the train/prefill modes come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L


def attn_block_sub_apply(cfg: ModelConfig, kind: str, p, h, positions, mode,
                         cache):
    """decode: attend into [cache view ++ new kv]; chunk: scatter the
    chunk's new K/V into the dense view at their absolute positions (view
    index == position), then attend. Returns (out, {"k_new", "v_new"})."""
    window = cfg.window if kind == "local_attn" else 0
    k_new, v_new = L.project_kv(cfg, p, h, positions)
    dt = cache["k"].dtype
    k_new, v_new = k_new.to(dt), v_new.to(dt)
    if mode == "decode":
        k_att = torch.cat([cache["k"], k_new], dim=1)
        v_att = torch.cat([cache["v"], v_new], dim=1)
        if positions.ndim != 2:
            raise ValueError("paged decode takes per-slot (B, 1) positions")
        pos_att = torch.cat([cache["pos"], positions], dim=1)
    elif mode == "chunk":
        # rows are ragged: row i holds cache["cl"][i] real tokens; padded
        # tokens go to one extra column that is cut off again (the
        # reference's dropped out-of-bounds scatter)
        b, w = cache["k"].shape[:2]
        c = positions.shape[1]
        col = torch.arange(c, device=positions.device)[None, :]
        tgt = torch.where(col < cache["cl"][:, None], positions,
                          torch.full_like(positions, w))
        rows = torch.arange(b, device=positions.device)[:, None]

        def splice(view, new):
            ext = torch.cat([view, view.new_zeros((b, 1) + view.shape[2:])],
                            dim=1)
            ext[rows, tgt] = new
            return ext[:, :w]

        k_att, v_att = splice(cache["k"], k_new), splice(cache["v"], v_new)
        pos_att = cache["pos"]
    else:
        raise NotImplementedError(f"block mode {mode!r} is not ported yet")
    out, _ = L.attention_apply(cfg, p, h, positions, window=window,
                               kv_override=(k_att, v_att, pos_att))
    return out, {"k_new": k_new, "v_new": v_new}


def block_apply(cfg: ModelConfig, kind: str, p, x, positions, mode, cache):
    """Returns (x_out, cache update, aux_loss)."""
    if kind not in ("attn", "local_attn"):
        raise NotImplementedError(f"{kind!r} blocks are not ported yet")
    h = L.apply_norm(cfg, p["norm1"], x)
    sub, update = attn_block_sub_apply(cfg, kind, p["attn"], h, positions,
                                       mode, cache)
    x = x + sub.to(x.dtype)
    if cfg.d_ff:
        h2 = L.apply_norm(cfg, p["norm2"], x)
        x = x + L.mlp_apply(cfg, p["mlp"], h2).to(x.dtype)
    return x, update, 0.0
