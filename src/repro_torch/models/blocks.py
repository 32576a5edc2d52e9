"""Residual attention blocks. Port of ``attn_block_sub_apply`` and
``block_apply`` from ``repro/models/blocks.py``, in three modes:

* ``prefill``: one-shot self-attention over the prompt (the flash kernel),
  which returns the contiguous layer cache it fills;
* ``decode``: attention into [cache ++ new kv], over the contiguous cache
  (1-D positions, one for the whole batch) or the paged view (per-slot
  (B, 1) positions);
* ``chunk``: chunked prefill over the paged view.

An MoE layer's MLP is ``layers.moe_apply_dense`` at decode and
``layers.moe_apply`` (capacity routing) in the other two modes. RG-LRU and
SSD blocks and the train mode come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import cache as MC
from repro_torch.models import layers as L


def attn_block_sub_apply(cfg: ModelConfig, kind: str, p, h, positions, mode,
                         cache):
    """prefill: self-attention of the prompt at positions ``arange(s)``;
    returns (out, new layer cache). decode: attend into [cache view ++ new
    kv]; chunk: scatter the chunk's new K/V into the dense view at their
    absolute positions (view index == position), then attend. Both return
    (out, {"k_new", "v_new"})."""
    window = cfg.window if kind == "local_attn" else 0
    if mode == "prefill":
        return _prefill_sub_apply(cfg, p, h, positions, window, cache)
    k_new, v_new = L.project_kv(cfg, p, h, positions)
    dt = cache["k"].dtype
    k_new, v_new = k_new.to(dt), v_new.to(dt)
    if mode == "decode":
        k_att = torch.cat([cache["k"], k_new], dim=1)
        v_att = torch.cat([cache["v"], v_new], dim=1)
        if positions.ndim == 2:
            # paged: per-slot positions (B, 1), per-slot key positions
            pos_att = torch.cat([cache["pos"], positions], dim=1)
        else:
            # contiguous: one position for the batch, key positions (L,)
            pos_att = torch.cat([cache["pos"], positions[:1].to(
                cache["pos"].dtype)])
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


def _prefill_sub_apply(cfg: ModelConfig, p, h, positions, window: int,
                       cache):
    """Self-attention of the prompt, then its K/V written into the layer's
    contiguous cache of ``cache_len`` slots: padded with ``INVALID_POS``
    slots when the prompt is shorter, else its last ``cache_len`` entries
    rolled so that slot == position % cache_len (the ring the decode write
    keeps)."""
    out, (k, v) = L.attention_apply(cfg, p, h, positions, window=window)
    cache_len = cache["k"].shape[1]
    s = k.shape[1]
    if s >= cache_len:
        shift = (s - cache_len) % cache_len
        ks = torch.roll(k[:, -cache_len:], shift, dims=1)
        vs = torch.roll(v[:, -cache_len:], shift, dims=1)
        ps = torch.roll(positions[-cache_len:], shift, dims=0)
    else:
        pad = cache_len - s
        ks = torch.cat([k, k.new_zeros((k.shape[0], pad) + k.shape[2:])], 1)
        vs = torch.cat([v, v.new_zeros((v.shape[0], pad) + v.shape[2:])], 1)
        ps = torch.cat([positions, positions.new_full((pad,),
                                                      MC.INVALID_POS)])
    return out, {"k": ks.to(cache["k"].dtype), "v": vs.to(cache["v"].dtype),
                 "pos": ps.to(torch.int32)}


def block_apply(cfg: ModelConfig, kind: str, p, x, positions, mode, cache):
    """Returns (x_out, cache update, aux_loss). An MoE layer routes as the
    reference's does: ``decode`` through the dropless dense path, ``chunk``
    and ``prefill`` through the capacity dispatch."""
    if kind not in ("attn", "local_attn"):
        raise NotImplementedError(f"{kind!r} blocks are not ported yet")
    aux = 0.0
    h = L.apply_norm(cfg, p["norm1"], x)
    sub, update = attn_block_sub_apply(cfg, kind, p["attn"], h, positions,
                                       mode, cache)
    x = x + sub.to(x.dtype)
    if cfg.d_ff:
        h2 = L.apply_norm(cfg, p["norm2"], x)
        if cfg.moe is None:
            m = L.mlp_apply(cfg, p["mlp"], h2)
        elif mode == "decode":
            m, aux = L.moe_apply_dense(cfg, p["mlp"], h2)
        else:
            m, aux = L.moe_apply(cfg, p["mlp"], h2)
        x = x + m.to(x.dtype)
    return x, update, aux
