"""Paged KV-cache passes: batched decode and chunked prefill over block
pools. Port of ``_dense_view``, ``decode_logits``, ``chunk_logits`` and
``append_tokens`` from ``repro/models/paged.py`` (the MAC branches come with
the integrity slice).

With a ``CacheSeal`` the pools hold ciphertext: a block is XORed with a
ChaCha20 keystream derived from (pool block address, per-block write
counter, layer id) (``kernels.ref.cache_block_otp``; the ChaCha kernel on
the card). The reference's order is kept: gather -> unseal -> zero the
entries past each slot's length -> attend, and every write decrypts the
touched blocks, splices the new tokens in and re-seals them under
``wc + 1`` — so pools and counters match the reference word for word after
the same operations. The reference's ``lax.scan`` over super-blocks is a
Python loop over layers; the pools and ``wc`` are updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import u32
from repro_torch.config import ModelConfig
from repro_torch.core.sealed_store import CacheSeal
from repro_torch.kernels import ref as KR
from repro_torch.models import blocks as B
from repro_torch.models import cache as MC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _dense_view(cfg: ModelConfig, seal: Optional[CacheSeal], pool_j,
                tables, lengths, wc, pos_len=None):
    """One layer's blocks gathered into the dense {"k","v","pos"} view.

    pool_j: {"k","v": (NB, wpb) int32, "lid": ()}; tables (B, MB) block ids;
    lengths (B,); wc (NB,) int32 words. k/v come back (B, L, kv_heads,
    head_dim) with L = MB * block_size, zero at and past each slot's length;
    pos is INVALID_POS past ``lengths`` (or past ``pos_len`` for the chunk
    path, whose fresh keys are spliced into the zeroed tail)."""
    b, mb = tables.shape
    wpb = pool_j["k"].shape[-1]
    bs = wpb // MC.kv_words_per_token(cfg)
    seq = mb * bs
    kw = pool_j["k"][tables]                       # (B, MB, wpb)
    vw = pool_j["v"][tables]
    if seal is not None:
        wcb = wc[tables]
        kw = kw ^ KR.cache_block_otp(seal.key_words, seal.nonce_k, tables,
                                     wcb, pool_j["lid"], wpb)
        vw = vw ^ KR.cache_block_otp(seal.key_words, seal.nonce_v, tables,
                                     wcb, pool_j["lid"], wpb)
    dt = L.cdtype(cfg)
    shape = (b, seq, cfg.num_kv_heads, cfg.head_dim)
    k = MC.words_to_kv(kw, dt).reshape(shape)
    v = MC.words_to_kv(vw, dt).reshape(shape)
    pos = torch.arange(seq, device=tables.device)[None, :]
    valid = pos < lengths[:, None]                 # (B, L)
    zero = torch.zeros((), dtype=dt, device=k.device)
    k = torch.where(valid[..., None, None], k, zero)
    v = torch.where(valid[..., None, None], v, zero)
    vpos = valid if pos_len is None else pos < pos_len[:, None]
    pos = torch.where(vpos, pos, torch.full_like(pos, MC.INVALID_POS))
    return {"k": k, "v": v, "pos": pos}


def _layer_slices(params, pools, j: int, i: int):
    p = T.layer_params(params, j, i)
    pool = {"k": pools[j]["k"][i], "v": pools[j]["v"][i],
            "lid": pools[j]["lid"][i]}
    return p, pool


def _run_layers(cfg, params, pools, x, positions, mode, view_fn):
    """Layer loop; returns (x, updates): per pattern position
    {"k_new","v_new"} stacked (n_super, B, C, kv_heads, head_dim)."""
    ups = [[] for _ in cfg.pattern]
    for i in range(cfg.n_superblocks()):
        for j, kind in enumerate(cfg.pattern):
            p, pool = _layer_slices(params, pools, j, i)
            x, up, _ = B.block_apply(cfg, kind, p, x, positions, mode,
                                     view_fn(pool))
            ups[j].append(up)
    updates = tuple({key: torch.stack([u[key] for u in uj])
                     for key in ("k_new", "v_new")} for uj in ups)
    return x, updates


def decode_logits(cfg: ModelConfig, params, pools, tables, lengths, wc,
                  tokens, seal: Optional[CacheSeal]):
    """One decode step for every slot at its own position.

    tokens (B, 1) (anything for inactive slots, masked by lengths). Returns
    (logits (B, V) f32, updates for ``append_tokens``)."""
    x = T._embed(cfg, params, tokens)
    positions = lengths[:, None]

    def view(pool):
        return _dense_view(cfg, seal, pool, tables, lengths, wc)

    x, updates = _run_layers(cfg, params, pools, x, positions, "decode",
                             view)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return T._unembed(cfg, params, x)[:, 0], updates


def chunk_logits(cfg: ModelConfig, params, pools, tables, lengths, wc,
                 tokens, chunk_len, seal: Optional[CacheSeal]):
    """One chunked-prefill pass: row i holds ``chunk_len[i]`` prompt tokens
    at positions [lengths[i], lengths[i] + chunk_len[i]). Returns (logits
    (B, V) at each row's last chunk token, updates)."""
    x = T._embed(cfg, params, tokens)
    c = tokens.shape[1]
    positions = lengths[:, None] + torch.arange(c, device=tokens.device)[None]

    def view(pool):
        v = _dense_view(cfg, seal, pool, tables, lengths, wc,
                        pos_len=lengths + chunk_len)
        v["cl"] = chunk_len
        return v

    x, updates = _run_layers(cfg, params, pools, x, positions, "chunk", view)
    x = L.apply_norm(cfg, params["final_norm"], x)
    idx = (chunk_len - 1).clamp(min=0)
    last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    return T._unembed(cfg, params, last)[:, 0], updates


def append_tokens(cfg: ModelConfig, seal: Optional[CacheSeal], pools,
                  updates, tables, lengths, counts, wc) -> None:
    """Splice each row's ``counts[i]`` new K/V tokens into its blocks at
    positions [lengths[i], lengths[i] + counts[i]), IN PLACE on ``pools``
    and ``wc``: the unified write path for the decode append (C == 1) and the
    chunked prefill (C == chunk).

    Touched blocks are gathered, unsealed under their current write counter,
    spliced, re-sealed under ``wc + 1`` and written back; ``wc`` of each
    touched block goes up by one. Untouched gathers (rows with counts == 0,
    span entries past a row's write) are written to the scratch block with
    the scratch block's own content — the reference drops them — so no
    block is written twice with different data and untouched blocks keep
    their words and counters."""
    wpt = MC.kv_words_per_token(cfg)
    b, mb = tables.shape
    dev = tables.device
    for j in range(len(cfg.pattern)):
        pj, uj = pools[j], updates[j]
        wpb = pj["k"].shape[-1]
        bs = wpb // wpt
        c = uj["k_new"].shape[2]
        nspan = 1 + (c + bs - 2) // bs         # blocks a write can span
        lid = pj["lid"]
        n = lid.shape[0]
        o = lengths % bs                                         # (B,)
        s_id = torch.arange(nspan, device=dev)[None, :]
        span = ((lengths // bs)[:, None] + s_id).clamp(max=mb - 1)
        pb = torch.gather(tables, 1, span)                       # (B, nspan)
        touched = ((s_id * bs < (o + counts)[:, None])
                   & ((s_id + 1) * bs > o[:, None])
                   & (counts > 0)[:, None])
        w2 = nspan * wpb
        widx = torch.arange(w2, device=dev)
        tok_of_w = widx // wpt
        sel = ((tok_of_w[None, :] >= o[:, None])
               & (tok_of_w[None, :] < (o + counts)[:, None]))    # (B, w2)
        roll = (widx[None, :] - (o * wpt)[:, None]) % w2         # (B, w2)
        tgt = torch.where(touched, pb, torch.full_like(pb, MC.SCRATCH_BLOCK))
        if seal is not None:
            wcb = u32.to_i64(wc[pb])
            wc0, wc1 = u32.from_i64(wcb), u32.from_i64(wcb + 1)

        def splice(pool_words, x_new, nonce):
            tw = MC.kv_to_words(x_new.reshape(n, b, c, -1))     # (n,B,C,wpt)
            base = torch.cat([tw.reshape(n, b, c * wpt),
                              tw.new_zeros((n, b, w2 - c * wpt))], dim=-1)
            rolled = torch.gather(base, -1, roll[None].expand(n, b, w2))
            blk = pool_words[:, pb]                              # (n,B,ns,wpb)
            flat = blk.reshape(n, b, w2)
            if seal is not None:
                lids = lid[:, None, None]
                flat = flat ^ KR.cache_block_otp(
                    seal.key_words, nonce, pb, wc0, lids, wpb).reshape(n, b, w2)
            out = torch.where(sel[None], rolled, flat)
            if seal is not None:
                out = out ^ KR.cache_block_otp(
                    seal.key_words, nonce, pb, wc1, lids, wpb).reshape(n, b, w2)
            out = out.reshape(n, b, nspan, wpb)
            scratch = pool_words[:, MC.SCRATCH_BLOCK][:, None, None, :]
            out = torch.where(touched[None, :, :, None], out, scratch)
            pool_words[:, tgt] = out

        splice(pj["k"], uj["k_new"], seal.nonce_k if seal is not None else None)
        splice(pj["v"], uj["v_new"], seal.nonce_v if seal is not None else None)
    # every pattern position touches the same blocks: bump their counters once
    wc.index_add_(0, pb.reshape(-1), touched.reshape(-1).to(torch.int32))
