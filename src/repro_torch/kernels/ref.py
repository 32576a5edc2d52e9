"""Plain PyTorch oracles and the tile / cache keystream layouts. Port of
``repro/kernels/ref.py``.

The keystreams here come from ``core.cipher.chacha20_block`` (the ChaCha
kernel on the card), except where a caller passes ``block_fn`` — the plain
versions of the kernels pass ``chacha20_blocks_plain`` so that they share no
code with the kernels they check.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import u32
from repro_torch.core import cipher as C
from repro_torch.kernels.chacha20 import chacha20_blocks_plain


def chacha20_keystream_ref(key_words, nonce_words, counters):
    """(16, N) keystream, word-major, from the plain rounds."""
    return chacha20_blocks_plain(key_words, counters, nonce_words).T


# --------------------------------------------------------------------------
# tile-sealed weight format + fused sealed matmul
# --------------------------------------------------------------------------

def tile_counters(k: int, n: int, bk: int, bn: int, write_counter: int = 0):
    """Counter id and lane for every word of a (k, n) leaf, numpy u32 — the
    derivation the fused kernel follows (see the reference docstring)."""
    nk, nn = k // bk, n // bn
    ii, jj = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    tile_id = (ii // bk) * nn + (jj // bn)
    within = (ii % bk) * bn + (jj % bn)
    word_id = tile_id.astype(np.int64) * (bk * bn) + within
    blocks_total = k * n // 16
    ctr = word_id // 16 + np.int64(write_counter) * blocks_total
    lane = word_id % 16
    return ctr.astype(np.uint32), lane.astype(np.uint32)


def tile_pad(key_words, nonce_words, k: int, n: int, bk: int, bn: int,
             write_counter=0, block_fn=None) -> torch.Tensor:
    """(k, n) int32 pad of a tile-sealed leaf.

    Word (i, j) takes lane w % 16 of block ``wc*uniq + w // 16`` with w its
    index in tile order, so the pad in tile order is the keystream itself;
    a reshape/permute puts it in row order (no gather)."""
    if k % bk or n % bn:
        raise ValueError(f"({k}, {n}) is not a multiple of tiles ({bk}, {bn})")
    block_fn = block_fn or C.chacha20_block
    dev = key_words.device
    uniq = k * n // 16
    wc = torch.as_tensor(write_counter, device=dev).reshape(())
    ctr = u32.from_i64(u32.to_i64(wc) * uniq
                       + torch.arange(uniq, dtype=torch.int64, device=dev))
    ks = block_fn(key_words, ctr, nonce_words)             # (uniq, 16)
    return (ks.reshape(k // bk, n // bn, bk, bn).permute(0, 2, 1, 3)
            .reshape(k, n))


def seal_weights_ref(w, key_words, nonce_words, bk: int, bn: int,
                     row_mask=None, write_counter=0, block_fn=None):
    """(K, N) f32 -> (K, N) int32 ciphertext; rows where ``row_mask`` is
    False stay plaintext (SE bypass)."""
    k, n = w.shape
    wu = w.to(torch.float32).contiguous().view(torch.int32)
    ct = wu ^ tile_pad(key_words, nonce_words, k, n, bk, bn, write_counter,
                       block_fn)
    if row_mask is not None:
        ct = torch.where(row_mask.reshape(k, 1).to(torch.bool), ct, wu)
    return ct


def unseal_weights_ref(wct, key_words, nonce_words, bk: int, bn: int,
                       row_mask=None, write_counter=0, block_fn=None):
    pt = seal_weights_ref(wct.contiguous().view(torch.float32), key_words,
                          nonce_words, bk, bn, row_mask, write_counter,
                          block_fn)
    return pt.view(torch.float32)


def sealed_matmul_ref(x, wct, key_words, nonce_words, bk: int, bn: int,
                      row_mask=None, write_counter=0):
    """Oracle: decrypt the whole weight (plain rounds), then an f32 matmul."""
    w = unseal_weights_ref(wct, key_words, nonce_words, bk, bn, row_mask,
                           write_counter, block_fn=chacha20_blocks_plain)
    return x.to(torch.float32) @ w


# --------------------------------------------------------------------------
# paged KV-cache blocks
# --------------------------------------------------------------------------

def cache_block_otp(key_words, nonce3, block_ids, write_counters, layer_ids,
                    words_per_block: int, block_fn=None) -> torch.Tensor:
    """Keystream for paged KV-cache blocks (see the reference docstring):
    counter = block * ceil(wpb/16) + c, nonce = (n0 ^ layer, n1 ^ wc, n2).

    ``block_ids`` / ``write_counters`` / ``layer_ids`` (int tensors, u32 bit
    patterns for the latter two) broadcast to a common shape S; returns
    (*S, words_per_block) int32. The serving path makes these pads inside
    its gather and splice (``kernels.chacha20.cache_view``/``cache_splice``);
    this composition is their plain version's."""
    dev = key_words.device
    bid, wc, lid = torch.broadcast_tensors(
        *(torch.as_tensor(t, device=dev) for t in
          (block_ids, write_counters, layer_ids)))
    shape = tuple(bid.shape)
    bid, wc, lid = (u32.to_i64(t.reshape(-1)) for t in (bid, wc, lid))
    cpb = -(-words_per_block // 16)
    sub = torch.arange(cpb, dtype=torch.int64, device=dev)
    ctr = u32.from_i64((bid[:, None] * cpb + sub[None, :]).reshape(-1))
    n0, n1, n2 = (int(v) & u32.MASK for v in nonce3)
    nonces = torch.stack([
        (lid ^ n0).repeat_interleave(cpb),
        (wc ^ n1).repeat_interleave(cpb),
        torch.full((ctr.shape[0],), n2, dtype=torch.int64, device=dev)],
        dim=1)
    ks = (block_fn or C.chacha20_block)(key_words, ctr, u32.from_i64(nonces))
    return ks.reshape(shape + (cpb * 16,))[..., :words_per_block]
