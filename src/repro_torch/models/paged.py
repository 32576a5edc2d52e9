"""Paged KV-cache passes: batched decode and chunked prefill over block
pools, and the copy-on-write of shared blocks. Port of ``_dense_view``,
``decode_logits``, ``chunk_logits``, ``append_tokens``, ``copy_blocks``,
``apply_paged_updates``, ``prefill_logits`` and ``prefill_write`` from
``repro/models/paged.py``, with their MAC branches. The last three are the
write paths of the step builders (``serve/step.py::make_paged_prefill`` and
``make_paged_decode_step``), whose host mirrors the counter bumps.

With a ``CacheSeal`` the pools hold ciphertext: a block is XORed with a
ChaCha20 keystream derived from (pool block address, per-block write
counter, layer id) (``kernels.ref.cache_block_otp``). The reference's order
is kept: gather -> unseal -> zero the entries past each slot's length ->
attend, and every write decrypts the touched blocks, splices the new tokens
in and re-seals them under ``wc + 1`` — so pools and counters match the
reference word for word after the same operations. On the card the pads are
made inside those passes: one ``ops.cache_view`` launch a layer reads, one
``ops.cache_splice`` launch a write, one ``ops.cache_copy`` launch a
copy-on-write. The reference's ``lax.scan`` over super-blocks is a Python
loop over layers; the pools and ``wc`` are updated in place.

When the seal carries a MAC context, every sealed write re-tags the blocks
it touched (``mac_k``/``mac_v``, under the bumped counter) and every read
checks the tags of the slot's resident blocks over the ciphertext, before
the unseal: a decode or chunk pass checks every layer at once, before its
first layer's view (one ``ops.cache_verify`` launch a pattern position,
which also makes the slots' verdicts); a write takes one ``ops.cache_tags``
launch, a copy-on-write two (the sources' check, the copies' tags). The
pools do not change within a pass (its splice comes after it, fault hooks
between dispatches), so the one check's verdict is the AND of the
reference's per-layer verdicts.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import u32
from repro_torch.config import ModelConfig
from repro_torch.core.sealed_store import CacheSeal
from repro_torch.kernels import chacha20 as _cc
from repro_torch.kernels import ops
from repro_torch.models import blocks as B
from repro_torch.models import cache as MC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.cache import SCRATCH_BLOCK


def _dense_view(cfg: ModelConfig, seal: Optional[CacheSeal], pool_j,
                tables, lengths, wc, pos_len=None):
    """One layer's blocks gathered into the dense {"k","v","pos"} view.

    pool_j: {"k","v": (NB, wpb) int32, "mac_k","mac_v": (NB,), "lid": ()};
    tables (B, MB) block ids; lengths (B,); wc (NB,) int32 words. k/v come
    back (B, L, kv_heads, head_dim) with L = MB * block_size, zero at and
    past each slot's length; pos is INVALID_POS past ``lengths`` (or past
    ``pos_len`` for the chunk path, whose fresh keys are spliced into the
    zeroed tail). It checks no MAC: the passes check every layer before
    their first view (``_verify_pass``); the reference's one-layer verdict
    is ``_verify`` over a one-layer pool."""
    b, mb = tables.shape
    wpb = pool_j["k"].shape[-1]
    wpt = MC.kv_words_per_token(cfg)
    seq = mb * wpb // wpt
    # (2, B, MB*wpb) words, zero past each slot's length; sealed: one
    # launch that unseals as it gathers
    view = ops.cache_view if seal is not None else _cc.cache_view_plain
    kv = view(*_seal_args(seal), pool_j["k"], pool_j["v"], pool_j["lid"],
              tables, lengths, wc, wpt)
    dt = L.cdtype(cfg)
    shape = (b, seq, cfg.num_kv_heads, cfg.head_dim)
    k = MC.words_to_kv(kv[0], dt).reshape(shape)
    v = MC.words_to_kv(kv[1], dt).reshape(shape)
    pos = torch.arange(seq, device=tables.device)[None, :]
    valid = pos < lengths[:, None]                 # (B, L)
    vpos = valid if pos_len is None else pos < pos_len[:, None]
    pos = torch.where(vpos, pos, torch.full_like(pos, MC.INVALID_POS))
    return {"k": k, "v": v, "pos": pos}


def _verify(seal: CacheSeal, pool, tables, lengths, wc, bs: int):
    """(B,) bool: every resident block of each slot (table entries below
    ceil(length / bs)), in every layer of the stacked ``pool`` ({"k","v":
    (n, NB, wpb), "mac_k","mac_v": (n, NB), "lid": (n,)}), k and v, has its
    stored tags (one ``ops.cache_verify`` launch)."""
    mac = seal.mac
    return ops.cache_verify(mac.key_words, mac.hash_keys(pool["k"].shape[-1]),
                            *seal.mac_nonces(), pool["k"], pool["v"],
                            pool["mac_k"], pool["mac_v"], pool["lid"], tables,
                            lengths, wc, bs)


def _verify_pass(cfg: ModelConfig, seal: Optional[CacheSeal], pools, tables,
                 lengths, wc) -> torch.Tensor:
    """(B,) bool verdict of a pass's cache reads, every layer checked once,
    before the first view: one ``_verify`` a pattern position; all True
    when the seal carries no MAC context."""
    ok = torch.ones((tables.shape[0],), dtype=torch.bool,
                    device=tables.device)
    if seal is None or seal.mac is None:
        return ok
    bs = pools[0]["k"].shape[-1] // MC.kv_words_per_token(cfg)
    for pj in pools:
        ok &= _verify(seal, pj, tables, lengths, wc, bs)
    return ok


def _tags(seal: CacheSeal, pool_k, pool_v, lids, blocks, live, wc):
    """(n, 2, E) MAC tags of ``blocks`` under ``wc`` as it stands (one
    ``ops.cache_tags`` launch); 0 where not ``live``."""
    mac = seal.mac
    return ops.cache_tags(mac.key_words, mac.hash_keys(pool_k.shape[-1]),
                          *seal.mac_nonces(), pool_k, pool_v, lids, blocks,
                          live, wc)


def _store_tags(pool, blocks, live, tags) -> None:
    """Write ``tags`` (n, 2, E) into the pool's MAC words of the live
    ``blocks``; dead entries rewrite the scratch block's own words."""
    tgt = torch.where(live, blocks, torch.full_like(blocks, SCRATCH_BLOCK))
    for s, key in enumerate(("mac_k", "mac_v")):
        words = pool[key]
        words[:, tgt] = torch.where(live, tags[:, s],
                                    words[:, SCRATCH_BLOCK, None])


def _seal_args(seal: Optional[CacheSeal]):
    """(key words, k nonce, v nonce) of the cache seal; all None for
    plaintext pools."""
    if seal is None:
        return None, None, None
    return seal.key_words, seal.nonce_k, seal.nonce_v


def _layer_slices(params, pools, j: int, i: int):
    p = T.layer_params(params, j, i)
    pool = {key: pools[j][key][i]
            for key in ("k", "v", "mac_k", "mac_v", "lid")}
    return p, pool


def _run_layers(cfg, params, pools, x, positions, mode, view_fn):
    """Layer loop; returns (x, updates): updates per pattern position
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
    (logits (B, V) f32, updates for ``append_tokens``, ok (B,) bool: the
    AND of every layer's cache-read verdict, all True unless the seal
    carries a MAC context)."""
    ok = _verify_pass(cfg, seal, pools, tables, lengths, wc)
    x = T._embed(cfg, params, tokens)
    positions = lengths[:, None]

    def view(pool):
        return _dense_view(cfg, seal, pool, tables, lengths, wc)

    x, updates = _run_layers(cfg, params, pools, x, positions, "decode", view)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return T._unembed(cfg, params, x)[:, 0], updates, ok


def chunk_logits(cfg: ModelConfig, params, pools, tables, lengths, wc,
                 tokens, chunk_len, seal: Optional[CacheSeal]):
    """One chunked-prefill pass: row i holds ``chunk_len[i]`` prompt tokens
    at positions [lengths[i], lengths[i] + chunk_len[i]). Returns (logits
    (B, V) at each row's last chunk token, updates, ok (B,) as in
    ``decode_logits``)."""
    ok = _verify_pass(cfg, seal, pools, tables, lengths, wc)
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
    return T._unembed(cfg, params, last)[:, 0], updates, ok


def append_tokens(cfg: ModelConfig, seal: Optional[CacheSeal], pools,
                  updates, tables, lengths, counts, wc) -> None:
    """Splice each row's ``counts[i]`` new K/V tokens into its blocks at
    positions [lengths[i], lengths[i] + counts[i]), IN PLACE on ``pools``
    and ``wc``: the unified write path for the decode append (C == 1) and the
    chunked prefill (C == chunk).

    Touched blocks are unsealed under their current write counter, spliced
    and re-sealed under ``wc + 1`` (sealed: one ``ops.cache_splice`` launch
    for every layer of a pattern position, k and v); ``wc`` of each touched
    block goes up by one, once, after every position has read it. Untouched
    blocks keep their words and counters (see
    ``kernels.chacha20.cache_splice_plain`` for the scratch-block writes of
    the plain composition, which the reference drops). With a MAC context
    the touched blocks are then re-tagged under ``wc + 1``, as the
    reference's are (a block two rows touch, the scratch block, is bumped
    twice but tagged once)."""
    wpt = MC.kv_words_per_token(cfg)
    b = tables.shape[0]
    splice = ops.cache_splice if seal is not None else _cc.cache_splice_plain
    for j in range(len(cfg.pattern)):
        pj, uj = pools[j], updates[j]
        n = pj["lid"].shape[0]
        c = uj["k_new"].shape[2]
        words = [MC.kv_to_words(uj[key].reshape(n, b, c, -1))
                 for key in ("k_new", "v_new")]            # (n, B, C, wpt)
        splice(*_seal_args(seal), pj["k"], pj["v"], pj["lid"], *words,
               tables, lengths, counts, wc, pj["k"].shape[-1] // wpt)
    # every pattern position touches the same blocks: bump their counters once
    bs = pools[0]["k"].shape[-1] // wpt
    c = updates[0]["k_new"].shape[2]
    pb, touched = _cc.splice_blocks(tables, lengths, counts, bs,
                                    1 + (c + bs - 2) // bs)
    pb, touched = pb.reshape(-1), touched.reshape(-1)
    if seal is not None and seal.mac is not None:
        wc1 = u32.from_i64(u32.to_i64(wc) + 1)
        for pj in pools:
            _store_tags(pj, pb, touched,
                        _tags(seal, pj["k"], pj["v"], pj["lid"], pb, touched,
                              wc1))
    wc.index_add_(0, pb, touched.to(torch.int32))


def copy_blocks(cfg: ModelConfig, seal: Optional[CacheSeal], pools, wc, src,
                dst, mask) -> torch.Tensor:
    """Copy-on-write: duplicate blocks ``src -> dst`` ((K,) int64, ``mask``
    (K,) bool gating padded pairs) IN PLACE on ``pools`` and ``wc``.

    Sealed pools re-key in flight: the words are unsealed under (src,
    wc[src]) and re-sealed under (dst, wc[dst] + 1), so no plaintext lands in
    the pool (one ``ops.cache_copy`` launch a pattern position); plaintext
    pools copy words (plain PyTorch indexing, no ChaCha). The destination
    counters are bumped. Returns ok, a () bool: with a MAC context every
    masked source block is checked against its stored tags *before* the
    re-key (a copy must not launder a tampered block into a freshly tagged
    one), and each copy is tagged under its (address, bumped counter)."""
    mac = seal is not None and seal.mac is not None
    copy = ops.cache_copy if seal is not None else _cc.cache_copy_plain
    ok = torch.ones((), dtype=torch.bool, device=wc.device)
    for pj in pools:
        if mac:
            ts = _tags(seal, pj["k"], pj["v"], pj["lid"], src, mask, wc)
            good = ((ts[:, 0] == pj["mac_k"][:, src])
                    & (ts[:, 1] == pj["mac_v"][:, src]))
            ok &= (good | ~mask).all()
        copy(*_seal_args(seal), pj["k"], pj["v"], pj["lid"], src, dst, mask,
             wc)
    wc.index_add_(0, dst, mask.to(torch.int32))
    if mac:
        for pj in pools:
            _store_tags(pj, dst, mask,
                        _tags(seal, pj["k"], pj["v"], pj["lid"], dst, mask,
                              wc))
    return ok


def apply_paged_updates(cfg: ModelConfig, seal: Optional[CacheSeal], pools,
                        updates, tables, lengths, wc):
    """Append each row's one new K/V token into its tail block, IN PLACE on
    ``pools``; returns them. ``append_tokens`` of one token a row on a copy
    of ``wc``: the tail block is re-sealed (and re-tagged) under ``wc + 1``
    while ``wc`` itself is not bumped, since the caller mirrors the bump
    after the step, as the reference's host does. Every row writes, as the
    reference's do: an inactive slot (length 0, zeroed table row) writes
    into the scratch block."""
    ones = torch.ones((tables.shape[0],), dtype=torch.int64,
                      device=tables.device)
    append_tokens(cfg, seal, pools, updates, tables, lengths, ones,
                  wc.clone())
    return pools


def prefill_logits(cfg: ModelConfig, params, tokens, true_len):
    """Ragged prefill of a right-padded (A, S_bucket) admission batch.

    Returns (logits (A, V) at each row's last real token, the contiguous
    cache of ``transformer.prefill_hidden`` for ``prefill_write``). Padding
    sits at the tail, so causality keeps every real token's hidden state
    independent of it; its cache entries are masked downstream by the slot
    lengths."""
    x, cache = T.prefill_hidden(cfg, params, tokens, tokens.shape[1])
    idx = true_len.to(torch.int64) - 1
    last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    return T._unembed(cfg, params, last)[:, 0], cache


def prefill_write(cfg: ModelConfig, seal: Optional[CacheSeal], pools, cache,
                  block_tables, wc):
    """Seal a prefill's contiguous cache into pool blocks, IN PLACE on
    ``pools``; returns them.

    cache: per pattern position {"k", "v": (n, A, S_bucket, h, d)};
    block_tables (A, S_bucket // bs) pool ids. The caller bumps the write
    counters of these blocks *before* the call, so every block is sealed
    (and, with a MAC context, tagged) under ``wc`` as passed. The write is
    ``append_tokens`` of all S_bucket tokens from offset 0 on a copy of the
    counters one behind, since the splice seals under its ``wc + 1``: every
    word of every block is written, so the unseal of the old words under
    ``wc - 1`` leaves nothing behind. Dummy admission rows carry a zeroed
    table row and land on the scratch block."""
    wpt = MC.kv_words_per_token(cfg)
    a, nblk = block_tables.shape
    sb = cache[0]["k"].shape[2]
    for pj in pools:
        if sb * wpt != nblk * pj["k"].shape[-1]:
            raise ValueError(f"{sb} tokens of {wpt} words do not fill "
                             f"{nblk} blocks of {pj['k'].shape[-1]}")
    zeros = torch.zeros((a,), dtype=torch.int64, device=block_tables.device)
    append_tokens(cfg, seal, pools,
                  tuple({"k_new": cj["k"], "v_new": cj["v"]} for cj in cache),
                  block_tables.to(torch.int64), zeros,
                  torch.full_like(zeros, sb),
                  u32.from_i64(u32.to_i64(wc) - 1))
    return pools
