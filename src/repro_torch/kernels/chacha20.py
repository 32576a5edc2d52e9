"""ChaCha20: the Hopper kernels and their plain PyTorch versions.

Port of ``repro/kernels/chacha20.py::chacha20_keystream`` (the Pallas kernel
``_keystream_kernel`` with ``_chacha_rounds``/``_qr``), as three CUDA
sources that share the rounds of ``csrc/chacha20.cuh`` with the fused
sealed matmul:

* ``csrc/chacha20.cu`` (``chacha20_blocks``): keystream blocks to device
  memory, one thread per block, the nonce shared or per block ((n, 3)).
  Sealing, ``ops.keystream`` and the tests use it. What bounds it: 640 of a
  block's 976 integer operations (its XORs and rotations) issue only on the
  ALU pipe, 16.7e12 a second on the H100, against 80 bytes moved with a
  per-block nonce: the arithmetic.
* ``csrc/chacha20_cache.cu`` (``cache_view``, ``cache_splice``,
  ``cache_copy``, ``cache_tags``, ``cache_verify``): the paged KV cache's
  pads (``ref.cache_block_otp``) made in registers inside the pass that
  consumes them: the gather of one layer's dense view (zeroed past each
  slot's length), the in-place splice of a write over every layer, the
  copy-on-write re-key of shared blocks, the blocks' Carter–Wegman tags
  (``core.mac``: a hash of the ciphertext XOR one pad word), and a read's
  check of those tags over every layer with the slots' verdicts made in the
  kernel.
* ``csrc/chacha20_lines.cu`` (``lines_unseal``, ``lines_gather_rows``): the
  line layout's pads (``core.engine._line_otp``) made inside the unseal of a
  whole leaf, or inside the gather of the embedding rows a dispatch needs.
* ``csrc/chacha20_weights.cu`` (``tile_tags``, ``line_tags``): the sealed
  weight image's Carter–Wegman tags (``core.mac.tile_tags`` and
  ``line_tags``), hash and pad in one pass over a leaf, at sealing and in
  ``sealed_store.verify_params``.

The last two replace the composition around ``chacha20_blocks`` that the
serving path ran before them: the
keystream written to device memory, XORed, selected and gathered by
separate PyTorch passes after int64 counters and nonces were built for it.
They move each word once and make each pad once, so their bound is the
larger of the bytes and the pads' ALU work; the headers of the sources give
the designs.

Every route takes the plain version for a CPU tensor and launches its
kernel, or raises, for a CUDA tensor. The plain versions are the PyTorch
compositions the kernels replace, with ``chacha20_blocks_plain`` for the
blocks, so they share no code with the kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import u32
from repro_torch.kernels import _build
from repro_torch.models.cache import SCRATCH_BLOCK

_CONST = np.frombuffer(b"expand 32-byte k", np.uint32).astype(np.int64)


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (32 - n))) & u32.MASK


def _qr(a, b, c, d):
    """Four quarter-rounds at once: rows of (4, n) int64 tensors."""
    a = (a + b) & u32.MASK
    d = _rotl(d ^ a, 16)
    c = (c + d) & u32.MASK
    b = _rotl(b ^ c, 12)
    a = (a + b) & u32.MASK
    d = _rotl(d ^ a, 8)
    c = (c + d) & u32.MASK
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def chacha20_blocks_plain(key_words: torch.Tensor, counters: torch.Tensor,
                          nonce_words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ChaCha20, in int64 masked to 32 bits.

    key_words (8,), counters (n,), nonce_words (3,) or (n, 3): int32 bit
    patterns. Returns (n, 16) int32. The state is kept as four (4, n) rows
    (words 0-3, 4-7, 8-11, 12-15): a column round is one quarter-round on
    them, a diagonal round the same after rotating rows 1-3 (the usual SIMD
    arrangement)."""
    n = counters.shape[0]
    dev = counters.device
    key = u32.to_i64(key_words)
    nz = u32.to_i64(nonce_words)
    nz = nz.expand(n, 3) if nz.ndim == 1 else nz
    init = torch.cat([
        torch.as_tensor(_CONST, device=dev)[:, None].expand(4, n),
        key[:, None].expand(8, n),
        u32.to_i64(counters)[None, :],
        nz.T], dim=0)                                      # (16, n)
    a, b, c, d = init[0:4], init[4:8], init[8:12], init[12:16]
    for _ in range(10):
        a, b, c, d = _qr(a, b, c, d)
        a, b, c, d = _qr(a, b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0))
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
    out = torch.cat([a, b, c, d], dim=0) + init
    return u32.from_i64(out.T)


def _check_words(name, t, shape=None):
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 u32 words, got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def chacha20_blocks_cuda(key_words, counters, nonce_words) -> torch.Tensor:
    """Launch ``csrc/chacha20.cu`` on PyTorch's current stream."""
    n = counters.shape[0]
    dev = counters.device
    _check_words("key_words", key_words, (8,))
    _check_words("counters", counters, (n,))
    _check_words("nonce_words", nonce_words)
    per_block = nonce_words.ndim == 2
    if nonce_words.shape != ((n, 3) if per_block else (3,)):
        raise ValueError(f"nonce_words: expected (3,) or ({n}, 3), "
                         f"got {tuple(nonce_words.shape)}")
    if n >= 2**31:
        raise ValueError(f"{n} blocks exceed one launch")
    for t in (key_words, counters, nonce_words):
        if t.device != dev:
            raise ValueError("chacha20 operands must share one device")
    key_words, counters, nonce_words = (t.contiguous() for t in
                                        (key_words, counters, nonce_words))
    out = torch.empty((n, 16), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    fn = _build.load("chacha20").chacha20_blocks
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(key_words.data_ptr(), counters.data_ptr(),
                nonce_words.data_ptr(), int(per_block), out.data_ptr(), n,
                stream)
    _build.check(rc, "chacha20_blocks")
    chacha20_blocks.launches += 1
    return out


def chacha20_blocks(key_words, counters, nonce_words) -> torch.Tensor:
    """(n, 16) int32 keystream blocks. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises."""
    if counters.is_cuda:
        return chacha20_blocks_cuda(key_words, counters, nonce_words)
    return chacha20_blocks_plain(key_words, counters, nonce_words)


chacha20_blocks.launches = 0


def chacha20_keystream(key_words, nonce_words, counters) -> torch.Tensor:
    """(16, N) keystream, word-major, for the (N,) ``counters``: the
    reference's ``chacha20_keystream`` (argument order and layout), over
    ``chacha20_blocks``, which writes (N, 16); the transpose is a view. Any
    N: the reference's multiple of its tile is a Pallas grid's."""
    return chacha20_blocks(key_words, counters, nonce_words).T


# --------------------------------------------------------------------------
# shared by the fused routes
# --------------------------------------------------------------------------

def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _nonce_words(nonce3):
    """Host ints of a nonce given as a tuple of u32 values."""
    return [int(v) & u32.MASK for v in nonce3]


def _same_device(dev, *ts):
    for t in ts:
        if t is not None and t.device != dev:
            raise ValueError("ChaCha operands must share one device")


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


# --------------------------------------------------------------------------
# the paged KV cache: the dense view of one layer and the write splice
# --------------------------------------------------------------------------

def cache_view_plain(key_words, nonce_k, nonce_v, pool_k, pool_v, lid,
                     tables, lengths, wc, wpt: int) -> torch.Tensor:
    """One layer's blocks gathered through ``tables`` (B, MB) into dense
    words (2, B, MB*wpb) for k and v: unsealed with ``ref.cache_block_otp``
    under ``wc[table entry]`` and layer ``lid`` (no pads when ``key_words``
    is None: plaintext pools), and zero at every word of a token position
    at or past ``lengths[b]`` (wpt words a token)."""
    from repro_torch.kernels import ref    # deferred: ref imports this module
    b, mb = tables.shape
    wpb = pool_k.shape[-1]
    pos = torch.arange(mb * wpb, device=tables.device) // wpt
    live = pos[None, :] < lengths[:, None]                   # (B, MB*wpb)
    zero = torch.zeros((), dtype=torch.int32, device=pool_k.device)
    out = []
    for pool, nonce in ((pool_k, nonce_k), (pool_v, nonce_v)):
        w = pool[tables]
        if key_words is not None:
            w = w ^ ref.cache_block_otp(key_words, nonce, tables, wc[tables],
                                        lid, wpb,
                                        block_fn=chacha20_blocks_plain)
        out.append(torch.where(live, w.reshape(b, mb * wpb), zero))
    return torch.stack(out)


def cache_view_cuda(key_words, nonce_k, nonce_v, pool_k, pool_v, lid,
                    tables, lengths, wc, wpt: int) -> torch.Tensor:
    """Launch ``cache_view`` of ``csrc/chacha20_cache.cu``: one launch for
    k and v. The pools may be row-strided views of the stacked pool (no
    copy); tables and lengths int64; lid a one-word int32 tensor on the
    card (read by the kernel: no host sync)."""
    dev = pool_k.device
    _check_words("key_words", key_words, (8,))
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        _check_words(name, t)
        if t.ndim != 2 or t.stride(-1) != 1:
            raise ValueError(f"{name}: expected (NB, wpb) rows of unit "
                             f"stride, got {tuple(t.shape)} {t.stride()}")
    if pool_v.shape != pool_k.shape:
        raise ValueError("pool_k and pool_v differ in shape")
    nb, wpb = pool_k.shape
    b, mb = tables.shape
    _check_words("wc", wc, (nb,))
    _check_words("lid", lid)
    if lid.numel() != 1:
        raise ValueError("lid: expected one word")
    for name, t in (("tables", tables), ("lengths", lengths)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name}: expected int64, got {t.dtype}")
    if tuple(lengths.shape) != (b,) or wpb % wpt:
        raise ValueError(f"lengths {tuple(lengths.shape)} for {b} slots, or "
                         f"{wpb} words a block not whole tokens of {wpt}")
    if 2 * b * mb * -(-wpb // 16) >= 2**31:
        raise ValueError("too many units for one launch")
    _same_device(dev, key_words, pool_v, lid, tables, lengths, wc)
    key_words, tables, lengths, wc, lid = (
        t.contiguous() for t in (key_words, tables, lengths, wc, lid))
    out = torch.empty((2, b, mb * wpb), dtype=torch.int32, device=dev)
    vec = (wpb % 16 == 0 and pool_k.stride(0) % 4 == 0
           and pool_v.stride(0) % 4 == 0 and _aligned(pool_k, pool_v, out))
    fn = _build.load("chacha20_cache").cache_view
    with torch.cuda.device(dev):
        rc = fn(key_words.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                pool_k.stride(0), pool_v.stride(0), lid.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), wc.data_ptr(),
                out.data_ptr(), b, mb, wpb, wpt, *_nonce_words(nonce_k),
                *_nonce_words(nonce_v), int(vec), _stream(dev))
    _build.check(rc, "cache_view")
    cache_view_cuda.launches += 1
    return out


def cache_view(key_words, nonce_k, nonce_v, pool_k, pool_v, lid, tables,
               lengths, wc, wpt: int) -> torch.Tensor:
    """(2, B, MB*wpb) int32: one layer's k and v blocks unsealed into the
    dense view, zero past each slot's length (see ``cache_view_plain``)."""
    fn = cache_view_cuda if pool_k.is_cuda else cache_view_plain
    return fn(key_words, nonce_k, nonce_v, pool_k, pool_v, lid, tables,
              lengths, wc, wpt)


def splice_blocks(tables, lengths, counts, bs: int, nspan: int):
    """(pb, touched), both (B, nspan): the pool block of each span of the
    write window that starts at block ``lengths // bs``, and whether the
    write of ``counts`` tokens at offset ``lengths % bs`` reaches it."""
    dev = tables.device
    o = lengths % bs
    s_id = torch.arange(nspan, device=dev)[None, :]
    span = ((lengths // bs)[:, None] + s_id).clamp(max=tables.shape[1] - 1)
    pb = torch.gather(tables, 1, span)
    touched = ((s_id * bs < (o + counts)[:, None])
               & ((s_id + 1) * bs > o[:, None]) & (counts > 0)[:, None])
    return pb, touched


def cache_splice_plain(key_words, nonce_k, nonce_v, pool_k, pool_v, lids,
                       new_k, new_v, tables, lengths, counts, wc,
                       bs: int) -> None:
    """Splice each row's ``counts[b]`` new tokens (``new_*`` (n, B, C, wpt)
    words, every layer of the stack) into its blocks at positions
    [lengths[b], lengths[b] + counts[b]), IN PLACE on ``pool_*`` (n, NB,
    wpb): each touched block is gathered, unsealed under ``wc``, spliced and
    re-sealed under ``wc + 1`` (no pads when ``key_words`` is None:
    plaintext pools). Untouched gathers are written to the scratch block
    with its own content. ``wc`` is read only: the caller bumps it."""
    from repro_torch.kernels import ref    # deferred: ref imports this module
    n, b, c, wpt = new_k.shape
    wpb = pool_k.shape[-1]
    dev = tables.device
    nspan = 1 + (c + bs - 2) // bs          # blocks a write can span
    pb, touched = splice_blocks(tables, lengths, counts, bs, nspan)
    o = lengths % bs
    w2 = nspan * wpb
    widx = torch.arange(w2, device=dev)
    tok_of_w = widx // wpt
    sel = ((tok_of_w[None, :] >= o[:, None])
           & (tok_of_w[None, :] < (o + counts)[:, None]))    # (B, w2)
    roll = (widx[None, :] - (o * wpt)[:, None]) % w2         # (B, w2)
    tgt = torch.where(touched, pb, torch.full_like(pb, SCRATCH_BLOCK))
    if key_words is not None:
        wcb = u32.to_i64(wc[pb])
        wc0, wc1 = u32.from_i64(wcb), u32.from_i64(wcb + 1)
        lid3 = lids[:, None, None]
    for pool_words, tw, nonce in ((pool_k, new_k, nonce_k),
                                  (pool_v, new_v, nonce_v)):
        base = torch.cat([tw.reshape(n, b, c * wpt),
                          tw.new_zeros((n, b, w2 - c * wpt))], dim=-1)
        rolled = torch.gather(base, -1, roll[None].expand(n, b, w2))
        flat = pool_words[:, pb].reshape(n, b, w2)
        if key_words is not None:
            flat = flat ^ ref.cache_block_otp(
                key_words, nonce, pb, wc0, lid3, wpb,
                block_fn=chacha20_blocks_plain).reshape(n, b, w2)
        out = torch.where(sel[None], rolled, flat)
        if key_words is not None:
            out = out ^ ref.cache_block_otp(
                key_words, nonce, pb, wc1, lid3, wpb,
                block_fn=chacha20_blocks_plain).reshape(n, b, w2)
        out = out.reshape(n, b, nspan, wpb)
        scratch = pool_words[:, SCRATCH_BLOCK][:, None, None, :]
        pool_words[:, tgt] = torch.where(touched[None, :, :, None], out,
                                         scratch)


def _check_stacked_pools(pool_k, pool_v):
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        _check_words(name, t)
        if t.ndim != 3 or t.stride(-1) != 1:
            raise ValueError(f"{name}: expected (n, NB, wpb) rows of unit "
                             f"stride, got {tuple(t.shape)} {t.stride()}")
    if pool_v.shape != pool_k.shape:
        raise ValueError("pool_k and pool_v differ in shape")


def _vec_pools(pool_k, pool_v) -> bool:
    """16-byte loads and stores hold for every row of both pools."""
    return (pool_k.shape[-1] % 16 == 0
            and all(s % 4 == 0 for s in pool_k.stride()[:2]
                    + pool_v.stride()[:2])
            and _aligned(pool_k, pool_v))


def cache_splice_cuda(key_words, nonce_k, nonce_v, pool_k, pool_v, lids,
                      new_k, new_v, tables, lengths, counts, wc,
                      bs: int) -> None:
    """Launch ``cache_splice`` of ``csrc/chacha20_cache.cu``: one launch for
    every layer, k and v, in place on the pools. Untouched blocks, the
    scratch block included, are not written. Two touched (row, span) pairs
    never name one block (each row writes its own slot's blocks), which the
    kernel's in-place update relies on."""
    dev = pool_k.device
    _check_words("key_words", key_words, (8,))
    _check_stacked_pools(pool_k, pool_v)
    n, nb, wpb = pool_k.shape
    b, mb = tables.shape
    for name, t in (("new_k", new_k), ("new_v", new_v)):
        _check_words(name, t)
        if t.ndim != 4 or tuple(t.shape[:2]) != (n, b):
            raise ValueError(f"{name}: expected ({n}, {b}, C, wpt), got "
                             f"{tuple(t.shape)}")
    if new_v.shape != new_k.shape:
        raise ValueError("new_k and new_v differ in shape")
    c, wpt = new_k.shape[2:]
    _check_words("wc", wc, (nb,))
    _check_words("lids", lids, (n,))
    for name, t in (("tables", tables), ("lengths", lengths),
                    ("counts", counts)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name}: expected int64, got {t.dtype}")
    if tuple(lengths.shape) != (b,) or tuple(counts.shape) != (b,):
        raise ValueError(f"lengths/counts: expected ({b},)")
    if wpb != bs * wpt:
        raise ValueError(f"{wpb} words a block is not {bs} tokens of {wpt}")
    nspan = 1 + (c + bs - 2) // bs
    if 2 * n * b * nspan * -(-wpb // 16) >= 2**31:
        raise ValueError("too many units for one launch")
    _same_device(dev, key_words, pool_v, lids, new_k, new_v, tables, lengths,
                 counts, wc)
    key_words, lids, new_k, new_v, tables, lengths, counts, wc = (
        t.contiguous() for t in (key_words, lids, new_k, new_v, tables,
                                 lengths, counts, wc))
    vec = _vec_pools(pool_k, pool_v)
    fn = _build.load("chacha20_cache").cache_splice
    with torch.cuda.device(dev):
        rc = fn(key_words.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                pool_k.stride(0), pool_k.stride(1), pool_v.stride(0),
                pool_v.stride(1), lids.data_ptr(), new_k.data_ptr(),
                new_v.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
                counts.data_ptr(), wc.data_ptr(), n, b, mb, wpb, wpt, bs, c,
                nspan, *_nonce_words(nonce_k), *_nonce_words(nonce_v),
                int(vec), _stream(dev))
    _build.check(rc, "cache_splice")
    cache_splice_cuda.launches += 1


def cache_splice(key_words, nonce_k, nonce_v, pool_k, pool_v, lids, new_k,
                 new_v, tables, lengths, counts, wc, bs: int) -> None:
    """The sealed write of a dispatch over every layer of a stack, in place
    on the pools (see ``cache_splice_plain``)."""
    fn = cache_splice_cuda if pool_k.is_cuda else cache_splice_plain
    fn(key_words, nonce_k, nonce_v, pool_k, pool_v, lids, new_k, new_v,
       tables, lengths, counts, wc, bs)


def cache_copy_plain(key_words, nonce_k, nonce_v, pool_k, pool_v, lids,
                     src, dst, mask, wc) -> None:
    """Copy-on-write of blocks ``src -> dst`` ((K,) int64 each, ``mask``
    (K,) bool gating the pairs) over every layer of ``pool_*`` (n, NB, wpb),
    IN PLACE: each unit is unsealed under (src, wc[src]) and re-sealed under
    (dst, wc[dst] + 1) (a plain copy when ``key_words`` is None: plaintext
    pools). Masked-off pairs write the scratch block with its own content.
    The source and destination blocks of the masked pairs must be disjoint
    (destinations are freshly allocated). ``wc`` is read only: the caller
    bumps it."""
    from repro_torch.kernels import ref    # deferred: ref imports this module
    live_src = set(src[mask].tolist())
    if live_src & set(dst[mask].tolist()):
        raise ValueError("copy-on-write sources and destinations overlap")
    wpb = pool_k.shape[-1]
    tgt = torch.where(mask, dst, torch.full_like(dst, SCRATCH_BLOCK))
    if key_words is not None:
        wc0 = wc[src]
        wc1 = u32.from_i64(u32.to_i64(wc[dst]) + 1)
        lid2 = lids[:, None]
    for pool, nonce in ((pool_k, nonce_k), (pool_v, nonce_v)):
        blk = pool[:, src]                                  # (n, K, wpb)
        if key_words is not None:
            blk = blk ^ ref.cache_block_otp(
                key_words, nonce, src, wc0, lid2, wpb,
                block_fn=chacha20_blocks_plain)
            blk = blk ^ ref.cache_block_otp(
                key_words, nonce, dst, wc1, lid2, wpb,
                block_fn=chacha20_blocks_plain)
        scratch = pool[:, SCRATCH_BLOCK][:, None, :]
        pool[:, tgt] = torch.where(mask[None, :, None], blk, scratch)


def cache_copy_cuda(key_words, nonce_k, nonce_v, pool_k, pool_v, lids, src,
                    dst, mask, wc) -> None:
    """Launch ``cache_copy`` of ``csrc/chacha20_cache.cu``: one launch for
    every layer of the stack, k and v, in place on the pools; masked-off
    pairs write nothing."""
    dev = pool_k.device
    _check_words("key_words", key_words, (8,))
    _check_stacked_pools(pool_k, pool_v)
    n, nb, wpb = pool_k.shape
    k = src.shape[0]
    _check_words("wc", wc, (nb,))
    _check_words("lids", lids, (n,))
    for name, t in (("src", src), ("dst", dst)):
        if t.dtype != torch.int64 or tuple(t.shape) != (k,):
            raise TypeError(f"{name}: expected ({k},) int64")
    if mask.dtype != torch.bool or tuple(mask.shape) != (k,):
        raise TypeError(f"mask: expected ({k},) bool")
    if 2 * n * k * -(-wpb // 16) >= 2**31:
        raise ValueError("too many units for one launch")
    _same_device(dev, key_words, pool_v, lids, src, dst, mask, wc)
    key_words, lids, src, dst, mask, wc = (
        t.contiguous() for t in (key_words, lids, src, dst, mask, wc))
    fn = _build.load("chacha20_cache").cache_copy
    with torch.cuda.device(dev):
        rc = fn(key_words.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                pool_k.stride(0), pool_k.stride(1), pool_v.stride(0),
                pool_v.stride(1), lids.data_ptr(), src.data_ptr(),
                dst.data_ptr(), mask.data_ptr(), wc.data_ptr(), n, k, wpb,
                *_nonce_words(nonce_k), *_nonce_words(nonce_v),
                int(_vec_pools(pool_k, pool_v)), _stream(dev))
    _build.check(rc, "cache_copy")
    cache_copy_cuda.launches += 1


def cache_copy(key_words, nonce_k, nonce_v, pool_k, pool_v, lids, src, dst,
               mask, wc) -> None:
    """The sealed copy-on-write re-key over every layer of a stack, in place
    on the pools (see ``cache_copy_plain``)."""
    fn = cache_copy_cuda if pool_k.is_cuda else cache_copy_plain
    fn(key_words, nonce_k, nonce_v, pool_k, pool_v, lids, src, dst, mask, wc)


def cache_tags_plain(key_words, hash_keys, nonce_k, nonce_v, pool_k, pool_v,
                     lids, blocks, live, wc) -> torch.Tensor:
    """(n, 2, E) int32 Carter–Wegman tags of blocks ``blocks`` (E,) int64
    of every layer of ``pool_*`` (n, NB, wpb), k then v:
    ``core.mac.uhash(hash_keys, words) ^ pad`` with the pad word 0 of
    ChaCha20(key, counter = block, nonce = (n0 ^ lid, n1 ^ wc[block], n2))
    and (n0, n1, n2) the stream's MAC nonce; 0 where ``live`` (E,) is
    False."""
    from repro_torch.core import mac    # deferred: mac imports this module
    wcb = wc[blocks]
    out = []
    for pool, nonce in ((pool_k, nonce_k), (pool_v, nonce_v)):
        tag = mac.uhash(hash_keys, pool[:, blocks]) ^ mac.mac_pads(
            key_words, nonce, blocks, wcb, lids[:, None],
            block_fn=chacha20_blocks_plain)
        out.append(torch.where(live, tag, torch.zeros_like(tag)))
    return torch.stack(out, dim=1)


def cache_tags_cuda(key_words, hash_keys, nonce_k, nonce_v, pool_k, pool_v,
                    lids, blocks, live, wc) -> torch.Tensor:
    """Launch ``cache_tags`` of ``csrc/chacha20_cache.cu``: one block of
    threads a tag, every layer, k and v, in one launch. The pools may be
    strided views of the stacked pool (no copy)."""
    from repro_torch.core.mac import MAX_WORDS
    dev = pool_k.device
    _check_words("key_words", key_words, (8,))
    _check_stacked_pools(pool_k, pool_v)
    n, nb, wpb = pool_k.shape
    e = blocks.shape[0]
    if wpb > MAX_WORDS:
        raise ValueError(f"{wpb} words a block exceed one tag's message")
    _check_words("hash_keys", hash_keys, (2 * wpb,))
    _check_words("wc", wc, (nb,))
    _check_words("lids", lids, (n,))
    if blocks.dtype != torch.int64 or tuple(blocks.shape) != (e,):
        raise TypeError(f"blocks: expected ({e},) int64")
    if live.dtype != torch.bool or tuple(live.shape) != (e,):
        raise TypeError(f"live: expected ({e},) bool")
    if e >= 2**31 or 2 * n >= 65536:
        raise ValueError("too many tags for one launch")
    _same_device(dev, key_words, hash_keys, pool_v, lids, blocks, live, wc)
    key_words, hash_keys, lids, blocks, live, wc = (
        t.contiguous() for t in (key_words, hash_keys, lids, blocks, live,
                                 wc))
    out = torch.empty((n, 2, e), dtype=torch.int32, device=dev)
    vec = (wpb % 4 == 0
           and all(s % 4 == 0 for s in pool_k.stride()[:2]
                   + pool_v.stride()[:2])
           and _aligned(pool_k, pool_v, hash_keys))
    fn = _build.load("chacha20_cache").cache_tags
    with torch.cuda.device(dev):
        rc = fn(key_words.data_ptr(), hash_keys.data_ptr(),
                pool_k.data_ptr(), pool_v.data_ptr(), pool_k.stride(0),
                pool_k.stride(1), pool_v.stride(0), pool_v.stride(1),
                lids.data_ptr(), blocks.data_ptr(), live.data_ptr(),
                wc.data_ptr(), out.data_ptr(), n, e, wpb,
                *_nonce_words(nonce_k), *_nonce_words(nonce_v), int(vec),
                _stream(dev))
    _build.check(rc, "cache_tags")
    cache_tags_cuda.launches += 1
    return out


def cache_tags(key_words, hash_keys, nonce_k, nonce_v, pool_k, pool_v, lids,
               blocks, live, wc) -> torch.Tensor:
    """(n, 2, E) int32 MAC tags of cache blocks, k and v of every layer
    (see ``cache_tags_plain``)."""
    fn = cache_tags_cuda if pool_k.is_cuda else cache_tags_plain
    return fn(key_words, hash_keys, nonce_k, nonce_v, pool_k, pool_v, lids,
              blocks, live, wc)


def cache_verify_plain(key_words, hash_keys, nonce_k, nonce_v, pool_k,
                       pool_v, mac_k, mac_v, lids, tables, lengths, wc,
                       bs: int) -> torch.Tensor:
    """(B,) bool verdict of a pass over every layer of ``pool_*`` (n, NB,
    wpb): slot b holds where each *resident* block of its table row
    (tables (B, MB) int64, columns below ceil(lengths[b] / bs)) has, in
    every layer and in k and v, the tags ``cache_tags_plain`` computes over
    its ciphertext equal to the stored ``mac_k``/``mac_v`` (n, NB): the AND
    of the per-layer verdicts of the reference's
    ``models/paged.py::_dense_view``."""
    b, mb = tables.shape
    n = pool_k.shape[0]
    resident = (torch.arange(mb, device=tables.device)[None, :]
                < ((lengths + bs - 1) // bs)[:, None])             # (B, MB)
    tags = cache_tags_plain(key_words, hash_keys, nonce_k, nonce_v, pool_k,
                            pool_v, lids, tables.reshape(-1),
                            resident.reshape(-1), wc)              # (n, 2, E)
    okb = ((tags[:, 0].reshape(n, b, mb) == mac_k[:, tables])
           & (tags[:, 1].reshape(n, b, mb) == mac_v[:, tables]))
    return (okb | ~resident).all(dim=2).all(dim=0)


def cache_verify_cuda(key_words, hash_keys, nonce_k, nonce_v, pool_k,
                      pool_v, mac_k, mac_v, lids, tables, lengths, wc,
                      bs: int) -> torch.Tensor:
    """Launch ``cache_verify`` of ``csrc/chacha20_cache.cu``: one block of
    threads a (table entry, layer, stream), every layer in one launch, the
    compare and the AND over layers in the kernel. The pools and tag words
    may be strided views of the stacked pool (no copy)."""
    from repro_torch.core.mac import MAX_WORDS
    dev = pool_k.device
    _check_words("key_words", key_words, (8,))
    _check_stacked_pools(pool_k, pool_v)
    n, nb, wpb = pool_k.shape
    b, mb = tables.shape
    if wpb > MAX_WORDS:
        raise ValueError(f"{wpb} words a block exceed one tag's message")
    _check_words("hash_keys", hash_keys, (2 * wpb,))
    _check_words("wc", wc, (nb,))
    _check_words("lids", lids, (n,))
    for name, t in (("mac_k", mac_k), ("mac_v", mac_v)):
        _check_words(name, t, (n, nb))
        if t.stride(1) != 1:
            raise ValueError(f"{name}: expected unit stride within a layer")
    if tables.dtype != torch.int64 or lengths.dtype != torch.int64 or \
            tuple(lengths.shape) != (b,):
        raise TypeError(f"tables ({b}, {mb}) and lengths ({b},): int64")
    if not 0 < bs or b * mb >= 2**31 or 2 * n >= 65536:
        raise ValueError("bad block size or too many tags for one launch")
    _same_device(dev, key_words, hash_keys, pool_v, mac_k, mac_v, lids,
                 tables, lengths, wc)
    key_words, hash_keys, lids, tables, lengths, wc = (
        t.contiguous() for t in (key_words, hash_keys, lids, tables, lengths,
                                 wc))
    ok = torch.ones((b,), dtype=torch.int32, device=dev)
    vec = (wpb % 4 == 0
           and all(s % 4 == 0 for s in pool_k.stride()[:2]
                   + pool_v.stride()[:2])
           and _aligned(pool_k, pool_v, hash_keys))
    fn = _build.load("chacha20_cache").cache_verify
    with torch.cuda.device(dev):
        rc = fn(key_words.data_ptr(), hash_keys.data_ptr(),
                pool_k.data_ptr(), pool_v.data_ptr(), pool_k.stride(0),
                pool_k.stride(1), pool_v.stride(0), pool_v.stride(1),
                mac_k.data_ptr(), mac_v.data_ptr(), mac_k.stride(0),
                mac_v.stride(0), lids.data_ptr(), tables.data_ptr(),
                lengths.data_ptr(), wc.data_ptr(), ok.data_ptr(), n, b * mb,
                mb, wpb, bs, *_nonce_words(nonce_k), *_nonce_words(nonce_v),
                int(vec), _stream(dev))
    _build.check(rc, "cache_verify")
    cache_verify_cuda.launches += 1
    return ok.to(torch.bool)


def cache_verify(key_words, hash_keys, nonce_k, nonce_v, pool_k, pool_v,
                 mac_k, mac_v, lids, tables, lengths, wc,
                 bs: int) -> torch.Tensor:
    """(B,) bool verdict of a cache read over every layer (see
    ``cache_verify_plain``)."""
    fn = cache_verify_cuda if pool_k.is_cuda else cache_verify_plain
    return fn(key_words, hash_keys, nonce_k, nonce_v, pool_k, pool_v, mac_k,
              mac_v, lids, tables, lengths, wc, bs)


# --------------------------------------------------------------------------
# line-sealed leaves: the whole leaf, or the rows of a gather
# --------------------------------------------------------------------------

def lines_unseal_plain(key_words, payload, counters, orig_len: int,
                       nonce2, line0: int = 0) -> torch.Tensor:
    """(orig_len,) int32 words of a line-sealed leaf: ``_line_otp`` XORed
    into the lines whose flag is set. ``counters`` None: ColoE records
    (L, 34) [32 data words | wc | flags], flag bit 0; else (L, 32) data
    lines and their (L,) counter words, flag bit 31, wc the low 31 bits.
    ``line0``: the address of the first line (a run of a larger leaf)."""
    from repro_torch.core.engine import _line_otp   # deferred: engine uses ops
    n_lines = payload.shape[0]
    addrs = torch.arange(line0, line0 + n_lines, dtype=torch.int32,
                         device=payload.device)
    if counters is None:
        ct, wc, enc = payload[:, :32], payload[:, 32], payload[:, 33] & 1
    else:
        c64 = u32.to_i64(counters)
        ct, wc, enc = payload, u32.from_i64(c64 & 0x7FFFFFFF), (c64 >> 31) & 1
    otp = _line_otp(key_words, addrs, wc, nonce2,
                    block_fn=chacha20_blocks_plain)
    pt = torch.where(enc.to(torch.bool)[:, None], ct ^ otp, ct)
    return pt.reshape(-1)[:orig_len]


def _check_lines(key_words, payload, counters):
    _check_words("key_words", key_words, (8,))
    _check_words("payload", payload)
    width = 34 if counters is None else 32
    if payload.ndim != 2 or payload.shape[1] != width:
        raise ValueError(f"payload: expected (L, {width}), got "
                         f"{tuple(payload.shape)}")
    if counters is not None:
        _check_words("counters", counters, (payload.shape[0],))
    _same_device(payload.device, key_words, counters)
    payload = payload.contiguous()
    if payload.data_ptr() % (8 if counters is None else 16):
        raise ValueError("payload is not aligned for the line kernel")
    return (key_words.contiguous(), payload,
            None if counters is None else counters.contiguous())


def lines_unseal_cuda(key_words, payload, counters, orig_len: int,
                      nonce2) -> torch.Tensor:
    """Launch ``lines_unseal`` of ``csrc/chacha20_lines.cu``: one launch a
    leaf, no counter or nonce array."""
    key_words, payload, counters = _check_lines(key_words, payload, counters)
    n_lines = payload.shape[0]
    if not 0 <= orig_len <= 32 * n_lines:
        raise ValueError(f"orig_len {orig_len} for {n_lines} lines")
    dev = payload.device
    out = torch.empty((orig_len,), dtype=torch.int32, device=dev)
    fn = _build.load("chacha20_lines").lines_unseal
    with torch.cuda.device(dev):
        rc = fn(key_words.data_ptr(), payload.data_ptr(),
                None if counters is None else counters.data_ptr(), n_lines,
                orig_len, *_nonce_words(nonce2), out.data_ptr(), _stream(dev))
    _build.check(rc, "lines_unseal")
    lines_unseal_cuda.launches += 1
    return out


def lines_unseal(key_words, payload, counters, orig_len: int,
                 nonce2) -> torch.Tensor:
    """(orig_len,) int32 plaintext words of a line-sealed leaf (see
    ``lines_unseal_plain``)."""
    fn = lines_unseal_cuda if payload.is_cuda else lines_unseal_plain
    return fn(key_words, payload, counters, orig_len, nonce2)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def lines_gather_rows_plain(key_words, payload, counters, nonce2, shape,
                            src_dtype, tokens, out_dtype) -> torch.Tensor:
    """Rows ``tokens`` of a line-sealed (V, D) leaf of ``src_dtype``, in
    ``out_dtype``: the whole leaf unsealed, indexed, then converted
    (``.to``: round to nearest even into bf16)."""
    numel = 1
    for d in shape:
        numel *= d
    words = lines_unseal_plain(key_words, payload, counters,
                               -(-numel * _itemsize(src_dtype) // 4), nonce2)
    w = words.view(src_dtype)[:numel].reshape(shape)
    return w[tokens].to(out_dtype)


def lines_gather_rows_cuda(key_words, payload, counters, nonce2, shape,
                           src_dtype, tokens, out_dtype) -> torch.Tensor:
    """Launch ``lines_gather_rows`` of ``csrc/chacha20_lines.cu``: only the
    half lines of the wanted rows are read and unsealed. f32 or bf16 leaf
    and output; tokens int64. A token outside [0, V) fails the kernel's
    device-side assert, as PyTorch's indexing on the card does."""
    key_words, payload, counters = _check_lines(key_words, payload, counters)
    kinds = (torch.float32, torch.bfloat16)
    if src_dtype not in kinds or out_dtype not in kinds:
        raise TypeError(f"{src_dtype} -> {out_dtype}: the kernel takes "
                        f"float32 and bfloat16")
    if tokens.dtype != torch.int64:
        raise TypeError(f"tokens: expected int64, got {tokens.dtype}")
    if len(shape) != 2:
        raise ValueError(f"expected a (V, D) leaf, got {tuple(shape)}")
    vocab, d = shape
    if vocab * d * _itemsize(src_dtype) > 128 * payload.shape[0]:
        raise ValueError(f"{tuple(shape)} {src_dtype} exceeds the payload")
    dev = payload.device
    _same_device(dev, tokens)
    tokens = tokens.contiguous()
    out = torch.empty(tuple(tokens.shape) + (d,), dtype=out_dtype,
                      device=dev)
    fn = _build.load("chacha20_lines").lines_gather_rows
    with torch.cuda.device(dev):
        rc = fn(key_words.data_ptr(), payload.data_ptr(),
                None if counters is None else counters.data_ptr(),
                *_nonce_words(nonce2), tokens.data_ptr(), tokens.numel(),
                vocab, d, int(src_dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), out.data_ptr(),
                _stream(dev))
    _build.check(rc, "lines_gather_rows")
    lines_gather_rows_cuda.launches += 1
    return out


def lines_gather_rows(key_words, payload, counters, nonce2, shape, src_dtype,
                      tokens, out_dtype) -> torch.Tensor:
    """(*tokens.shape, D) rows of a line-sealed (V, D) leaf in
    ``out_dtype`` (see ``lines_gather_rows_plain``)."""
    fn = lines_gather_rows_cuda if payload.is_cuda else \
        lines_gather_rows_plain
    return fn(key_words, payload, counters, nonce2, shape, src_dtype, tokens,
              out_dtype)


# --------------------------------------------------------------------------
# the sealed weight image's MAC tags
# --------------------------------------------------------------------------

def tile_tags_plain(key_words, hash_keys, nonce3, ct, row_mask, wc,
                    bk: int, bn: int) -> torch.Tensor:
    """(..., K//bk, N//bn) int32 tags of the (bk, bn) tiles of ``ct``
    (..., K, N) words: ``core.mac.uhash`` of each tile's words row-major,
    the rows where ``row_mask`` (..., K) is False zeroed, XOR word 0 of
    ChaCha20(key, counter = tile address, nonce = (n0, n1 ^ wc, n2)) with
    ``wc`` (...,) the slice's write counter. One row of tiles at a time, so
    the int64 temporaries stay a few times that row's size."""
    from repro_torch.core import mac    # deferred: mac imports this module
    lead = tuple(ct.shape[:-2])
    k, n = ct.shape[-2:]
    nn = n // bn
    wcs = wc.reshape(lead + (1,))
    out = []
    for ti in range(k // bk):
        rows = slice(ti * bk, (ti + 1) * bk)
        blk = torch.where(row_mask[..., rows, None], ct[..., rows, :],
                          torch.zeros((), dtype=ct.dtype, device=ct.device))
        tiles = blk.reshape(lead + (bk, nn, bn)).movedim(-3, -2)
        addr = ti * nn + torch.arange(nn, device=ct.device)
        out.append(mac.uhash(hash_keys, tiles.reshape(lead + (nn, bk * bn)))
                   ^ mac.mac_pads(key_words, nonce3, addr, wcs, 0,
                                  block_fn=chacha20_blocks_plain))
    return torch.stack(out, dim=-2)


def tile_tags_cuda(key_words, hash_keys, nonce3, ct, row_mask, wc,
                   bk: int, bn: int) -> torch.Tensor:
    """Launch ``tile_tags`` of ``csrc/chacha20_weights.cu``: one block of
    threads a tile, every stack slice in one launch."""
    from repro_torch.core.mac import MAX_WORDS
    dev = ct.device
    _check_words("key_words", key_words, (8,))
    _check_words("ct", ct)
    if ct.ndim < 2:
        raise ValueError(f"ct: expected (..., K, N), got {tuple(ct.shape)}")
    lead = tuple(ct.shape[:-2])
    k, n = ct.shape[-2:]
    for name, b, dim in (("bk", bk, k), ("bn", bn, n)):
        if b <= 0 or b & (b - 1) or dim % b:
            raise ValueError(f"{name} {b} is not a power of two dividing "
                             f"{dim}")
    if bk * bn > MAX_WORDS:
        raise ValueError(f"a {bk}x{bn} tile exceeds one tag's message")
    _check_words("hash_keys", hash_keys, (2 * bk * bn,))
    if row_mask.dtype != torch.bool or tuple(row_mask.shape) != lead + (k,):
        raise TypeError(f"row_mask: expected {lead + (k,)} bool")
    _check_words("wc", wc)
    if tuple(wc.shape) != lead:
        raise ValueError(f"wc: expected shape {lead}, got {tuple(wc.shape)}")
    slices = 1
    for d in lead:
        slices *= d
    tiles = (k // bk) * (n // bn)
    if slices >= 65536 or tiles >= 2**31:
        raise ValueError("too many tiles for one launch")
    _same_device(dev, key_words, hash_keys, row_mask, wc)
    key_words, hash_keys, ct, row_mask, wc = (
        t.contiguous() for t in (key_words, hash_keys, ct, row_mask, wc))
    out = torch.empty(lead + (k // bk, n // bn), dtype=torch.int32,
                      device=dev)
    vec = bn % 4 == 0 and _aligned(ct, hash_keys)
    fn = _build.load("chacha20_weights").tile_tags
    with torch.cuda.device(dev):
        rc = fn(key_words.data_ptr(), hash_keys.data_ptr(), ct.data_ptr(),
                row_mask.data_ptr(), wc.data_ptr(), out.data_ptr(), slices,
                k, n, bk, bn, *_nonce_words(nonce3), int(vec), _stream(dev))
    _build.check(rc, "tile_tags")
    tile_tags_cuda.launches += 1
    return out


def tile_tags(key_words, hash_keys, nonce3, ct, row_mask, wc, bk: int,
              bn: int) -> torch.Tensor:
    """(..., K//bk, N//bn) int32 MAC tags of a tile-sealed weight's tiles
    (see ``tile_tags_plain``)."""
    fn = tile_tags_cuda if ct.is_cuda else tile_tags_plain
    return fn(key_words, hash_keys, nonce3, ct, row_mask, wc, bk, bn)


def line_tags_plain(key_words, hash_keys, nonce3, payload, counters,
                    line0: int = 0) -> torch.Tensor:
    """(L,) int32 tags of a line-sealed leaf's records: ``core.mac.uhash``
    of each full stored record (ColoE ``payload`` (L, 34); counter layout
    ``payload`` (L, 32) with ``counters`` (L,) appended) XOR word 0 of
    ChaCha20(key, counter = line0 + row, nonce = nonce3). 2^20 lines at a
    time, so the int64 temporaries stay bounded at the embedding's size."""
    from repro_torch.core import mac    # deferred: mac imports this module
    out = []
    for a in range(0, payload.shape[0], 1 << 20):
        rows = slice(a, a + (1 << 20))
        rec = payload[rows] if counters is None else torch.cat(
            [payload[rows], counters[rows, None]], dim=1)
        addrs = line0 + a + torch.arange(rec.shape[0], device=payload.device)
        out.append(mac.uhash(hash_keys, rec) ^ mac.mac_pads(
            key_words, nonce3, addrs, 0, 0, block_fn=chacha20_blocks_plain))
    return torch.cat(out) if out else payload.new_zeros((0,))


def line_tags_cuda(key_words, hash_keys, nonce3, payload, counters,
                   line0: int = 0) -> torch.Tensor:
    """Launch ``line_tags`` of ``csrc/chacha20_weights.cu``: one thread a
    line, the counter table read where it lies."""
    key_words, payload, counters = _check_lines(key_words, payload, counters)
    width = payload.shape[1] + (0 if counters is None else 1)
    _check_words("hash_keys", hash_keys, (2 * width,))
    n_lines = payload.shape[0]
    if n_lines >= 2**32 or not 0 <= line0 < 2**32:
        raise ValueError(f"lines [{line0}, {line0} + {n_lines}) exceed u32 "
                         f"addresses")
    dev = payload.device
    _same_device(dev, hash_keys)
    hash_keys = hash_keys.contiguous()
    out = torch.empty((n_lines,), dtype=torch.int32, device=dev)
    fn = _build.load("chacha20_weights").line_tags
    with torch.cuda.device(dev):
        rc = fn(key_words.data_ptr(), hash_keys.data_ptr(),
                payload.data_ptr(),
                None if counters is None else counters.data_ptr(), n_lines,
                line0, *_nonce_words(nonce3), out.data_ptr(), _stream(dev))
    _build.check(rc, "line_tags")
    line_tags_cuda.launches += 1
    return out


def line_tags(key_words, hash_keys, nonce3, payload, counters,
              line0: int = 0) -> torch.Tensor:
    """(L,) int32 MAC tags of a line-sealed leaf's records (see
    ``line_tags_plain``)."""
    fn = line_tags_cuda if payload.is_cuda else line_tags_plain
    return fn(key_words, hash_keys, nonce3, payload, counters, line0)


for _fn in (cache_view_cuda, cache_splice_cuda, cache_copy_cuda,
            cache_tags_cuda, cache_verify_cuda, lines_unseal_cuda,
            lines_gather_rows_cuda, tile_tags_cuda, line_tags_cuda):
    _fn.launches = 0
