"""KV caches: the contiguous per-request caches of the one-shot prefill
and its decode (``attn_cache_spec``/``attn_cache_init``,
``block_cache_init``, ``model_cache_init``), the paged block pools and the
host-side block allocator (``kv_words_per_token``,
``kv_to_words``/``words_to_kv``, ``paged_pool_init``, ``BlockAllocator``).
Port of ``repro/models/cache.py``.

A contiguous cache is one (batch, cache_len, kv_heads, head_dim) buffer per
attention layer, with ``pos`` (cache_len,) the position each slot holds
(``INVALID_POS`` while empty, which the causal mask hides).

Pools hold raw u32 words (int32 bit patterns), so the sealed and plaintext
paths share every byte of layout. Block 0 is the scratch block: inactive
slots read it, and writes that the reference drops land there carrying the
block's own content. The per-block MAC words and ``PrefixRegistry`` come with
later slices.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig

INVALID_POS = 2**30

SCRATCH_BLOCK = 0

# recurrent caches come with the slice that ports their blocks
_RECURRENT_SLICE = ("{} caches come with the RG-LRU / SSD slice of the port "
                    "(MoE, RG-LRU and SSD blocks)")


def attn_cache_spec(cfg: ModelConfig, batch: int, cache_len: int, kind: str):
    """{"k", "v", "pos": (shape, dtype)} of one attention layer's cache; a
    sliding-window layer keeps ``min(cache_len, window)`` slots."""
    if kind == "local_attn" and cfg.window:
        cache_len = min(cache_len, cfg.window)
    kv = ((batch, cache_len, cfg.num_kv_heads, cfg.head_dim),
          getattr(torch, cfg.dtype))
    return {"k": kv, "v": kv, "pos": ((cache_len,), torch.int32)}


def attn_cache_init(cfg: ModelConfig, batch: int, cache_len: int, kind: str,
                    device=None):
    spec = attn_cache_spec(cfg, batch, cache_len, kind)
    kv_shape, dt = spec["k"]
    pos_shape, pos_dt = spec["pos"]
    return {"k": torch.zeros(kv_shape, dtype=dt, device=device),
            "v": torch.zeros(kv_shape, dtype=dt, device=device),
            "pos": torch.full(pos_shape, INVALID_POS, dtype=pos_dt,
                              device=device)}


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     device=None):
    if kind in ("attn", "local_attn"):
        return attn_cache_init(cfg, batch, cache_len, kind, device)
    if kind in ("rglru", "ssd"):
        raise NotImplementedError(_RECURRENT_SLICE.format(kind))
    raise ValueError(kind)


def model_cache_init(cfg: ModelConfig, batch: int, cache_len: int,
                     device=None):
    """Tuple over pattern positions of the layer cache stacked over
    super-blocks: k, v (n_super, batch, cache_len, kv_heads, head_dim), pos
    (n_super, cache_len)."""
    n = cfg.n_superblocks()
    out = []
    for kind in cfg.pattern:
        one = block_cache_init(cfg, kind, batch, cache_len, device)
        out.append({k: t[None].repeat((n,) + (1,) * t.ndim)
                    for k, t in one.items()})
    return tuple(out)


def kv_words_per_token(cfg: ModelConfig) -> int:
    """u32 words one token's K (or V) occupies in a pool block."""
    size = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    nbytes = cfg.num_kv_heads * cfg.head_dim * size
    if nbytes % 4:
        raise ValueError(f"KV row of {nbytes} bytes is not whole words")
    return nbytes // 4


def kv_to_words(x: torch.Tensor) -> torch.Tensor:
    """(..., E) float -> (..., E*itemsize//4) int32; a 2-byte dtype packs
    element 2i in the low half of word i (little-endian, as the reference's
    bitcast)."""
    if x.element_size() not in (2, 4):
        raise TypeError(f"unsupported kv dtype {x.dtype}")
    return x.contiguous().view(torch.int32)


def words_to_kv(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``kv_to_words``: (..., W) int32 -> (..., E) dtype."""
    return words.contiguous().view(dtype)


def paged_pool_init(cfg: ModelConfig, num_blocks: int, block_size: int,
                    device=None):
    """A tuple over pattern positions of {"k", "v": (n_super, num_blocks,
    words_per_block) int32, "lid": (n_super,) int32}. ``lid = n*npat + j`` is
    the layer id folded into the block keystream."""
    n, npat = cfg.n_superblocks(), len(cfg.pattern)
    wpb = block_size * kv_words_per_token(cfg)
    out = []
    for j, kind in enumerate(cfg.pattern):
        if kind not in ("attn", "local_attn"):
            raise ValueError(f"paged pools cover attention layers only "
                             f"(got {kind!r})")
        out.append({
            "k": torch.zeros((n, num_blocks, wpb), dtype=torch.int32,
                             device=device),
            "v": torch.zeros((n, num_blocks, wpb), dtype=torch.int32,
                             device=device),
            "lid": (torch.arange(n, dtype=torch.int32, device=device) * npat
                    + j),
        })
    return tuple(out)


class BlockAllocator:
    """Refcounted free-list allocator over pool blocks 1..num_blocks-1
    (block 0 is the scratch block)."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))   # pop() -> low ids
        self.refcount = [0] * num_blocks

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int):
        """n blocks at refcount 1, or None if short."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self.refcount[b] = 1
        return out

    def incref(self, blocks):
        for b in blocks:
            if self.refcount[b] <= 0:
                raise ValueError(f"incref of free block {b}")
            self.refcount[b] += 1

    def decref(self, blocks):
        """Drop one reference per block; frees blocks reaching zero."""
        freed = []
        for b in blocks:
            if self.refcount[b] <= 0:
                raise ValueError(f"decref of free block {b}")
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                self._free.append(b)
                freed.append(b)
        return freed
