"""Decode-time state: the contiguous per-request caches of the one-shot
prefill and its decode (``attn_cache_spec``/``attn_cache_init``, the RG-LRU
and SSD states ``rglru_cache_spec``/``rglru_cache_init`` and
``ssd_cache_spec``/``ssd_cache_init``, ``block_cache_spec``,
``block_cache_init``, ``_stack_spec``, ``model_cache_spec``,
``model_cache_init``), the paged block pools and the host-side block
accounting (``kv_words_per_token``, ``kv_to_words``/``words_to_kv``,
``paged_pool_spec``, ``paged_pool_init``, ``BlockAllocator``,
``PrefixRegistry``). Port of ``repro/models/cache.py``.

The per-layer ``*_spec`` functions give {name: (shape, dtype)};
``model_cache_spec`` and ``paged_pool_spec`` give trees of tensors on the
``meta`` device (the reference's ``ShapeDtypeStruct`` trees: shapes and
dtypes, nothing allocated).

A contiguous cache is one (batch, cache_len, kv_heads, head_dim) buffer per
attention layer, with ``pos`` (cache_len,) the position each slot holds
(``INVALID_POS`` while empty, which the causal mask hides); a recurrent
layer keeps its f32 state and the last K-1 pre-conv rows in the compute
dtype.

Pools hold raw u32 words (int32 bit patterns), so the sealed and plaintext
paths share every byte of layout. Block 0 is the scratch block: inactive
slots read it, and writes that the reference drops land there carrying the
block's own content. Each block also carries one co-located MAC word per
stream (``mac_k``/``mac_v``), zero unless the cache seal verifies.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig

INVALID_POS = 2**30

SCRATCH_BLOCK = 0


def attn_cache_spec(cfg: ModelConfig, batch: int, cache_len: int, kind: str):
    """{"k", "v", "pos": (shape, dtype)} of one attention layer's cache; a
    sliding-window layer keeps ``min(cache_len, window)`` slots."""
    if kind == "local_attn" and cfg.window:
        cache_len = min(cache_len, cfg.window)
    kv = ((batch, cache_len, cfg.num_kv_heads, cfg.head_dim),
          getattr(torch, cfg.dtype))
    return {"k": kv, "v": kv, "pos": ((cache_len,), torch.int32)}


def rglru_cache_spec(cfg: ModelConfig, batch: int):
    """The RG-LRU state h (batch, width) f32 and the conv tail (batch, 3,
    width) in the compute dtype."""
    w = cfg.rglru_block_width or cfg.d_model
    return {"h": ((batch, w), torch.float32),
            "conv": ((batch, 3, w), getattr(torch, cfg.dtype))}


def ssd_cache_spec(cfg: ModelConfig, batch: int):
    """The SSD state (batch, heads, head_dim, state) f32 and the conv tail
    (batch, conv - 1, d_inner + 2 state) in the compute dtype."""
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    return {"state": ((batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                      torch.float32),
            "conv": ((batch, cfg.ssm_conv - 1, di + 2 * n),
                     getattr(torch, cfg.dtype))}


def _alloc(spec, device, fill=None):
    """Zeros of each (shape, dtype) in ``spec``; ``fill``: {name: value}
    for leaves that start elsewhere."""
    fill = fill or {}
    return {k: torch.full(shape, fill.get(k, 0), dtype=dt, device=device)
            for k, (shape, dt) in spec.items()}


def attn_cache_init(cfg: ModelConfig, batch: int, cache_len: int, kind: str,
                    device=None):
    """An empty attention cache: zeros, every ``pos`` slot
    ``INVALID_POS``."""
    return _alloc(attn_cache_spec(cfg, batch, cache_len, kind), device,
                  {"pos": INVALID_POS})


def rglru_cache_init(cfg: ModelConfig, batch: int, device=None):
    return _alloc(rglru_cache_spec(cfg, batch), device)


def ssd_cache_init(cfg: ModelConfig, batch: int, device=None):
    return _alloc(ssd_cache_spec(cfg, batch), device)


def block_cache_spec(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int):
    if kind in ("attn", "local_attn"):
        return attn_cache_spec(cfg, batch, cache_len, kind)
    if kind == "rglru":
        return rglru_cache_spec(cfg, batch)
    if kind == "ssd":
        return ssd_cache_spec(cfg, batch)
    raise ValueError(kind)


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     device=None):
    """``block_cache_spec`` allocated: zeros, and every ``pos`` slot
    ``INVALID_POS``."""
    if kind in ("attn", "local_attn"):
        return attn_cache_init(cfg, batch, cache_len, kind, device)
    if kind == "rglru":
        return rglru_cache_init(cfg, batch, device)
    if kind == "ssd":
        return ssd_cache_init(cfg, batch, device)
    raise ValueError(kind)


def _stack_spec(specs):
    """n trees of ``meta`` tensors of one structure -> the tree of their
    stacks, (n, ...) each."""
    return {k: torch.empty((len(specs),) + tuple(t.shape), dtype=t.dtype,
                           device="meta")
            for k, t in specs[0].items()}


def model_cache_spec(cfg: ModelConfig, batch: int, cache_len: int):
    """The cache tree ``model_cache_init`` makes, as ``meta`` tensors: a
    tuple over pattern positions of the layer cache stacked over
    super-blocks."""
    n = cfg.n_superblocks()
    out = []
    for kind in cfg.pattern:
        one = {k: torch.empty(shape, dtype=dt, device="meta")
               for k, (shape, dt) in
               block_cache_spec(cfg, kind, batch, cache_len).items()}
        out.append(_stack_spec([one] * n))
    return tuple(out)


def model_cache_init(cfg: ModelConfig, batch: int, cache_len: int,
                     device=None):
    """Tuple over pattern positions of the layer cache stacked over
    super-blocks: k, v (n_super, batch, cache_len, kv_heads, head_dim), pos
    (n_super, cache_len); a recurrent layer's leaves (n_super, batch,
    ...)."""
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


def paged_pool_spec(cfg: ModelConfig, num_blocks: int, block_size: int):
    """The pools ``paged_pool_init`` makes, as ``meta`` tensors: per pattern
    position {"k", "v": (n_super, num_blocks, words_per_block), "mac_k",
    "mac_v": (n_super, num_blocks), "lid": (n_super,)}, int32 words where
    the reference's are uint32."""
    return paged_pool_init(cfg, num_blocks, block_size, "meta")


def paged_pool_init(cfg: ModelConfig, num_blocks: int, block_size: int,
                    device=None):
    """A tuple over pattern positions of {"k", "v": (n_super, num_blocks,
    words_per_block) int32, "mac_k", "mac_v": (n_super, num_blocks) int32,
    "lid": (n_super,) int32}. ``lid = n*npat + j`` is the layer id folded
    into the block keystream; the MAC words stay zero unless the cache seal
    carries a MAC context."""
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
            "mac_k": torch.zeros((n, num_blocks), dtype=torch.int32,
                                 device=device),
            "mac_v": torch.zeros((n, num_blocks), dtype=torch.int32,
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


class PrefixRegistry:
    """Prefix-hash -> block map for copy-on-write prefix sharing.

    Full blocks are keyed by a chain hash over their tokens (key i depends
    on every token of blocks [0, i]), so a lookup walks the prompt block by
    block and stops at the first miss. A *partial* entry records the
    committed token tail at the start of a block that is not full (the
    donor's prompt tail); a match against it shares those tokens too, and
    the sharer copies the block before appending into it. The registry holds
    one reference per registered block; ``evict_lru`` releases
    least-recently-used chains when admission runs short of blocks."""

    def __init__(self, alloc: BlockAllocator, block_size: int):
        self.alloc = alloc
        self.bs = block_size
        self._full = {}       # chain_key -> block id
        self._partial = {}    # chain_key of parent -> (block id, token tuple)
        self._parent = {}     # chain_key -> parent chain_key (purge cascade)
        self._lru = {}        # chain_key -> last-use tick (full entries)
        self._tick = 0
        self.hits = 0         # blocks served from the registry

    @staticmethod
    def chain_key(parent, block_tokens) -> int:
        return hash((parent, tuple(int(t) for t in block_tokens)))

    def match(self, prompt):
        """(full_blocks, partial, n_shared): registered blocks covering
        prompt[:len(full_blocks)*bs], an optional (block id, n_tokens)
        extending the chain mid-block, and the shared token count. At least
        one prompt token is left to recompute (its logits give the first
        token), so n_shared <= len(prompt) - 1."""
        bs, plen = self.bs, len(prompt)
        self._tick += 1
        full, key = [], None
        while (len(full) + 1) * bs <= plen - 1:
            i = len(full)
            k = self.chain_key(key, prompt[i * bs:(i + 1) * bs])
            b = self._full.get(k)
            if b is None:
                break
            key = k
            full.append(b)
            self._lru[key] = self._tick
        n_shared = len(full) * bs
        partial = None
        ent = self._partial.get(key)
        if ent is not None:
            b, toks = ent
            j = 0
            while (j < len(toks) and n_shared + j < plen - 1
                   and int(prompt[n_shared + j]) == toks[j]):
                j += 1
            if j > 0:
                partial = (b, j)
                n_shared += j
        self.hits += len(full) + (1 if partial else 0)
        return full, partial, n_shared

    def register(self, prompt, blocks):
        """Record a prefilled prompt whose slot table starts with
        ``blocks``. New chains gain a registry reference; chains already
        present are left as they are."""
        bs, plen = self.bs, len(prompt)
        key = None
        for i in range(plen // bs):
            k = self.chain_key(key, prompt[i * bs:(i + 1) * bs])
            if k not in self._full:
                self._full[k] = blocks[i]
                self.alloc.incref([blocks[i]])
                self._parent[k] = key
            key = k
            self._lru[key] = self._tick
        tail = tuple(int(t) for t in prompt[(plen // bs) * bs:])
        if tail and key not in self._partial:
            b = blocks[plen // bs]
            self._partial[key] = (b, tail)
            self.alloc.incref([b])

    def purge_blocks(self, blocks) -> int:
        """Forget every chain that touches ``blocks`` (content that failed
        an integrity check) and every chain descending from one: a chain
        hash commits to the tokens of blocks [0, i], so a chain through a
        purged block would keep serving the pre-tamper tokens. Drops the
        registry's references; returns the number of blocks freed."""
        bad = {int(b) for b in blocks}
        dead = {k for k, b in self._full.items() if b in bad}
        changed = True
        while changed:                 # cascade down the parent links
            changed = False
            for k, parent in self._parent.items():
                if parent in dead and k in self._full and k not in dead:
                    dead.add(k)
                    changed = True
        release = []
        for k in dead:
            release.append(self._full.pop(k))
            self._lru.pop(k, None)
            self._parent.pop(k, None)
        for k in list(self._partial):
            b, _ = self._partial[k]
            if b in bad or k in dead:
                release.append(self._partial.pop(k)[0])
        return len(self.alloc.decref(release))

    def evict_lru(self, need_free: int) -> int:
        """Release least-recently-used chains until the allocator has
        ``need_free`` free blocks or nothing evictable is left. Only blocks
        whose sole reference is the registry's go; returns how many."""
        freed = 0
        for key in sorted(self._lru, key=self._lru.get):
            if self.alloc.free_count >= need_free:
                break
            blocks = []
            if key in self._full and self.alloc.refcount[self._full[key]] == 1:
                blocks.append(self._full.pop(key))
                self._lru.pop(key)
            ent = self._partial.get(key)
            if ent and self.alloc.refcount[ent[0]] == 1:
                blocks.append(self._partial.pop(key)[0])
            freed += len(self.alloc.decref(blocks))
        # partial entries whose parent chain is gone
        dead = [k for k in self._partial
                if k is not None and k not in self._full]
        for k in dead:
            if self.alloc.free_count >= need_free:
                break
            if self.alloc.refcount[self._partial[k][0]] == 1:
                freed += len(self.alloc.decref([self._partial.pop(k)[0]]))
        return freed
