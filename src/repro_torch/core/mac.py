"""Truncated Carter–Wegman MACs over the sealed memory image. Port of
``repro/core/mac.py``.

One u32 tag per protected unit (a paged cache block per stream, a weight
tile, a 128-byte weight line):

  tag = uhash(ciphertext words)  XOR  pad(key, address, write counter, layer)

* ``uhash`` is a multilinear hash over GF(p), p = 2^31 - 1: the message is
  split into 16-bit halves m_i and hashed as sum(r_i * m_i) mod p with
  per-position keys r_i in [1, p) made once from the sealing key by ChaCha20
  (``_hash_keys``).
* ``pad`` is word 0 of one ChaCha20 block keyed by the MAC key, with the
  unit's (address, write counter, layer id) folded into counter and nonce.
  Binding the address catches relocation; binding the write counter catches
  replay and counter rollback, since the verifier derives the pad from the
  trusted counter.

The reference works in u32 arithmetic (the TPU has no 64-bit integers);
torch has no uint32 arithmetic on the CPU, so ``_fold``, ``_mul_mod`` and
``uhash`` run in int64 masked to the same 32-bit values. Every tag is the
exact value sum(r_i * m_i) mod p XOR pad, whatever the order of the sums, so
the card's kernels (``kernels.chacha20.cache_tags``, ``tile_tags``,
``line_tags``) match it bitwise. The hash keys and pads come from
``core.cipher.chacha20_block``: the ChaCha kernel on the card; the weight
layouts' tags make their pads inside their own kernels.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import u32
from repro_torch.core import cipher as C

P31 = 0x7FFFFFFF          # 2^31 - 1, Mersenne prime: the hash field
MAX_WORDS = 32768         # per-tag message cap (the reference's sum bound)

_HK_NONCE = (0x4D414331, 0x68616C66, 0x6B657973)   # "MAC1"/"half"/"keys"


class SealedIntegrityError(RuntimeError):
    """A MAC check failed at an unseal site.

    scope: "weights" (fail-stop: the model image is untrusted) or "cache"
    (recoverable: the serve engine fails and retries the owning request).
    ``slots`` / ``rids`` carry the affected serve slots / request ids when
    the failure is attributable.
    """

    def __init__(self, scope: str, detail: str = "",
                 slots: Sequence[int] = (), rids: Sequence[int] = ()):
        self.scope = scope
        self.slots = tuple(int(s) for s in slots)
        self.rids = tuple(int(r) for r in rids)
        msg = f"sealed-memory integrity failure [{scope}]"
        if detail:
            msg += f": {detail}"
        if self.slots:
            msg += f" (slots {list(self.slots)})"
        super().__init__(msg)


# --------------------------------------------------------------------------
# GF(2^31 - 1) arithmetic on u32 values (int64 tensors in [0, 2^32))
# --------------------------------------------------------------------------

def _fold(x: torch.Tensor) -> torch.Tensor:
    """Reduce u32 values (any in [0, 2^32)) to the canonical [0, P31)."""
    x = (x >> 31) + (x & P31)
    x = (x >> 31) + (x & P31)          # <= 2^31 -> <= P31
    return torch.where(x >= P31, x - P31, x)


def _mul_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod P31 for a in [0, P31) and b < 2^16, with every
    intermediate below 2^32 as in the reference: a = ah*2^16 + al, and
    hi*2^16 mod p is (hi >> 15) + ((hi & 0x7FFF) << 16) since 2^31 = 1."""
    ah, al = a >> 16, a & 0xFFFF
    hi = ah * b
    lo = al * b
    hi_m = _fold((hi >> 15) + ((hi & 0x7FFF) << 16))
    return _fold(hi_m + _fold(lo))


def uhash(keys: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Multilinear hash over the last axis of ``words``.

    keys (2*W,) in [0, P31) (int32 or int64 values); words (..., W) int32
    u32 words. Each word gives its low and then its high 16-bit half.
    Returns (...,) int32 tags in [0, P31)."""
    w = u32.to_i64(words)
    nh = 2 * w.shape[-1]
    if nh > 2 * MAX_WORDS:
        raise ValueError(f"message too long for one tag: {tuple(w.shape)}")
    if keys.shape[-1] != nh:
        raise ValueError(f"{keys.shape[-1]} keys for {nh} halves")
    halves = torch.stack([w & 0xFFFF, w >> 16],
                         dim=-1).reshape(w.shape[:-1] + (nh,))
    terms = _mul_mod(keys.to(torch.int64), halves)      # (..., nh)
    # with nh <= 2^16 the low-16 sum stays < 2^32 and the high-15 sum
    # < 2^31: both exact in u32, as the reference sums them
    lo = (terms & 0xFFFF).sum(dim=-1)
    hi = _fold((terms >> 16).sum(dim=-1))
    hi_m = _fold((hi >> 15) + ((hi & 0x7FFF) << 16))
    return _fold(hi_m + _fold(lo)).to(torch.int32)


def _hash_keys(key_words: torch.Tensor, n_halves: int) -> torch.Tensor:
    """(n_halves,) int32 hash keys r_i in [1, P31) on ``key_words``'s
    device: a ChaCha20 keystream of its own nonce domain, folded mod p, a
    zero key (which would leave its 16-bit position unauthenticated) made
    1."""
    nblk = -(-n_halves // 16)
    ctr = u32.from_i64(torch.arange(nblk, dtype=torch.int64,
                                    device=key_words.device))
    nonce = u32.words(_HK_NONCE, key_words.device)
    ks = C.chacha20_block(key_words, ctr, nonce)
    k = u32.to_i64(ks.reshape(-1)[:n_halves])
    k = (k >> 31) + (k & P31)
    k = torch.where(k >= P31, k - P31, k)
    return torch.where(k == 0, torch.ones_like(k), k).to(torch.int32)


@functools.lru_cache(maxsize=128)
def _hash_keys_host(key_bytes: bytes, n_halves: int) -> np.ndarray:
    """``_hash_keys`` of a sealing key on the host, as numpy u32 (the
    reference's memoized form)."""
    kw = u32.words(C.key_to_words(key_bytes[:32]))
    return u32.to_numpy(_hash_keys(kw, n_halves))


def mac_pads(key_words, nonce3, addrs, wcs, lids=0,
             block_fn=None) -> torch.Tensor:
    """One u32 Wegman-Carter pad per (address, write counter, id): word 0
    of ChaCha20(key, counter=addr, nonce=(n0 ^ lid, n1 ^ wc, n2)).
    ``addrs`` (int tensor) and ``wcs``/``lids`` (int tensors of u32 bit
    patterns, or ints) broadcast together; returns int32 of their shape."""
    dev = key_words.device
    a, w, l = torch.broadcast_tensors(
        *(torch.as_tensor(t, device=dev) for t in (addrs, wcs, lids)))
    shape = tuple(a.shape) or (1,)
    a, w, l = (u32.to_i64(t.reshape(-1)) for t in (a, w, l))
    n0, n1, n2 = (int(v) & u32.MASK for v in nonce3)
    nonces = torch.stack([l ^ n0, w ^ n1, torch.full_like(a, n2)], dim=1)
    pads = (block_fn or C.chacha20_block)(key_words, u32.from_i64(a),
                                          u32.from_i64(nonces))
    return pads[:, 0].reshape(shape)


@dataclasses.dataclass(frozen=True)
class MacContext:
    """The sealing key (hash keys derive from it), its words on the device,
    and the pad domain's base nonce. Per-stream separation comes from the
    ``tweak`` of ``tags`` (XORed into the nonce). Hash keys are made once
    per message length and kept on the device."""
    key_bytes: bytes
    nonce3: Tuple[int, int, int]
    key_words: torch.Tensor
    _keys: Dict[int, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def hash_keys(self, n_words: int) -> torch.Tensor:
        """(2*n_words,) int32 hash keys on the context's device."""
        keys = self._keys.get(n_words)
        if keys is None:
            keys = _hash_keys(self.key_words, 2 * n_words)
            self._keys[n_words] = keys
        return keys

    def nonce(self, tweak=(0, 0, 0)) -> Tuple[int, int, int]:
        """The pad nonce of one stream: the base nonce XOR ``tweak``."""
        return tuple((int(a) ^ int(b)) & u32.MASK
                     for a, b in zip(self.nonce3, tweak))

    def tags(self, ct_words, addrs, wcs, lids=0,
             tweak=(0, 0, 0)) -> torch.Tensor:
        """Tag per trailing-axis message: uhash(ct) ^ pad(addr, wc, lid).
        ``ct_words`` (..., W) int32; addrs/wcs/lids broadcast to (...,)."""
        tag = uhash(self.hash_keys(ct_words.shape[-1]), ct_words)
        return tag ^ mac_pads(self.key_words, self.nonce(tweak), addrs, wcs,
                              lids)


def mac_context(key_bytes: bytes, domain: str, device=None) -> MacContext:
    """MAC context whose pad nonce is bound to a named domain, apart from
    every encryption-nonce domain ("tiles/", "kvcache/", line nonces)."""
    h = hashlib.sha256(b"mac/" + domain.encode()).digest()
    return MacContext(bytes(key_bytes),
                      tuple(int.from_bytes(h[i:i + 4], "little")
                            for i in (20, 24, 28)),
                      u32.words(C.key_to_words(key_bytes[:32]), device))


# --------------------------------------------------------------------------
# layout-shaped tag helpers
# --------------------------------------------------------------------------

def tile_tags(ctx: MacContext, ct, row_mask, wc, bk: int, bn: int,
              tweak=(0, 0, 0)) -> torch.Tensor:
    """Per-(bk, bn)-tile tags of a tile-sealed weight.

    ct (..., K, N) int32 ciphertext words; row_mask (..., K) bool SE row
    flags; wc (...,) int32 write counter per stacked slice. The message of
    a tile is its words row-major with the SE bypass rows zeroed (out of MAC
    scope by construction); the pad binds (tile address, wc, tweak).
    Returns (..., K//bk, N//bn) int32. One kernel launch on the card
    (``ops.tile_tags``)."""
    from repro_torch.kernels import ops      # deferred: ops imports cipher
    return ops.tile_tags(ctx.key_words, ctx.hash_keys(bk * bn),
                         ctx.nonce(tweak), ct, row_mask, wc, bk, bn)


def line_tags(ctx: MacContext, payload, tweak=(0, 0, 0),
              counters=None) -> torch.Tensor:
    """Per-128 B-line tags of the at-rest line layout: (L,) int32.

    The message is the FULL stored record of each line: ColoE's 34 words
    (``payload`` (L, 34), counters None), or the counter scheme's 32 data
    words (``payload`` (L, 32)) with its counter word (``counters`` (L,))
    appended, so counter and flag tampering change the hash; the pad binds
    the line address (wc 0, id 0) and the per-tensor tweak. The reference
    takes the records concatenated; the kernel reads the counter table
    where it lies (``ops.line_tags``)."""
    from repro_torch.kernels import ops
    width = payload.shape[1] + (0 if counters is None else 1)
    return ops.line_tags(ctx.key_words, ctx.hash_keys(width),
                         ctx.nonce(tweak), payload, counters)
