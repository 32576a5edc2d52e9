"""Block and stream ciphers of the SEAL engines. Port of
``repro/core/cipher.py``.

* AES-128: the paper's cipher, and the Direct engine's (ECB on 16-byte
  blocks). The host side is numpy, as in the reference: the S-box built
  from GF(2^8) inverses (``SBOX``, ``_INV_SBOX``), the key schedule
  (``aes128_key_schedule``) and ``derive_nonce``. ``aes128_encrypt_blocks``
  / ``aes128_decrypt_blocks`` take (n, 16) uint8 tensors and route through
  ``kernels.aes128``: the Hopper kernel (``csrc/aes128.cu``) for CUDA
  tensors, the plain PyTorch rounds for CPU tensors.
* ChaCha20 (RFC 7539): ``chacha20_block`` routes through
  ``kernels.chacha20.chacha20_blocks`` in the same way. So on the card every
  keystream the port makes (weight tiles and lines at sealing, line layouts
  per step, KV-cache blocks per read and write) comes from the hand-written
  kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import u32
from repro_torch.kernels import chacha20 as _cc

# ==========================================================================
# AES-128
# ==========================================================================


def _gf_mul(a: int, b: int) -> int:
    r = 0
    for _ in range(8):
        if b & 1:
            r ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return r


def _build_sbox() -> np.ndarray:
    # multiplicative inverse in GF(2^8) + affine transform (FIPS-197 §5.1.1)
    inv = np.zeros(256, np.uint8)
    for x in range(1, 256):
        for y in range(1, 256):
            if _gf_mul(x, y) == 1:
                inv[x] = y
                break
    sbox = np.zeros(256, np.uint8)
    for x in range(256):
        b = int(inv[x])
        s = 0
        for i in range(8):
            bit = ((b >> i) ^ (b >> ((i + 4) % 8)) ^ (b >> ((i + 5) % 8)) ^
                   (b >> ((i + 6) % 8)) ^ (b >> ((i + 7) % 8)) ^ (0x63 >> i)) & 1
            s |= bit << i
        sbox[x] = s
    return sbox


SBOX = _build_sbox()
_INV_SBOX = np.zeros(256, np.uint8)
_INV_SBOX[SBOX] = np.arange(256, dtype=np.uint8)

# xtime (multiply by 2 in GF(2^8)), and the products InvMixColumns takes
_XT = np.array([((x << 1) ^ (0x1B if x & 0x80 else 0)) & 0xFF
                for x in range(256)], np.uint8)
_MUL = {m: np.array([_gf_mul(x, m) for x in range(256)], np.uint8)
        for m in (9, 11, 13, 14)}

# ShiftRows on the flat column-major state: out[r+4c] = in[r+4((c+r)%4)]
_SHIFT = np.array([(r + 4 * ((c + r) % 4)) % 16 for c in range(4)
                   for r in range(4)], np.int64)
_INV_SHIFT = np.zeros(16, np.int64)
_INV_SHIFT[_SHIFT] = np.arange(16)

_RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36],
                 np.uint8)


def aes128_key_schedule(key: np.ndarray) -> np.ndarray:
    """key: (16,) uint8 -> round keys (11, 16) uint8. Host-side (numpy)."""
    key = np.asarray(key, np.uint8).reshape(16)
    w = [key[4 * i:4 * i + 4].copy() for i in range(4)]
    for i in range(4, 44):
        t = w[i - 1].copy()
        if i % 4 == 0:
            t = np.roll(t, -1)
            t = SBOX[t]
            t[0] ^= _RCON[i // 4 - 1]
        w.append(w[i - 4] ^ t)
    return np.stack([np.concatenate(w[4 * r:4 * r + 4]) for r in range(11)])


def round_keys_tensor(round_keys, device=None) -> torch.Tensor:
    """The (11, 16) round keys as a uint8 tensor on ``device``."""
    if torch.is_tensor(round_keys):
        rk = round_keys.to(device=device, dtype=torch.uint8)
    else:
        rk = torch.from_numpy(np.ascontiguousarray(
            np.asarray(round_keys, np.uint8))).to(device)
    if tuple(rk.shape) != (11, 16):
        raise ValueError(f"round keys: expected (11, 16), got "
                         f"{tuple(rk.shape)}")
    return rk.contiguous()


def aes128_encrypt_blocks(blocks: torch.Tensor, round_keys) -> torch.Tensor:
    """blocks (n, 16) uint8; round_keys (11, 16) uint8 -> (n, 16) uint8."""
    from repro_torch.kernels import aes128 as _aes   # the kernel imports this
    return _aes.encrypt_blocks(blocks,
                               round_keys_tensor(round_keys, blocks.device))


def aes128_decrypt_blocks(blocks: torch.Tensor, round_keys) -> torch.Tensor:
    """The inverse cipher of ``aes128_encrypt_blocks``."""
    from repro_torch.kernels import aes128 as _aes
    return _aes.decrypt_blocks(blocks,
                               round_keys_tensor(round_keys, blocks.device))


def aes128_ctr_keystream(round_keys, block_ids: torch.Tensor,
                         tweak: int = 0) -> torch.Tensor:
    """CTR keystream: block i pad = AES(tweak_hi64 || ctr_lo64(block_ids)).

    block_ids: (n,) u32 values (int32 bit patterns or int64) -> (n, 16)
    uint8 keystream. ``tweak`` carries the memory-line address, so identical
    counters at different addresses give different pads (paper §2.3)."""
    dev = block_ids.device
    bid = block_ids.to(torch.int64) & u32.MASK
    shifts = 8 * torch.arange(4, dtype=torch.int64, device=dev)
    ctr = torch.zeros((bid.shape[0], 16), dtype=torch.uint8, device=dev)
    ctr[:, :4] = ((bid[:, None] >> shifts) & 0xFF).to(torch.uint8)
    tw = np.frombuffer(np.uint64(tweak).tobytes(), np.uint8)
    ctr[:, 8:16] = torch.from_numpy(tw.copy()).to(dev)
    return aes128_encrypt_blocks(ctr, round_keys)


# ==========================================================================
# ChaCha20 (RFC 7539)
# ==========================================================================

def chacha20_block(key_words: torch.Tensor, counters: torch.Tensor,
                   nonce_words: torch.Tensor) -> torch.Tensor:
    """key_words (8,), counters (n,), nonce_words (3,) shared or (n, 3) per
    block, all int32 bit patterns of u32 words. Returns (n, 16) int32."""
    return _cc.chacha20_blocks(key_words, counters, nonce_words)


def chacha20_keystream_u32(key_words, n_words: int, nonce_words,
                           counter0: int = 0) -> torch.Tensor:
    """n_words u32 words of keystream (padded up to 16-word blocks)."""
    nblk = -(-n_words // 16)
    dev = key_words.device
    ctr = u32.from_i64(torch.arange(counter0, counter0 + nblk,
                                    dtype=torch.int64, device=dev))
    return chacha20_block(key_words, ctr, nonce_words).reshape(-1)[:n_words]


def key_to_words(key_bytes: bytes) -> np.ndarray:
    if len(key_bytes) != 32:
        raise ValueError(f"ChaCha20 key must be 32 bytes, got {len(key_bytes)}")
    return np.frombuffer(key_bytes, np.uint32).copy()


def derive_nonce(tensor_id: int) -> np.ndarray:
    """Per-tensor nonce from a stable tensor id (path hash)."""
    rng = np.random.RandomState(tensor_id & 0x7FFFFFFF)
    return rng.randint(0, 2**31, size=3).astype(np.uint32)
