"""ChaCha20 (RFC 7539). Port of the ChaCha half of ``repro/core/cipher.py``
(``chacha20_block``, ``chacha20_keystream_u32``, ``key_to_words``).

``chacha20_block`` routes through ``kernels.chacha20.chacha20_blocks``: the
Hopper kernel for CUDA tensors, the plain PyTorch rounds for CPU tensors. So
on the card every keystream the port makes (weight tiles and lines at
sealing, line layouts per step, KV-cache blocks per read and write) comes
from the hand-written kernel. AES-128 waits for the Direct engine's slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import u32
from repro_torch.kernels import chacha20 as _cc


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
