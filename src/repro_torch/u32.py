"""u32 words as ``torch.int32`` bit patterns.

No counterpart in ``src/repro/`` (JAX has a uint32 dtype). Torch on the CPU
has no uint32 add, shift or compare, so the port stores every u32 word
(ciphertext, keys, nonces, counters, pool words) as the int32 with the same
bits, does arithmetic in int64 masked to 32 bits, and converts with
``.view(np.uint32)`` at the numpy boundary. The CUDA kernels read the same
buffers as ``uint32_t*``.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF


def to_i64(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return words.to(torch.int64) & MASK


def from_i64(v: torch.Tensor) -> torch.Tensor:
    """int64 values (any range) -> int32 bit patterns of ``v mod 2**32``."""
    return (((v & MASK) + 2**31) & MASK).sub_(2**31).to(torch.int32)


def const(v: int) -> int:
    """A python u32 constant as the int32 value with the same bits."""
    v &= MASK
    return v - 2**32 if v >= 2**31 else v


def words(a, device=None) -> torch.Tensor:
    """numpy/sequence of u32 -> int32 tensor with the same bits."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> numpy uint32."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
