"""ChaCha20 keystream: the Hopper kernel and its plain PyTorch version.

Port of ``repro/kernels/chacha20.py::chacha20_keystream`` (the Pallas kernel
``_keystream_kernel`` with ``_chacha_rounds``/``_qr``). The CUDA source is
``csrc/chacha20.cu``; its rounds live in ``csrc/chacha20.cuh`` and are shared
with the fused sealed matmul.

Unlike the Pallas kernel, the nonce may be per block ((n, 3)), so the line
OTP and the KV-cache OTP run on the card through this kernel as well.

What bounds it on this card: 976 32-bit integer operations per 64-byte block
written (80 bytes moved with the counter and a per-block nonce), so at the
H100's issue rate of 33.5e12 lane operations per second against 3.35 TB/s
the arithmetic, just ahead of the bytes. One thread per block, state in
registers, four 16-byte stores per block.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import u32
from repro_torch.kernels import _build

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
