"""AES-128 ECB: the Hopper kernel and its plain PyTorch version.

No TPU kernel stands behind this module: the reference's Direct engine
(``repro/core/engine.py::DirectEngine``) runs AES as plain jnp
(``repro/core/cipher.py::aes128_encrypt_blocks`` /
``aes128_decrypt_blocks``, the S-box by gather). At the full width of
internlm2-1.8B that is 7.56 GB of lines to decrypt each dispatch, which a
composition of PyTorch passes cannot do in useful time, so the port has one
kernel, ``csrc/aes128.cu``, with two entry points:

* ``lines_encrypt`` (counted as ``aes128_lines_encrypt``): a leaf's words,
  zero-padded to whole 128-byte lines, each line's eight 16-byte blocks
  enciphered when its flag (bit 0) is set and copied when it is clear;
  sealing runs it. ``encrypt_blocks`` is the same entry point over a run of
  blocks with no flags (``core.cipher.aes128_encrypt_blocks`` and the CTR
  keystream).
* ``lines_decrypt`` (``aes128_lines_decrypt``): the inverse cipher of the
  lines whose flag is set, the others copied, only the leaf's first
  ``orig_len`` words written; every Direct dispatch runs it once a leaf.
  ``decrypt_blocks`` is the same entry point with no flags.

A block is the little-endian bytes of 4 consecutive int32 words, the state
column-major (byte r + 4c is row r, column c), as the reference's byte
views of its u32 words. Every route takes the plain version for a CPU
tensor and launches the kernel, or raises, for a CUDA tensor. The plain
versions are the reference's byte-wise rounds (S-box gathers, ShiftRows as
an index, MixColumns by xtime); the kernel uses 32-bit T-tables, replicated
once per shared-memory bank from ``kernel_tables`` (the layout is in the
source's header), so the two share no code.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import u32
from repro_torch.core import cipher as C
from repro_torch.core import coloe as CL
from repro_torch.kernels import _build

_TABLES: Dict[torch.device, Dict[str, torch.Tensor]] = {}
_KERNEL_TABLES: Dict[torch.device, torch.Tensor] = {}


def _tables(dev) -> Dict[str, torch.Tensor]:
    """The reference's byte tables on ``dev``, made once per device."""
    t = _TABLES.get(dev)
    if t is None:
        t = {"sbox": C.SBOX, "inv_sbox": C._INV_SBOX, "xt": C._XT,
             "shift": C._SHIFT, "inv_shift": C._INV_SHIFT}
        t.update({f"mul{m}": v for m, v in C._MUL.items()})
        t = {k: torch.from_numpy(v.copy()).to(dev) for k, v in t.items()}
        _TABLES[dev] = t
    return t


def _rotl8(x: np.ndarray, n: int) -> np.ndarray:
    return ((x << np.uint32(8 * n)) | (x >> np.uint32(32 - 8 * n))) \
        if n else x


def kernel_tables(dev) -> torch.Tensor:
    """(2, 5, 256) int32 words the kernel stages, made once per device: for
    the cipher (row 0) Te0..Te3 and the S-box, for the inverse cipher (row
    1) Td0..Td3 and the inverse S-box. Te0[x] holds the MixColumns column
    (2s, s, s, 3s) of s = S[x] in bytes 0..3, Td0[x] the InvMixColumns
    column (14i, 9i, 13i, 11i) of i = InvS[x]; Tj is T0 rotated left by 8j
    bits."""
    t = _KERNEL_TABLES.get(dev)
    if t is None:
        s = C.SBOX.astype(np.uint32)
        i = C._INV_SBOX.astype(np.uint32)
        xt = C._XT[C.SBOX].astype(np.uint32)
        te0 = xt | (s << 8) | (s << 16) | ((xt ^ s) << 24)
        m = {k: v[C._INV_SBOX].astype(np.uint32) for k, v in C._MUL.items()}
        td0 = m[14] | (m[9] << 8) | (m[13] << 16) | (m[11] << 24)
        rows = [[_rotl8(t0, j) for j in range(4)] + [box]
                for t0, box in ((te0, s), (td0, i))]
        t = u32.words(np.asarray(rows, np.uint32), dev)
        _KERNEL_TABLES[dev] = t
    return t


# --------------------------------------------------------------------------
# plain versions: the reference's byte-wise rounds
# --------------------------------------------------------------------------

def _mix_columns(t, s):
    v = s.reshape(s.shape[:-1] + (4, 4))             # (..., col, row)
    a0, a1, a2, a3 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    xt = t["xt"]
    x0, x1, x2, x3 = (xt[a.long()] for a in (a0, a1, a2, a3))
    r0 = x0 ^ (x1 ^ a1) ^ a2 ^ a3
    r1 = a0 ^ x1 ^ (x2 ^ a2) ^ a3
    r2 = a0 ^ a1 ^ x2 ^ (x3 ^ a3)
    r3 = (x0 ^ a0) ^ a1 ^ a2 ^ x3
    return torch.stack([r0, r1, r2, r3], dim=-1).reshape(s.shape)


def _inv_mix_columns(t, s):
    v = s.reshape(s.shape[:-1] + (4, 4)).long()
    a0, a1, a2, a3 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    m9, m11, m13, m14 = t["mul9"], t["mul11"], t["mul13"], t["mul14"]
    r0 = m14[a0] ^ m11[a1] ^ m13[a2] ^ m9[a3]
    r1 = m9[a0] ^ m14[a1] ^ m11[a2] ^ m13[a3]
    r2 = m13[a0] ^ m9[a1] ^ m14[a2] ^ m11[a3]
    r3 = m11[a0] ^ m13[a1] ^ m9[a2] ^ m14[a3]
    return torch.stack([r0, r1, r2, r3], dim=-1).reshape(s.shape)


def encrypt_blocks_plain(blocks: torch.Tensor,
                         round_keys: torch.Tensor) -> torch.Tensor:
    """(n, 16) uint8 blocks under (11, 16) uint8 round keys -> (n, 16)."""
    t = _tables(blocks.device)
    sbox, shift = t["sbox"], t["shift"]
    rk = round_keys
    s = blocks ^ rk[0]
    for r in range(1, 10):
        s = _mix_columns(t, sbox[s.long()][..., shift]) ^ rk[r]
    return sbox[s.long()][..., shift] ^ rk[10]


def decrypt_blocks_plain(blocks: torch.Tensor,
                         round_keys: torch.Tensor) -> torch.Tensor:
    """The inverse cipher of ``encrypt_blocks_plain``."""
    t = _tables(blocks.device)
    inv, ishift = t["inv_sbox"], t["inv_shift"]
    rk = round_keys
    s = blocks ^ rk[10]
    for r in range(9, 0, -1):
        s = inv[s[..., ishift].long()]
        s = _inv_mix_columns(t, s ^ rk[r])
    return inv[s[..., ishift].long()] ^ rk[0]


def _as_blocks(words: torch.Tensor) -> torch.Tensor:
    return words.reshape(-1).view(torch.uint8).reshape(-1, 16)


def _as_words(blocks: torch.Tensor) -> torch.Tensor:
    return blocks.reshape(-1).view(torch.int32)


def _select(flags, ct, pt):
    """Lines whose flag has bit 0 set take ``ct``, the others ``pt``."""
    if flags is None:
        return ct
    return torch.where((flags & 1).to(torch.bool)[:, None], ct, pt)


def lines_encrypt_plain(round_keys, words, flags) -> torch.Tensor:
    """(L, 32) int32 lines of ``words`` (m,) zero-padded, ECB-enciphered
    where ``flags`` (L,) has bit 0 set (all lines when None)."""
    lines, _ = CL.pad_to_lines(words.reshape(-1))
    ct = _as_words(encrypt_blocks_plain(_as_blocks(lines), round_keys))
    return _select(flags, ct.reshape(lines.shape), lines)


def lines_decrypt_plain(round_keys, payload, flags,
                        orig_len: int) -> torch.Tensor:
    """(orig_len,) int32 words of the (L, 32) lines ``payload``, the lines
    whose flag has bit 0 set (all when None) deciphered."""
    pt = _as_words(decrypt_blocks_plain(_as_blocks(payload.contiguous()),
                                        round_keys))
    return _select(flags, pt.reshape(payload.shape),
                   payload).reshape(-1)[:orig_len]


# --------------------------------------------------------------------------
# the kernel: csrc/aes128.cu
# --------------------------------------------------------------------------

def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _checked(round_keys, words, flags, n_blocks):
    """Device, dtype, shape and alignment checks shared by both entry
    points; returns contiguous operands, ``words`` 16-byte aligned."""
    dev = words.device
    if round_keys.dtype != torch.uint8 or tuple(round_keys.shape) != (11, 16):
        raise ValueError("round_keys: expected (11, 16) uint8")
    if words.dtype != torch.int32:
        raise TypeError(f"expected int32 u32 words, got {words.dtype}")
    if flags is not None:
        if flags.dtype != torch.int32:
            raise TypeError(f"flags: expected int32, got {flags.dtype}")
        if flags.numel() < -(-n_blocks // 8):
            raise ValueError(f"{flags.numel()} flags for {n_blocks} blocks")
    for t in (round_keys, flags):
        if t is not None and t.device != dev:
            raise ValueError("aes128 operands must share one device")
    words = words.reshape(-1).contiguous()
    if words.data_ptr() % 16:
        words = words.clone()             # a fresh allocation is aligned
    return (round_keys.contiguous(), words,
            None if flags is None else flags.reshape(-1).contiguous())


def lines_encrypt_cuda(round_keys, words, flags,
                       n_blocks: int = None) -> torch.Tensor:
    """Launch ``aes128_encrypt``: (4 * n_blocks,) int32 ciphertext words of
    ``words``, zero-padded; ``n_blocks`` defaults to the whole 128-byte
    lines that hold ``words``."""
    n = words.numel()
    if n_blocks is None:
        n_blocks = 8 * (-(-n // CL.WORDS_PER_LINE))
    if not 0 <= n <= 4 * n_blocks or n_blocks >= 2**40:
        raise ValueError(f"{n} words for {n_blocks} blocks")
    round_keys, words, flags = _checked(round_keys, words, flags, n_blocks)
    dev = words.device
    out = torch.empty((4 * n_blocks,), dtype=torch.int32, device=dev)
    if n_blocks == 0:
        return out
    fn = _build.load("aes128").aes128_encrypt
    with torch.cuda.device(dev):
        rc = fn(kernel_tables(dev)[0].data_ptr(), round_keys.data_ptr(),
                words.data_ptr(), n,
                None if flags is None else flags.data_ptr(), n_blocks,
                out.data_ptr(), _stream(dev))
    _build.check(rc, "aes128_encrypt")
    lines_encrypt_cuda.launches += 1
    return out


def lines_decrypt_cuda(round_keys, payload, flags,
                       orig_len: int) -> torch.Tensor:
    """Launch ``aes128_decrypt``: the first ``orig_len`` plaintext words of
    ``payload`` (whole 16-byte blocks), deciphered where the flag of the
    block's 128-byte line is set (everywhere when ``flags`` is None)."""
    n = payload.numel()
    if n % 4 or not 0 <= orig_len <= n:
        raise ValueError(f"orig_len {orig_len} of {n} words (whole blocks)")
    round_keys, payload, flags = _checked(round_keys, payload, flags, n // 4)
    dev = payload.device
    out = torch.empty((orig_len,), dtype=torch.int32, device=dev)
    if orig_len == 0:
        return out
    fn = _build.load("aes128").aes128_decrypt
    with torch.cuda.device(dev):
        rc = fn(kernel_tables(dev)[1].data_ptr(), round_keys.data_ptr(),
                payload.data_ptr(),
                None if flags is None else flags.data_ptr(), n // 4,
                orig_len, out.data_ptr(), _stream(dev))
    _build.check(rc, "aes128_decrypt")
    lines_decrypt_cuda.launches += 1
    return out


lines_encrypt_cuda.launches = 0
lines_decrypt_cuda.launches = 0


# --------------------------------------------------------------------------
# routes
# --------------------------------------------------------------------------

def lines_encrypt(round_keys, words, flags) -> torch.Tensor:
    """(L, 32) int32 ECB ciphertext lines of a leaf's words (see
    ``lines_encrypt_plain``)."""
    if not words.is_cuda:
        return lines_encrypt_plain(round_keys, words, flags)
    return lines_encrypt_cuda(round_keys, words, flags).reshape(
        -1, CL.WORDS_PER_LINE)


def lines_decrypt(round_keys, payload, flags, orig_len: int) -> torch.Tensor:
    """(orig_len,) int32 plaintext words of a Direct leaf (see
    ``lines_decrypt_plain``)."""
    fn = lines_decrypt_cuda if payload.is_cuda else lines_decrypt_plain
    return fn(round_keys, payload, flags, orig_len)


def _blocks(blocks: torch.Tensor, round_keys: torch.Tensor,
            inverse: bool) -> torch.Tensor:
    """(..., 16) uint8 blocks through the cipher or its inverse: on the
    card the line kernels over a run of blocks with no flags."""
    if blocks.dtype != torch.uint8 or blocks.shape[-1] != 16:
        raise ValueError(f"expected (..., 16) uint8 blocks, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    flat = blocks.reshape(-1, 16)
    if not blocks.is_cuda:
        plain = decrypt_blocks_plain if inverse else encrypt_blocks_plain
        return plain(flat, round_keys).reshape(blocks.shape)
    words = _as_words(flat.contiguous())
    out = (lines_decrypt_cuda(round_keys, words, None, words.numel())
           if inverse else
           lines_encrypt_cuda(round_keys, words, None, flat.shape[0]))
    return out.view(torch.uint8).reshape(blocks.shape)


def encrypt_blocks(blocks: torch.Tensor,
                   round_keys: torch.Tensor) -> torch.Tensor:
    """(..., 16) uint8 blocks enciphered under (11, 16) uint8 round keys."""
    return _blocks(blocks, round_keys, inverse=False)


def decrypt_blocks(blocks: torch.Tensor,
                   round_keys: torch.Tensor) -> torch.Tensor:
    """The inverse cipher of ``encrypt_blocks``."""
    return _blocks(blocks, round_keys, inverse=True)
