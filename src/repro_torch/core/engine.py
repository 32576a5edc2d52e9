"""Memory-encryption engines — paper §2.3 / §3.2. Port of the counter-mode
half of ``repro/core/engine.py``: ``tensor_to_words``/``words_to_tensor``,
``_line_otp``, ``SealedBuffer``, ``CounterEngine``, ``ColoEEngine`` and
``make_engine``.

* ``CounterEngine`` — OTP = ChaCha20(key, line_addr, write_counter) XOR data;
  counters in a separate table (the paper's extra memory stream).
* ``ColoEEngine``   — the same OTP, counters co-located per line in a packed
  34-word record (the paper's contribution).

Words are int32 bit patterns of u32 (``repro_torch.u32``). On the card a
decrypt makes its pads inside one kernel a leaf (``ops.lines_unseal``), and
sealing takes its keystream from the ChaCha kernel
(``core.cipher.chacha20_block``). Both engines carry the weight MAC
context (domain "weights") and the line layout's tags (``line_macs``:
``kernels.chacha20.line_tags`` on the card). ``DirectEngine`` (AES-128)
comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import u32
from repro_torch.core import cipher as C
from repro_torch.core import coloe as CL
from repro_torch.core import mac as M
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref

_FLAG_BIT = 1 << 31


def tensor_to_words(x: torch.Tensor) -> Tuple[torch.Tensor, tuple, torch.dtype]:
    """Bitcast a float/int tensor to a flat int32 word buffer (pads to 4 B)."""
    flat = x.reshape(-1).contiguous()
    dt = x.dtype
    size = flat.element_size()
    if size == 4:
        words = flat.view(torch.int32)
    elif size == 2:
        if flat.shape[0] % 2:
            flat = torch.cat([flat, flat.new_zeros((1,))])
        words = flat.view(torch.int32)
    else:
        raise TypeError(f"unsupported dtype {dt}")
    return words, tuple(x.shape), dt


def words_to_tensor(words: torch.Tensor, shape, dtype: torch.dtype):
    n = 1
    for d in shape:
        n *= d
    flat = words.reshape(-1).contiguous().view(dtype)
    return flat[:n].reshape(shape)


def _line_otp(key_words, line_addrs, write_counters, nonce2, block_fn=None):
    """128 B OTP per line: two ChaCha blocks with
    nonce = (line_addr, nonce2[0], nonce2[1]), counter = wc*2 + subblock.
    Sealing uses it; a decrypt makes these pads inside its kernel
    (``kernels.chacha20.lines_unseal``), whose plain version passes
    ``block_fn``."""
    dev = key_words.device
    n_lines = line_addrs.shape[0]
    addrs = u32.to_i64(line_addrs).repeat_interleave(2)
    wc = u32.to_i64(write_counters).repeat_interleave(2)
    sub = torch.arange(2, dtype=torch.int64, device=dev).repeat(n_lines)
    counters = u32.from_i64(wc * 2 + sub)
    nonces = torch.stack([
        addrs,
        torch.full_like(addrs, int(nonce2[0]) & u32.MASK),
        torch.full_like(addrs, int(nonce2[1]) & u32.MASK)], dim=1)
    ks = (block_fn or C.chacha20_block)(key_words, counters,
                                        u32.from_i64(nonces))
    return ks.reshape(n_lines, CL.WORDS_PER_LINE)


@dataclasses.dataclass
class SealedBuffer:
    """Ciphertext + metadata for one tensor."""
    scheme: str                        # counter | coloe
    payload: torch.Tensor              # counter: (L,32); coloe: (L,34)
    counters: Optional[torch.Tensor]   # counter scheme: separate (L,) table
    orig_len: int                      # valid words
    shape: tuple
    dtype: torch.dtype
    nonce2: tuple                      # per-tensor nonce words

    @property
    def n_lines(self) -> int:
        return self.payload.shape[0]

    def data_bytes(self) -> int:
        return self.n_lines * CL.WORDS_PER_LINE * 4

    def stored_bytes(self) -> int:
        if self.scheme == "coloe":
            return self.n_lines * CL.COLOE_LINE_WORDS * 4
        return self.data_bytes() + self.n_lines * 8

    def extra_streams(self) -> int:
        """Independent memory streams a reader must fetch (1 = colocated)."""
        return 2 if self.scheme == "counter" else 1


class _CtrBase:
    """What the counter-mode engines share: the line OTP, the tile-sealed
    matmul layout and the KV-cache block layout (see the reference's
    ``EngineProtocol`` docstring)."""
    supports_fused = True
    name = ""

    def __init__(self, key_bytes: bytes, device=None):
        self.key_words = u32.words(C.key_to_words(key_bytes[:32]), device)
        self.mac_ctx = M.mac_context(key_bytes, "weights", device)

    def _otp(self, n_lines, write_counters, nonce2):
        addrs = torch.arange(n_lines, dtype=torch.int32,
                             device=self.key_words.device)
        return _line_otp(self.key_words, addrs, write_counters, nonce2)

    def _nonce3(self, nonce3):
        return u32.words(nonce3, self.key_words.device)

    def decrypt(self, s: SealedBuffer):
        """The tensor back from its lines: each line unsealed under the wc and
        flag its scheme keeps (ColoE in the record, counter mode in the
        separate counter word)."""
        words = ops.lines_unseal(self.key_words, s.payload, s.counters,
                                 s.orig_len, s.nonce2)
        return words_to_tensor(words, s.shape, s.dtype)

    def line_record(self, s: SealedBuffer) -> torch.Tensor:
        """The full at-rest record of each line, the MAC message: ColoE's
        packed 34 words, or the counter scheme's 32 data words with their
        counter word appended."""
        if s.scheme == "coloe":
            return s.payload
        return torch.cat([s.payload, s.counters[:, None]], dim=1)

    def line_macs(self, s: SealedBuffer, tweak=(0, 0, 0)) -> torch.Tensor:
        """(L,) int32 tags of the line records (``core.mac.line_tags``; the
        kernel reads the counter table where it lies, so ``line_record`` is
        never built on this path)."""
        return M.line_tags(self.mac_ctx, s.payload, tweak,
                           counters=None if s.scheme == "coloe"
                           else s.counters)

    def verify_lines(self, s: SealedBuffer, macs,
                     tweak=(0, 0, 0)) -> torch.Tensor:
        """(L,) bool: each line's tag against the stored MACs."""
        return self.line_macs(s, tweak) == macs

    def encrypt_tiles(self, w2d, nonce3, row_mask, write_counter,
                      bk: int, bn: int):
        """(K, N) f32 -> (K, N) int32 ciphertext; rows where ``row_mask`` is
        False stay plaintext (SE bypass, paper §3.3)."""
        return _ref.seal_weights_ref(w2d, self.key_words, self._nonce3(nonce3),
                                     bk, bn, row_mask, write_counter)

    def decrypt_tiles(self, ct2d, nonce3, row_mask, write_counter,
                      bk: int, bn: int):
        return _ref.unseal_weights_ref(ct2d, self.key_words,
                                       self._nonce3(nonce3), bk, bn,
                                       row_mask, write_counter)

    def seal_cache_blocks(self, words, nonce3, block_ids, write_counters,
                          layer_ids):
        """XOR-seal (or unseal) int32 cache-block payloads (..., wpb)."""
        return words ^ _ref.cache_block_otp(
            self.key_words, nonce3, block_ids, write_counters, layer_ids,
            words.shape[-1])

    unseal_cache_blocks = seal_cache_blocks      # XOR involution


class CounterEngine(_CtrBase):
    """Counter-mode with a separate counter table — paper's 'Counter'. The
    stored counter word carries the emalloc flag in bit 31."""
    name = "counter"

    def _seal(self, lines, wc64, nonce2):
        ct_full = lines ^ self._otp(lines.shape[0],
                                    u32.from_i64(wc64 & 0x7FFFFFFF), nonce2)
        enc = ((wc64 >> 31) & 1).to(torch.bool)[:, None]
        return torch.where(enc, ct_full, lines)

    def encrypt(self, x, nonce2=(1, 2), write_counters=None,
                enc_flags=None) -> SealedBuffer:
        words, shape, dt = tensor_to_words(x)
        lines, orig = CL.pad_to_lines(words)
        n_lines = lines.shape[0]
        wc = (torch.zeros((n_lines,), dtype=torch.int64, device=lines.device)
              if write_counters is None else u32.to_i64(write_counters))
        if enc_flags is not None:
            wc = wc | ((u32.to_i64(enc_flags) & 1) << 31)
        else:
            wc = wc | _FLAG_BIT
        ct = self._seal(lines, wc, nonce2)
        return SealedBuffer("counter", ct, u32.from_i64(wc), orig, shape, dt,
                            tuple(nonce2))

    def rewrite(self, s: SealedBuffer, x) -> SealedBuffer:
        """Write-back: bump per-line counters so OTPs are never reused."""
        words, shape, dt = tensor_to_words(x)
        lines, orig = CL.pad_to_lines(words)
        old = u32.to_i64(s.counters)
        wc = ((old & 0x7FFFFFFF) + 1) | (old & _FLAG_BIT)
        ct = self._seal(lines, wc, s.nonce2)
        return SealedBuffer("counter", ct, u32.from_i64(wc), orig, shape, dt,
                            s.nonce2)


class ColoEEngine(_CtrBase):
    """Colocation-mode — counters packed in-line (paper's contribution)."""
    name = "coloe"

    def _seal(self, lines, wc, flags, nonce2):
        otp = self._otp(lines.shape[0], wc, nonce2)
        enc = (flags & 1).to(torch.bool)[:, None]
        return torch.where(enc, lines ^ otp, lines)

    def encrypt(self, x, nonce2=(1, 2), write_counters=None,
                enc_flags=None) -> SealedBuffer:
        words, shape, dt = tensor_to_words(x)
        lines, orig = CL.pad_to_lines(words)
        n_lines = lines.shape[0]
        dev = lines.device
        wc = (torch.zeros((n_lines,), dtype=torch.int32, device=dev)
              if write_counters is None else write_counters.to(torch.int32))
        flags = (torch.full((n_lines,), CL.FLAG_ENCRYPTED, dtype=torch.int32,
                            device=dev)
                 if enc_flags is None else enc_flags.to(torch.int32))
        ct = self._seal(lines, wc, flags, nonce2)
        return SealedBuffer("coloe", CL.coloe_pack(ct, wc, flags), None, orig,
                            shape, dt, tuple(nonce2))

    def rewrite(self, s: SealedBuffer, x) -> SealedBuffer:
        _, wc, flags = CL.coloe_unpack(s.payload)
        words, shape, dt = tensor_to_words(x)
        lines, orig = CL.pad_to_lines(words)
        wc = u32.from_i64(u32.to_i64(wc) + 1)
        ct = self._seal(lines, wc, flags, s.nonce2)
        return SealedBuffer("coloe", CL.coloe_pack(ct, wc, flags), None,
                            orig, shape, dt, s.nonce2)


def make_engine(mode: str, key_bytes: bytes, device=None):
    engines = {"counter": CounterEngine, "coloe": ColoEEngine}
    if mode == "direct":
        raise NotImplementedError(
            "the Direct (AES-128) engine is not ported yet; it comes with the "
            "Direct/AES slice of the port")
    return engines[mode](key_bytes, device)
