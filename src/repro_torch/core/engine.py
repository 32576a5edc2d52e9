"""Memory-encryption engines — paper §2.3 / §3.2. Port of
``repro/core/engine.py``: ``tensor_to_words``/``words_to_tensor``,
``_line_otp``, ``SealedBuffer``, ``EngineProtocol``, ``DirectEngine``,
``CounterEngine``, ``ColoEEngine`` and ``make_engine``.

* ``DirectEngine``  — AES-128-ECB on each 16 B block, one global key: the
  paper's "traditional memory encryption" baseline. Equal plaintext lines
  give equal ciphertext lines, and the line layout is all it has.
* ``CounterEngine`` — OTP = ChaCha20(key, line_addr, write_counter) XOR data;
  counters in a separate table (the paper's extra memory stream).
* ``ColoEEngine``   — the same OTP, counters co-located per line in a packed
  34-word record (the paper's contribution).

Words are int32 bit patterns of u32 (``repro_torch.u32``). On the card the
Direct engine's lines go through the AES kernel
(``ops.aes128_lines_encrypt`` / ``aes128_lines_decrypt``, one launch a
leaf); a counter-mode decrypt makes its pads inside one kernel a leaf
(``ops.lines_unseal``), and sealing takes its keystream from the ChaCha
kernel (``core.cipher.chacha20_block``). Every engine carries the weight
MAC context (domain "weights") and the line layout's tags
(``EngineProtocol.line_macs``: ``kernels.chacha20.line_tags`` on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import u32
from repro_torch.core import cipher as C
from repro_torch.core import coloe as CL
from repro_torch.core import mac as M
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref

_FLAG_BIT = 1 << 31
# lines sealed a pass: the pads and their int64 counter and nonce arrays
# stay near 1.2 GB whatever the leaf's size (a stacked MoE expert leaf is
# 37.7 M lines)
SEAL_LINES = 1 << 22


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
    scheme: str                        # direct | counter | coloe
    payload: torch.Tensor              # direct/counter: (L,32); coloe: (L,34)
    counters: Optional[torch.Tensor]   # counter: (L,) table; direct: flags
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
        extra = self.n_lines * 8 if self.scheme == "counter" else 0
        return self.data_bytes() + extra

    def extra_streams(self) -> int:
        """Independent memory streams a reader must fetch (1 = colocated)."""
        return 2 if self.scheme == "counter" else 1


class EngineProtocol:
    """What every memory-encryption engine emits (see the reference's
    docstring): the line-packed at-rest layout (``encrypt``/``decrypt``),
    its Carter–Wegman tags over the full stored record of each line
    (``line_record``, ``line_macs``, ``verify_lines``), and, for the
    counter-mode engines only (``supports_fused``), the tile-sealed matmul
    layout and the KV-cache block layout. AES-ECB has no counter structure
    to exploit, so Direct stays on the eager line layout."""
    supports_fused = False
    name = ""

    def line_record(self, s: SealedBuffer) -> torch.Tensor:
        """The full at-rest record of each line, the MAC message: ColoE's
        packed 34 words, or the 32 data words of the counter and Direct
        layouts with their counter or flag word appended."""
        if s.scheme == "coloe":
            return s.payload
        return torch.cat([s.payload, s.counters[:, None]], dim=1)

    def line_macs(self, s: SealedBuffer, tweak=(0, 0, 0)) -> torch.Tensor:
        """(L,) int32 tags of the line records (``core.mac.line_tags``; the
        kernel reads the counter or flag word where it lies, so
        ``line_record`` is never built on this path)."""
        return M.line_tags(self.mac_ctx, s.payload, tweak,
                           counters=None if s.scheme == "coloe"
                           else s.counters)

    def verify_lines(self, s: SealedBuffer, macs,
                     tweak=(0, 0, 0)) -> torch.Tensor:
        """(L,) bool: each line's tag against the stored MACs."""
        return self.line_macs(s, tweak) == macs

    def seal_cache_blocks(self, words, nonce3, block_ids, write_counters,
                          layer_ids):
        raise NotImplementedError(f"{self.name}: no cache-block layout")

    def encrypt_tiles(self, w2d, nonce3, row_mask, write_counter,
                      bk: int, bn: int):
        raise NotImplementedError(f"{self.name}: no tile-sealed layout")

    def decrypt_tiles(self, ct2d, nonce3, row_mask, write_counter,
                      bk: int, bn: int):
        raise NotImplementedError(f"{self.name}: no tile-sealed layout")


class DirectEngine(EngineProtocol):
    """AES-128-ECB — the paper's 'Direct' baseline. The flags (bit 0: the
    line is enciphered) ride in the ``counters`` slot; the nonce is (0, 0),
    since ECB takes none."""
    name = "direct"

    def __init__(self, key_bytes: bytes, device=None):
        self.round_keys = C.round_keys_tensor(C.aes128_key_schedule(
            np.frombuffer(key_bytes[:16], np.uint8)), device)
        self.mac_ctx = M.mac_context(key_bytes, "weights", device)

    def encrypt(self, x, nonce2=(0, 0), enc_flags=None) -> SealedBuffer:
        """Lines of ``x``'s words, zero-padded, each enciphered block by
        block where its flag is set and stored verbatim where it is not.
        ``nonce2`` is taken for the engines' common signature and unused."""
        words, shape, dt = tensor_to_words(x)
        n_lines = -(-words.shape[0] // CL.WORDS_PER_LINE)
        flags = (torch.ones((n_lines,), dtype=torch.int32,
                            device=words.device)
                 if enc_flags is None else enc_flags.to(torch.int32))
        ct = ops.aes128_lines_encrypt(self.round_keys, words, flags)
        return SealedBuffer("direct", ct, flags, words.shape[0], shape, dt,
                            (0, 0))

    def decrypt(self, s: SealedBuffer):
        """The tensor back from its lines: one kernel launch on the card,
        which deciphers the flagged lines, copies the others and writes only
        the first ``orig_len`` words."""
        words = ops.aes128_lines_decrypt(self.round_keys, s.payload,
                                         s.counters, s.orig_len)
        return words_to_tensor(words, s.shape, s.dtype)


class _CtrBase(EngineProtocol):
    """What the counter-mode engines share: the line OTP, the tile-sealed
    matmul layout and the KV-cache block layout (see the reference's
    ``EngineProtocol`` docstring)."""
    supports_fused = True

    def __init__(self, key_bytes: bytes, device=None):
        self.key_words = u32.words(C.key_to_words(key_bytes[:32]), device)
        self.mac_ctx = M.mac_context(key_bytes, "weights", device)

    def _otp(self, first, n_lines, write_counters, nonce2):
        """The pads of lines [first, first + n_lines)."""
        addrs = torch.arange(first, first + n_lines, dtype=torch.int32,
                             device=self.key_words.device)
        return _line_otp(self.key_words, addrs, write_counters, nonce2)

    def _seal_runs(self, out, lines, seal) -> torch.Tensor:
        """``out[rows] = seal(first, rows)`` over runs of ``SEAL_LINES``
        lines; returns ``out``."""
        for a in range(0, lines.shape[0], SEAL_LINES):
            out[a:a + SEAL_LINES] = seal(a, slice(a, a + SEAL_LINES))
        return out

    def _nonce3(self, nonce3):
        return u32.words(nonce3, self.key_words.device)

    def decrypt(self, s: SealedBuffer):
        """The tensor back from its lines: each line unsealed under the wc and
        flag its scheme keeps (ColoE in the record, counter mode in the
        separate counter word)."""
        words = ops.lines_unseal(self.key_words, s.payload, s.counters,
                                 s.orig_len, s.nonce2)
        return words_to_tensor(words, s.shape, s.dtype)

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
        def run(first, rows):
            w = wc64[rows]
            ct = lines[rows] ^ self._otp(first, w.shape[0],
                                         u32.from_i64(w & 0x7FFFFFFF), nonce2)
            enc = ((w >> 31) & 1).to(torch.bool)[:, None]
            return torch.where(enc, ct, lines[rows])
        return self._seal_runs(torch.empty_like(lines), lines, run)

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
        """The packed (L, 34) records [32 data words | wc | flags] of
        ``lines`` sealed under ``wc`` (``coloe.coloe_pack``), written run by
        run."""
        def run(first, rows):
            otp = self._otp(first, wc[rows].shape[0], wc[rows], nonce2)
            enc = (flags[rows] & 1).to(torch.bool)[:, None]
            return CL.coloe_pack(torch.where(enc, lines[rows] ^ otp,
                                             lines[rows]),
                                 wc[rows], flags[rows])
        out = torch.empty((lines.shape[0], CL.COLOE_LINE_WORDS),
                          dtype=torch.int32, device=lines.device)
        return self._seal_runs(out, lines, run)

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
        return SealedBuffer("coloe", self._seal(lines, wc, flags, nonce2),
                            None, orig, shape, dt, tuple(nonce2))

    def rewrite(self, s: SealedBuffer, x) -> SealedBuffer:
        _, wc, flags = CL.coloe_unpack(s.payload)
        words, shape, dt = tensor_to_words(x)
        lines, orig = CL.pad_to_lines(words)
        wc = u32.from_i64(u32.to_i64(wc) + 1)
        return SealedBuffer("coloe", self._seal(lines, wc, flags, s.nonce2),
                            None, orig, shape, dt, s.nonce2)


ENGINES = {"direct": DirectEngine, "counter": CounterEngine,
           "coloe": ColoEEngine}


def make_engine(mode: str, key_bytes: bytes, device=None):
    return ENGINES[mode](key_bytes, device)
