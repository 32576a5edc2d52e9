"""``SealedTensor`` — a ciphertext weight that stays sealed until the matmul.
Port of ``repro/core/sealed_tensor.py``, as a plain class (no pytree).

Two layouts:

* ``"lines"`` — the at-rest image: payload (L, 32) data lines (counter
  scheme, counters in a separate table; Direct, AES-ECB, its flags in the
  same slot) or (L, 34) ColoE records. Decrypted
  before use (``sealed_store.fused_params`` / ``unseal_params``), except the
  serving view's token embedding: ``gather_rows`` decrypts only the rows a
  dispatch embeds, inside the gather kernel.
* ``"tiles"`` — the matmul operand: the logical weight bitcast to u32 words
  in its own shape, sealed so that every (bk, bn) tile's keystream derives
  from the tile address. ``matmul`` hands it to the fused decrypt-in-matmul
  kernel, so the plaintext weight never exists in device memory.

Layer-stacked leaves carry the stack axis in front of every child (payload
(n, ...), row_mask (n, K), key (n, 8), wc (n,)). The reference lets
``lax.scan`` slice them; here the layer loop calls ``slice(i)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import u32


@dataclasses.dataclass(frozen=True)
class SealMeta:
    """Static layout metadata."""
    scheme: str                    # direct | counter | coloe
    layout: str                    # lines | tiles
    dtype: str                     # original leaf dtype, e.g. "float32"
    nonce: Tuple[int, ...]         # 2 words (lines) / 3 words (tiles)
    shape: Tuple[int, ...]         # logical (stacked) leaf shape
    orig_len: int = 0              # valid words (lines layout)
    n_batch: int = 0               # tiles: leading stack axes at seal time
    k_ndim: int = 1                # tiles: contraction (row) axes
    n_out: int = 1                 # tiles: trailing output axes
    bk: int = 128                  # tiles: seal tile, contraction
    bn: int = 128                  # tiles: seal tile, output


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class SealedTensor:
    """Ciphertext leaf.

    payload:     int32 words (layout-dependent shape, see module doc)
    counters:    (L,) separate counter table (counter scheme) or line flags
                 (Direct) — lines only
    row_mask:    (batch..., K) bool SE row flags — tiles only
    key_words:   (batch..., 8) int32 — tiles, and the serving view's
                 line-sealed embedding (``sealed_store.serving_params``)
    wc:          (batch...,) int32 per-slice write counter — tiles only
    nonce_words: (3,) int32 on the payload's device — tiles only; kept as a
                 tensor so a matmul launches without a host-to-device copy
    macs:        int32 Carter–Wegman tags beside the counter metadata
                 (lines: (L,) one a 128 B line; tiles: (batch..., K//bk,
                 N//bn) one a tile); None when sealed without integrity
    """

    __slots__ = ("payload", "counters", "row_mask", "key_words", "wc",
                 "meta", "nonce_words", "macs")

    def __init__(self, payload, counters, row_mask, key_words, wc,
                 meta: SealMeta, nonce_words=None, macs=None):
        self.payload = payload
        self.counters = counters
        self.row_mask = row_mask
        self.key_words = key_words
        self.wc = wc
        self.meta = meta
        if nonce_words is None and meta.layout == "tiles":
            nonce_words = u32.words(meta.nonce, payload.device)
        self.nonce_words = nonce_words
        self.macs = macs

    def __repr__(self):
        return (f"SealedTensor({self.meta.scheme}/{self.meta.layout}, "
                f"payload={tuple(self.payload.shape)}, shape={self.meta.shape})")

    # ---- tiles-layout geometry ----

    @property
    def sliced(self) -> bool:
        """True once the stack axes were taken off (``slice``)."""
        m = self.meta
        return self.payload.ndim == m.k_ndim + m.n_out

    @property
    def out_shape(self) -> Tuple[int, ...]:
        return tuple(self.payload.shape[-self.meta.n_out:])

    @property
    def k_size(self) -> int:
        m = self.meta
        k = 1
        for d in self.payload.shape[-(m.k_ndim + m.n_out):-m.n_out]:
            k *= d
        return k

    @property
    def n_size(self) -> int:
        n = 1
        for d in self.out_shape:
            n *= d
        return n

    def logical_bytes(self) -> int:
        n = 1
        for d in self.meta.shape:
            n *= d
        return n * torch.empty((), dtype=torch_dtype(self.meta.dtype)
                               ).element_size()

    def stored_bytes(self) -> int:
        """Bytes of the at-rest image (counters, flags and MACs included)."""
        mac_b = self.macs.numel() * 4 if self.macs is not None else 0
        if self.meta.layout == "tiles":
            b = self.payload.numel() * 4
            if self.row_mask is not None:
                b += self.row_mask.numel()          # 1 B/row SE flag
            if self.wc is not None:
                b += max(self.wc.numel(), 1) * 4    # write counters
            return b + mac_b
        n_lines = self.payload.shape[0]
        if self.meta.scheme == "coloe":
            return n_lines * self.payload.shape[1] * 4 + mac_b
        extra = n_lines * 8 if self.meta.scheme == "counter" else 0
        return n_lines * 32 * 4 + extra + mac_b

    def extra_streams(self) -> int:
        """Independent memory streams a reader must fetch (1 = colocated)."""
        return 2 if (self.meta.layout == "lines"
                     and self.meta.scheme == "counter") else 1

    # ---- consumption ----

    def slice(self, i: int) -> "SealedTensor":
        """Layer ``i`` of a stacked tiles leaf (what ``lax.scan`` does
        implicitly in the reference)."""
        if self.meta.layout != "tiles" or self.sliced:
            raise ValueError(f"{self!r} has no stack axis to slice")
        return SealedTensor(self.payload[i], None, self.row_mask[i],
                            self.key_words[i], self.wc[i], self.meta,
                            self.nonce_words)

    def matmul(self, x2d: torch.Tensor, *,
               compute_dtype: str = "float32") -> torch.Tensor:
        """``x2d @ decrypt(payload)`` with the decrypt fused into the matmul
        kernel; (M, K) -> (M, N) f32. Tiles layout, sliced or unstacked."""
        m = self.meta
        if m.layout != "tiles":
            raise ValueError("matmul needs the tile-sealed layout")
        if not self.sliced:
            raise ValueError(
                f"stacked SealedTensor {tuple(self.payload.shape)}: slice the "
                f"{m.n_batch} stack axis before matmul")
        from repro_torch.kernels import ops   # deferred, as in the reference
        return ops.sealed_matmul(
            x2d, self.payload.reshape(self.k_size, self.n_size),
            self.row_mask.reshape(self.k_size), self.key_words.reshape(8),
            self.nonce_words, write_counter=self.wc.reshape(()),
            bk=m.bk, bn=m.bn, compute_dtype=compute_dtype)


    def gather_rows(self, tokens: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
        """Rows ``tokens`` of a line-sealed (V, D) leaf, in ``dtype``: only
        the lines that hold them are decrypted, inside the gather kernel
        (``ops.lines_gather_rows``). Needs the key words the serving view
        attaches."""
        m = self.meta
        if m.layout != "lines" or self.key_words is None:
            raise ValueError("gather_rows needs a line-sealed leaf with its "
                             "key words (sealed_store.serving_params)")
        from repro_torch.kernels import ops   # deferred, as in ``matmul``
        return ops.lines_gather_rows(self.key_words, self.payload,
                                     self.counters, m.nonce, m.shape,
                                     torch_dtype(m.dtype), tokens, dtype)


def slice_layer(leaf, i: int):
    """Layer ``i`` of a stacked parameter: a tensor row or a sealed slice."""
    return leaf.slice(i) if isinstance(leaf, SealedTensor) else leaf[i]
