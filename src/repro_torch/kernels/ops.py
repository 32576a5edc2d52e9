"""Public wrappers over the port's kernels. Port of ``repro/kernels/ops.py``
(``keystream``, ``seal_weights``, ``sealed_matmul``,
``decrypt_then_matmul``), plus ``flash_attention`` (the route of
``kernels/flash_attention.py::flash_attention``, which the reference calls
straight from ``repro/kernels/flash_attention.py``), and the
ChaCha routes that make their pads where the data is used (the reference
composes these from ``chacha20_keystream``): ``cache_view``,
``cache_splice``, ``cache_copy``, ``cache_tags`` and ``cache_verify`` of
the paged KV cache, ``lines_unseal`` and ``lines_gather_rows`` of
line-sealed leaves, and ``tile_tags`` and ``line_tags`` of the sealed
weight image's MACs; and
AES-128 ECB over line-sealed leaves (``aes128_lines_encrypt`` /
``aes128_lines_decrypt``) for the Direct engine, which the reference runs as
jnp.

A CPU tensor takes a kernel's plain version; a CUDA tensor launches the
kernel or raises — there is no fallback. ``launch_counts`` reads the plain
integer each kernel wrapper adds one to per launch.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import u32
from repro_torch.kernels import aes128 as _aes
from repro_torch.kernels import chacha20 as _cc
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sealed_matmul as _sm

_COUNTED = {"chacha20": _cc.chacha20_blocks,
            "chacha20_cache_view": _cc.cache_view_cuda,
            "chacha20_cache_splice": _cc.cache_splice_cuda,
            "chacha20_cache_copy": _cc.cache_copy_cuda,
            "chacha20_cache_tags": _cc.cache_tags_cuda,
            "chacha20_cache_verify": _cc.cache_verify_cuda,
            "chacha20_lines_unseal": _cc.lines_unseal_cuda,
            "chacha20_lines_gather": _cc.lines_gather_rows_cuda,
            "chacha20_weight_tile_tags": _cc.tile_tags_cuda,
            "chacha20_weight_line_tags": _cc.line_tags_cuda,
            "sealed_matmul": _sm.sealed_matmul_cuda,
            "sealed_matmul_tc": _sm.sealed_matmul_tc_cuda,
            "sealed_matmul_dec": _sm.sealed_matmul_dec_cuda,
            "flash_attention": _fa.flash_attention_cuda,
            "flash_attention_tc": _fa.flash_attention_tc_cuda,
            "flash_attention_tc256": _fa.flash_attention_tc256_cuda,
            "aes128_lines_encrypt": _aes.lines_encrypt_cuda,
            "aes128_lines_decrypt": _aes.lines_decrypt_cuda}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0


# pads made inside the pass that consumes them (kernels/chacha20.py)
cache_view = _cc.cache_view
cache_splice = _cc.cache_splice
cache_copy = _cc.cache_copy
cache_tags = _cc.cache_tags
cache_verify = _cc.cache_verify
lines_unseal = _cc.lines_unseal
lines_gather_rows = _cc.lines_gather_rows
tile_tags = _cc.tile_tags
line_tags = _cc.line_tags
# AES-128 ECB over the Direct engine's lines (kernels/aes128.py)
aes128_lines_encrypt = _aes.lines_encrypt
aes128_lines_decrypt = _aes.lines_decrypt


def _refuse_autograd(kernel: str, route: str, *tensors) -> None:
    """A CUDA kernel has no backward: with grad mode on and an input that
    requires grad, its output would carry no gradient and training would
    silently not move the weights behind it, so refuse."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward; inputs that require "
            f"grad take the differentiable route ({route})")


def keystream(key_words, nonce_words, n_blocks: int, *,
              counter0: int = 0) -> torch.Tensor:
    """(16, n_blocks) int32 ChaCha20 keystream, word-major as the
    reference's. The kernel writes (n, 16); the transpose is a view."""
    ctr = u32.from_i64(torch.arange(counter0, counter0 + n_blocks,
                                    dtype=torch.int64,
                                    device=key_words.device))
    return _cc.chacha20_keystream(key_words, nonce_words, ctr)


def seal_weights(w, key_words, nonce_words, *, bk: int = 128, bn: int = 128,
                 row_mask=None, write_counter=0) -> torch.Tensor:
    """Tile-seal of a weight matrix: (K, N) f32 -> (K, N) int32 ciphertext,
    rows where ``row_mask`` is False left plaintext. The pads come from
    ``core.cipher.chacha20_block``: the ChaCha20 kernel
    (``csrc/chacha20.cu``) on a CUDA tensor."""
    return _ref.seal_weights_ref(w, key_words, nonce_words, bk, bn,
                                 row_mask, write_counter)


def sealed_matmul(x, w_ct, row_mask, key_words, nonce_words,
                  write_counter=0, *, bm: int = 128, bk: int = 128,
                  bn: int = 128, compute_dtype: str = "float32"
                  ) -> torch.Tensor:
    """Fused decrypt + matmul: ``x @ f32(w_ct ^ pad)``, (M, N) f32.

    K and N must be multiples of the seal's (bk, bn). The CUDA route
    refuses an ``x`` that requires grad under grad mode
    (``_refuse_autograd``). On the CPU, M is
    padded as the reference pads it: not at all when M < bm, else up to a
    multiple of bm. The CUDA kernels mask a ragged M themselves, so a CUDA
    tensor goes in unpadded (no copy of the activations, no rows of thrown
    away products)."""
    if x.is_cuda:
        _refuse_autograd("sealed_matmul", "plaintext weights through "
                         "layers.dense", x)
    if not torch.is_tensor(write_counter):
        write_counter = torch.tensor(u32.const(int(write_counter)),
                                     dtype=torch.int32, device=x.device)
    m = x.shape[0]
    bm = min(bm, m) if m % bm else bm
    pad = 0 if x.is_cuda else (-m) % bm
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    out = _sm.sealed_matmul(x, w_ct, row_mask, key_words, nonce_words,
                            write_counter, bk=bk, bn=bn,
                            compute_dtype=compute_dtype)
    return out[:m]


def decrypt_then_matmul(x, w_ct, row_mask, key_words, nonce_words,
                        write_counter=0, *, bk: int = 128,
                        bn: int = 128) -> torch.Tensor:
    """The unfused baseline, (M, N) f32: the whole weight unsealed first
    (its pads from the ChaCha20 kernel on a CUDA tensor, an extra round
    trip of the weight through memory), then a plain f32 product
    (``torch.matmul``; the reference's is a ``jnp.dot`` outside any Pallas
    kernel)."""
    w = _ref.unseal_weights_ref(w_ct, key_words, nonce_words, bk, bn,
                                row_mask, write_counter)
    return torch.matmul(x.to(torch.float32), w)


flash_attention = _fa.flash_attention
