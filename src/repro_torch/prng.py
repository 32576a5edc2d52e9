"""The part of ``jax.random`` that the serving sampler uses, bit for bit.

No counterpart file in ``src/repro/``: the reference draws its tokens with
jax's default generator (``repro/serve/sampling.py``), threefry2x32 with
``jax_threefry_partitionable`` on (jax 0.9.0's default). This module ports
what that path reaches, so a sampled token stream is the reference's:

* ``threefry2x32``: the Threefry-2x32 hash, 20 rounds in five groups of
  four (rotations 13/15/26/6 and 17/29/16/24), a key injection after each
  group (``jax._src.prng._threefry2x32_lowering``);
* ``key`` / ``fold_in`` / ``key_data``: a key is its (2,) u32 data; a seed
  that fits 32 bits gives (0, seed); ``fold_in(k, d)`` hashes the count
  pair (0, d) under k;
* ``random_bits``: 32-bit draws of a 1-D shape, element i the XOR of the
  two hash words of the count pair (0, i) (the partitionable scheme);
* ``uniform``: the top 23 bits as a mantissa in [1, 2), minus 1, scaled to
  [minval, maxval) and clamped below at minval, in f32;
* ``gumbel``: ``-log(-log(u))`` with u uniform on [tiny, 1) (the "low"
  mode, jax's default);
* ``categorical``: the argmax of logits plus gumbel noise along the last
  axis, the first maximal index on ties.

Keys carry a leading batch axis: key data (B, 2) with one row per draw, as
``jax.vmap`` over the reference's functions gives. u32 words are int32 bit
patterns (``repro_torch.u32``); the arithmetic is int64 masked to 32 bits,
so the same code runs on the CPU and on the card and gives the same bits.
``torch.log`` may differ from XLA's ``log`` by an ulp, so gumbel noise (not
the bits or the uniforms) can differ in its last bits.
"""
from __future__ import annotations

import torch

from repro_torch import u32

_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & u32.MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """Threefry-2x32 of the count pairs (x1, x2) under the key (k1, k2).
    All four are int64 tensors of u32 values that broadcast together;
    returns the two hash words, int64 u32 values of the broadcast shape."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & u32.MASK
    x2 = (x2 + ks[1]) & u32.MASK
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x1 = (x1 + x2) & u32.MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(g + 1) % 3]) & u32.MASK
        x2 = (x2 + ks[(g + 2) % 3] + g + 1) & u32.MASK
    return x1, x2


def key(seed: int) -> torch.Tensor:
    """(2,) int32 key data of ``jax.random.key(seed)``: (0, seed) as u32,
    for a seed of 32 bits, signed or unsigned."""
    if not -2**31 <= seed < 2**32:
        raise OverflowError(f"seed {seed} does not fit in 32 bits")
    return u32.words([0, seed & u32.MASK])


def key_data(keys: torch.Tensor) -> torch.Tensor:
    """The (..., 2) int32 words of keys (keys are their data here)."""
    return keys


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of each key of ``keys`` (..., 2) with
    ``data`` (an int, or an int tensor broadcasting to keys.shape[:-1],
    taken mod 2^32): the hash of the count pair (0, data)."""
    k = u32.to_i64(keys)
    d = torch.as_tensor(data, device=keys.device).to(torch.int64) & u32.MASK
    h1, h2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return u32.from_i64(torch.stack(torch.broadcast_tensors(h1, h2), dim=-1))


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) int64 u32 draws, row b from key ``keys[b]`` (B, 2), as
    ``jax.random.bits(key, (n,))`` under the partitionable scheme."""
    k = u32.to_i64(keys)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    h1, h2 = threefry2x32(k[:, :1], k[:, 1:], torch.zeros_like(i), i)
    return h1 ^ h2


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """(B, n) f32 uniforms on [minval, maxval), as ``jax.random.uniform``
    in f32."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = u32.from_i64(bits).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) f32 Gumbel noise, ``jax.random.gumbel`` in its default mode."""
    return -torch.log(-torch.log(uniform(keys, n, TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """(B,) int64 draws from the rows of ``logits`` (B, V) f32, row b under
    key ``keys[b]``: ``jax.vmap(jax.random.categorical)``."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)
