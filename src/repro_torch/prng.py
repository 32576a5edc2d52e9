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
  axis, the first maximal index on ties;
* ``normal``: ``sqrt(2) * erf_inv(u)`` with u uniform on
  [nextafter(-1, 0), 1) (``jax._src.random._normal_real``), ``erf_inv``
  XLA's single-precision polynomial (Giles, two branches split at
  w = -log1p(-u^2) = 5).

Keys carry a leading batch axis: key data (B, 2) with one row per draw, as
``jax.vmap`` over the reference's functions gives. u32 words are int32 bit
patterns (``repro_torch.u32``); the arithmetic is int64 masked to 32 bits,
so the same code runs on the CPU and on the card and gives the same bits.
``torch.log`` may differ from XLA's ``log`` by an ulp, so gumbel noise (not
the bits or the uniforms) can differ in its last bits. Likewise ``normal``:
XLA fuses each Horner step of ``erf_inv`` into one fused multiply-add, which
the port reproduces by summing in f64 and rounding once to f32, but its
``log1p`` is its own. The port takes ``log1p`` in f64 rounded to f32: on 8M
draws under three seeds 99.06% of ``normal``'s values equal the reference's,
the rest within 3 ulp (2.4e-7 relative). The same f64 arithmetic runs on
the card, so the card's draws are the CPU's.
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


# XLA's single-precision erf_inv (Giles): Horner coefficients, highest first,
# for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# f32(nextafter(-1, 0)): the open lower end of normal's uniforms
_NEXT_ABOVE_MINUS_ONE = -1.0 + 2.0 ** -24
_SQRT2_F32 = 1.41421353816986083984375       # f32(sqrt(2))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 ``lax.erf_inv`` for |x| < 1: XLA's polynomial, each Horner step
    one rounding to f32 (XLA fuses it into an FMA)."""
    w = (-torch.log1p(-(x * x).double())).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    lo = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    hi = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = (torch.where(lt, lo[i], hi[i]).double() + p.double() * w).float()
    return p * x


def normal(key_: torch.Tensor, shape) -> torch.Tensor:
    """f32 standard normals of ``shape`` under one key (2,), as
    ``jax.random.normal(key, shape)``: element i (row-major) from the i-th
    uniform."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    u = uniform(key_[None], n, _NEXT_ABOVE_MINUS_ONE, 1.0)[0]
    return (torch.tensor(_SQRT2_F32, device=u.device) * erf_inv(u)
            ).reshape(shape)
