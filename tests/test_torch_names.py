"""The reference's public names that the port adds last, held against the
JAX package on the CPU (where every wrapper takes its kernel's plain
version): ``config.BLOCK_KINDS``, ``kernels/ops.py`` ``seal_weights`` and
``decrypt_then_matmul``, ``core/coloe.py::coloe_pack``,
``kernels/chacha20.py::chacha20_keystream`` and
``kernels/flash_attention.py::flash_attention``.

u32 data (ciphertext, packed records, keystreams) compare bitwise. The
unfused product compares bitwise on inputs whose f32 sums are exact in any
order (small integers against multiples of 1/8), so that the order of
XLA's and PyTorch's sums cannot part them, and within 1e-6 of its scale
on normal draws. Flash attention is held to the reference's ``_sdpa``
oracle at ``tests/test_torch_flash.py``'s f32 tolerance (2e-5): the
reference's Pallas kernel does not run on this jax.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as JCFG
import repro.core.coloe as JCL
import repro.kernels.chacha20 as JCC
import repro.kernels.ops as JO
import repro.models.layers as JL
import repro_torch.config as TCFG
import repro_torch.core.coloe as TCL
import repro_torch.kernels.chacha20 as TCC
import repro_torch.kernels.flash_attention as TFA
import repro_torch.kernels.ops as TO
from repro_torch import u32


def _u32(rng, shape):
    return rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _key_nonce(rng):
    return _u32(rng, 8), _u32(rng, 3)


def test_block_kinds_are_the_reference_s():
    assert TCFG.BLOCK_KINDS == JCFG.BLOCK_KINDS


SEALS = [(128, 256, 128, 128, None, 0), (64, 128, 32, 64, 0.5, 3),
         (96, 64, 32, 16, 0.0, 7)]


def _sealed_case(k, n, bk, bn, ratio, wc, seed):
    rng = np.random.RandomState(seed)
    key, nonce = _key_nonce(rng)
    w = rng.standard_normal((k, n)).astype(np.float32)
    mask = None if ratio is None else rng.random_sample(k) < ratio
    return rng, key, nonce, w, mask


@pytest.mark.parametrize("k,n,bk,bn,ratio,wc", SEALS)
def test_seal_weights_bitwise(k, n, bk, bn, ratio, wc):
    _, key, nonce, w, mask = _sealed_case(k, n, bk, bn, ratio, wc, k + n)
    want = JO.seal_weights(jnp.asarray(w), jnp.asarray(key),
                           jnp.asarray(nonce), bk=bk, bn=bn,
                           row_mask=None if mask is None
                           else jnp.asarray(mask), write_counter=wc)
    got = TO.seal_weights(torch.from_numpy(w), u32.words(key),
                          u32.words(nonce), bk=bk, bn=bn,
                          row_mask=None if mask is None
                          else torch.from_numpy(mask), write_counter=wc)
    assert got.dtype == torch.int32 and got.shape == (k, n)
    np.testing.assert_array_equal(u32.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("k,n,bk,bn,ratio,wc", SEALS)
def test_decrypt_then_matmul_matches_reference(k, n, bk, bn, ratio, wc,
                                               exact):
    rng, key, nonce, w, mask = _sealed_case(k, n, bk, bn, ratio, wc, k * n)
    x = rng.standard_normal((24, k)).astype(np.float32)
    if exact:
        w = (rng.randint(-32, 33, (k, n)) / 8).astype(np.float32)
        x = rng.randint(-4, 5, (24, k)).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ct = JO.seal_weights(jnp.asarray(w), jnp.asarray(key),
                         jnp.asarray(nonce), bk=bk, bn=bn, row_mask=jm,
                         write_counter=wc)
    want = np.asarray(JO.decrypt_then_matmul(
        jnp.asarray(x), ct, jm, jnp.asarray(key), jnp.asarray(nonce), wc,
        bk=bk, bn=bn))
    got = TO.decrypt_then_matmul(
        torch.from_numpy(x), u32.words(np.asarray(ct)), tm, u32.words(key),
        u32.words(nonce), wc, bk=bk, bn=bn)
    assert got.dtype == torch.float32 and got.shape == (24, n)
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want, x @ w)
    else:
        scale = float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= 1e-6 * scale


def test_coloe_pack_bitwise():
    rng = np.random.RandomState(7)
    data, ctr, flags = _u32(rng, (37, 32)), _u32(rng, 37), _u32(rng, 37) & 1
    want = np.asarray(JCL.coloe_pack(jnp.asarray(data), jnp.asarray(ctr),
                                     jnp.asarray(flags)))
    got = TCL.coloe_pack(u32.words(data), u32.words(ctr), u32.words(flags))
    assert got.dtype == torch.int32 and got.shape == (37, 34)
    np.testing.assert_array_equal(u32.to_numpy(got), want)
    back = TCL.coloe_unpack(got)
    for part, wanted in zip(back, (data, ctr, flags)):
        np.testing.assert_array_equal(u32.to_numpy(part), wanted)


@pytest.mark.parametrize("per_block", [False, True])
def test_chacha20_keystream_bitwise(per_block):
    """The reference's argument order (key, nonce, counters); counters that
    wrap mod 2^32; the reference's Pallas kernel in interpret mode."""
    rng = np.random.RandomState(11)
    key = _u32(rng, 8)
    n = 256
    ctr = ((np.arange(n, dtype=np.uint64) + 2**32 - 100) % 2**32) \
        .astype(np.uint32)
    nonce = _u32(rng, 3)
    want = np.asarray(JCC.chacha20_keystream(
        jnp.asarray(key), jnp.asarray(nonce), jnp.asarray(ctr)))
    if per_block:     # the port also takes one nonce a block
        nonce = np.tile(nonce, (n, 1))
    got = TCC.chacha20_keystream(u32.words(key), u32.words(nonce),
                                 u32.words(ctr))
    assert got.shape == (16, n)
    np.testing.assert_array_equal(u32.to_numpy(got), want)


@pytest.mark.parametrize("b,s,hq,hkv,dh,win,cap", [
    (2, 128, 4, 2, 32, 0, 0.0),
    (1, 256, 8, 1, 32, 64, 50.0),
])
def test_flash_attention_matches_reference_oracle(b, s, hq, hkv, dh, win,
                                                  cap):
    rng = np.random.RandomState(s + dh)
    q = rng.standard_normal((b, s, hq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
            for _ in range(2))
    pos = jnp.arange(s, dtype=jnp.int32)
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    JL._attn_mask(pos, pos, win), cap, dh ** -0.5)
    got = TFA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=dh ** -0.5,
                              softcap=cap, window=win)
    assert TO.flash_attention is TFA.flash_attention
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
