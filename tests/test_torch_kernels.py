"""The port's ChaCha20 layer (``core.cipher``, ``kernels.chacha20``,
``kernels.ref``) held against the JAX package on the CPU, where every
wrapper takes its kernel's plain PyTorch version. Keystreams, counters and
ciphertext are u32 data and compare bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cipher as JC
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch import u32
from repro_torch.core import cipher as TC
from repro_torch.kernels import chacha20 as TCC
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

KEY = np.frombuffer(bytes(range(32)), np.uint32).copy()


def _u32(rng, shape):
    return rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n,per_block,start", [(1, False, 0),
                                               (16, True, 2**32 - 5),
                                               (257, False, 2**32 - 5),
                                               (257, True, 0)])
def test_chacha_block_bitwise(n, per_block, start):
    """Shared and per-block nonces, and counters that wrap mod 2^32."""
    rng = np.random.RandomState(n)
    key = _u32(rng, 8)
    nonce = _u32(rng, (n, 3) if per_block else 3)
    ctr = ((np.arange(n, dtype=np.uint64) + start) % 2**32).astype(np.uint32)
    want = np.asarray(JC.chacha20_block(jnp.asarray(key), jnp.asarray(ctr),
                                        jnp.asarray(nonce)))
    got = TC.chacha20_block(u32.words(key), u32.words(ctr), u32.words(nonce))
    assert got.dtype == torch.int32 and got.shape == (n, 16)
    np.testing.assert_array_equal(u32.to_numpy(got), want)


def test_chacha_rfc7539_vector():
    """RFC 7539 §2.3.2 test vector through the port's plain rounds."""
    key = np.frombuffer(bytes(range(32)), np.uint32)
    nonce = np.frombuffer(bytes([0, 0, 0, 9, 0, 0, 0, 0x4a, 0, 0, 0, 0]),
                          np.uint32)
    out = TCC.chacha20_blocks_plain(u32.words(key), u32.words([1]),
                                    u32.words(nonce))
    assert u32.to_numpy(out)[0, :4].tolist() == [
        0xe4e7f110, 0x15593bd1, 0x1fdd0f50, 0xc47120a3]


def test_keystream_u32_matches_reference():
    rng = np.random.RandomState(1)
    nonce = _u32(rng, 3)
    want = np.asarray(JC.chacha20_keystream_u32(jnp.asarray(KEY), 100,
                                                jnp.asarray(nonce), 7))
    got = TC.chacha20_keystream_u32(u32.words(KEY), 100, u32.words(nonce), 7)
    np.testing.assert_array_equal(u32.to_numpy(got), want)


@pytest.mark.parametrize("n_blocks,counter0", [(96, 0), (300, 64)])
def test_ops_keystream_matches_oracle(n_blocks, counter0):
    nonce = np.array([7, 11, 13], np.uint32)
    got = TO.keystream(u32.words(KEY), u32.words(nonce), n_blocks,
                       counter0=counter0)
    want = JR.chacha20_keystream_ref(
        jnp.asarray(KEY), jnp.asarray(nonce),
        jnp.arange(counter0, counter0 + n_blocks, dtype=jnp.uint32))
    assert got.shape == (16, n_blocks)
    np.testing.assert_array_equal(u32.to_numpy(got), np.asarray(want))
    own = TR.chacha20_keystream_ref(
        u32.words(KEY), u32.words(nonce),
        u32.words(np.arange(counter0, counter0 + n_blocks)))
    assert torch.equal(got, own)


def test_ops_keystream_matches_pallas_interpret():
    """One case against the Pallas kernel itself, in interpret mode."""
    nonce = np.array([3, 5, 8], np.uint32)
    want = JO.keystream(jnp.asarray(KEY), jnp.asarray(nonce), 40, tile=64,
                        counter0=32, interpret=True)
    got = TO.keystream(u32.words(KEY), u32.words(nonce), 40, counter0=32)
    np.testing.assert_array_equal(u32.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("k,n,bk,bn,wc", [(64, 32, 32, 16, 0),
                                          (128, 64, 64, 8, 3),
                                          (32, 256, 16, 128, 7)])
def test_tile_seal_unseal_bitwise(k, n, bk, bn, wc):
    rng = np.random.RandomState(k + n)
    w = rng.randn(k, n).astype(np.float32)
    mask = rng.rand(k) < 0.5
    nonce = _u32(rng, 3)
    ctr_j, lane_j = JR.tile_counters(k, n, bk, bn, wc)
    ctr_t, lane_t = TR.tile_counters(k, n, bk, bn, wc)
    np.testing.assert_array_equal(ctr_t, ctr_j)
    np.testing.assert_array_equal(lane_t, lane_j)
    want = np.asarray(JR.seal_weights_ref(
        jnp.asarray(w), jnp.asarray(KEY), jnp.asarray(nonce), bk, bn,
        jnp.asarray(mask), wc))
    ct = TR.seal_weights_ref(torch.from_numpy(w), u32.words(KEY),
                             u32.words(nonce), bk, bn, torch.from_numpy(mask),
                             wc)
    np.testing.assert_array_equal(u32.to_numpy(ct), want)
    back = TR.unseal_weights_ref(ct, u32.words(KEY), u32.words(nonce), bk,
                                 bn, torch.from_numpy(mask), wc)
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  w.view(np.uint32))


def test_cache_block_otp_bitwise():
    rng = np.random.RandomState(4)
    nonce3 = tuple(int(v) for v in _u32(rng, 3))
    bids = rng.randint(0, 50, (3, 2))
    wcs = _u32(rng, (1, 2))
    lids = _u32(rng, (3, 1))
    for wpb in (40, 64):
        want = np.asarray(JR.cache_block_otp(
            jnp.asarray(KEY), nonce3, jnp.asarray(bids), jnp.asarray(wcs),
            jnp.asarray(lids), wpb))
        got = TR.cache_block_otp(u32.words(KEY), nonce3, torch.from_numpy(bids),
                                 u32.words(wcs), u32.words(lids), wpb)
        assert got.shape == (3, 2, wpb)
        np.testing.assert_array_equal(u32.to_numpy(got), want)


def test_launch_counts_untouched_on_cpu():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    TO.reset_launch_counts()
    TO.keystream(u32.words(KEY), u32.words([1, 2, 3]), 4)
    q = torch.zeros((1, 5, 2, 8))
    TO.flash_attention(q, q, q, scale=1.0)
    lines = torch.zeros((3, 34), dtype=torch.int32)
    TO.lines_unseal(u32.words(KEY), lines, None, 90, (1, 2))
    TO.lines_gather_rows(u32.words(KEY), lines, None, (1, 2), (6, 16),
                         torch.float32, torch.tensor([[0, 5]]),
                         torch.bfloat16)
    pool = torch.zeros((2, 4, 32), dtype=torch.int32)
    lids, wc = torch.arange(2, dtype=torch.int32), torch.zeros(
        (4,), dtype=torch.int32)
    blocks, live = torch.tensor([1, 2]), torch.tensor([True, False])
    TO.cache_copy(u32.words(KEY), (1, 2, 3), (4, 5, 6), pool, pool.clone(),
                  lids, blocks, torch.tensor([3, 0]), live, wc)
    TO.cache_tags(u32.words(KEY), torch.ones((64,), dtype=torch.int32),
                  (1, 2, 3), (4, 5, 6), pool, pool, lids, blocks, live, wc)
    TO.cache_verify(u32.words(KEY), torch.ones((64,), dtype=torch.int32),
                    (1, 2, 3), (4, 5, 6), pool, pool, wc[None].repeat(2, 1),
                    wc[None].repeat(2, 1), lids, torch.tensor([[1, 2]]),
                    torch.tensor([5]), wc, 4)
    ct = torch.zeros((2, 16, 8), dtype=torch.int32)
    TO.tile_tags(u32.words(KEY), torch.ones((128,), dtype=torch.int32),
                 (1, 2, 3), ct, torch.ones((2, 16), dtype=torch.bool),
                 lids, 8, 8)
    TO.line_tags(u32.words(KEY), torch.ones((68,), dtype=torch.int32),
                 (1, 2, 3), lines, None)
    rk = torch.zeros((11, 16), dtype=torch.uint8)
    ct = TO.aes128_lines_encrypt(rk, torch.arange(40, dtype=torch.int32),
                                 None)
    TO.aes128_lines_decrypt(rk, ct, None, 40)
    assert TO.launch_counts() == {"chacha20": 0, "sealed_matmul": 0,
                                  "sealed_matmul_tc": 0,
                                  "sealed_matmul_dec": 0,
                                  "flash_attention": 0,
                                  "flash_attention_tc": 0,
                                  "flash_attention_tc256": 0,
                                  "chacha20_cache_view": 0,
                                  "chacha20_cache_splice": 0,
                                  "chacha20_cache_copy": 0,
                                  "chacha20_cache_tags": 0,
                                  "chacha20_cache_verify": 0,
                                  "chacha20_lines_unseal": 0,
                                  "chacha20_lines_gather": 0,
                                  "chacha20_weight_tile_tags": 0,
                                  "chacha20_weight_line_tags": 0,
                                  "aes128_lines_encrypt": 0,
                                  "aes128_lines_decrypt": 0}
