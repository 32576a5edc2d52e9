"""The port's AES-128 (``core/cipher.py``'s AES half, ``kernels/aes128.py``)
and Direct engine (``core/engine.py::DirectEngine``) held against the JAX
package on the CPU, where every route takes its plain version.

Tolerance: none. Blocks, round keys, keystreams, ciphertext lines, flags
and decrypted tensors compare bitwise, on inputs made from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cipher as JC
from repro.core import engine as JE
from repro_torch import u32
from repro_torch.core import cipher as TC
from repro_torch.core import engine as TE
from repro_torch.kernels import aes128 as AES
from repro_torch.kernels import ops

KEY = bytes(range(32))

# FIPS-197 appendix C.1
FIPS_KEY = bytes(range(16))
FIPS_PT = bytes.fromhex("00112233445566778899aabbccddeeff")
FIPS_CT = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")


def _bytes(b):
    return torch.frombuffer(bytearray(b), dtype=torch.uint8)


def test_sbox_and_fips197_vector():
    np.testing.assert_array_equal(TC.SBOX, JC.SBOX)
    np.testing.assert_array_equal(TC._INV_SBOX, JC._INV_SBOX)
    rk = TC.aes128_key_schedule(np.frombuffer(FIPS_KEY, np.uint8))
    ct = TC.aes128_encrypt_blocks(_bytes(FIPS_PT).reshape(1, 16), rk)
    assert bytes(ct.reshape(-1).tolist()) == FIPS_CT
    pt = TC.aes128_decrypt_blocks(ct, rk)
    assert bytes(pt.reshape(-1).tolist()) == FIPS_PT


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_key_schedule_matches_reference(seed):
    key = np.random.RandomState(seed).randint(0, 256, 16).astype(np.uint8)
    got = TC.aes128_key_schedule(key)
    assert got.shape == (11, 16) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, JC.aes128_key_schedule(key))


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_blocks_match_reference(n):
    rng = np.random.RandomState(n)
    blocks = rng.randint(0, 256, (n, 16)).astype(np.uint8)
    rk = JC.aes128_key_schedule(rng.randint(0, 256, 16).astype(np.uint8))
    want_ct = np.asarray(JC.aes128_encrypt_blocks(jnp.asarray(blocks), rk))
    got_ct = TC.aes128_encrypt_blocks(torch.from_numpy(blocks), rk)
    np.testing.assert_array_equal(got_ct.numpy(), want_ct)
    want_pt = np.asarray(JC.aes128_decrypt_blocks(jnp.asarray(want_ct), rk))
    got_pt = TC.aes128_decrypt_blocks(got_ct, rk)
    np.testing.assert_array_equal(got_pt.numpy(), want_pt)
    np.testing.assert_array_equal(got_pt.numpy(), blocks)


@pytest.mark.parametrize("tweak", [0, 0x0123456789ABCDEF])
def test_ctr_keystream_matches_reference(tweak):
    rng = np.random.RandomState(tweak & 0xFFFF)
    rk = JC.aes128_key_schedule(rng.randint(0, 256, 16).astype(np.uint8))
    ids = rng.randint(0, 2**32, 37, dtype=np.uint64).astype(np.uint32)
    ids[0] = 0xFFFFFFFF
    want = JC.aes128_ctr_keystream(rk, jnp.asarray(ids), tweak)
    got = TC.aes128_ctr_keystream(rk, u32.words(ids), tweak)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_derive_nonce_matches_reference():
    for tid in (0, 5, 2**31 + 7, 2**40 + 3):
        np.testing.assert_array_equal(TC.derive_nonce(tid),
                                      JC.derive_nonce(tid))


def _leaf(dtype, shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype,shape", [
    ("float32", (9, 40)), ("float32", (7, 33)), ("bfloat16", (5, 27)),
    ("bfloat16", (1, 1))], ids=str)
@pytest.mark.parametrize("flags", ["none", "mixed", "bypass"])
def test_direct_engine_matches_reference(dtype, shape, flags):
    """Payload, flags, ``orig_len`` and meta of a Direct leaf bitwise the
    reference's (f32 and odd-length bf16, lines enciphered, mixed and all
    bypassed), the plain line functions equal to the engine, and the
    decrypt exact."""
    xj, xt = _leaf(dtype, shape, sum(shape))
    n_lines = -(-(xt.numel() * xt.element_size()) // 128)
    rng = np.random.RandomState(n_lines)
    fl = {"none": None, "mixed": (rng.rand(n_lines) < 0.5) | (
              np.arange(n_lines) == 0),
          "bypass": np.zeros(n_lines, bool)}[flags]
    ej, et = JE.make_engine("direct", KEY), TE.make_engine("direct", KEY)
    np.testing.assert_array_equal(et.round_keys.numpy(), ej.round_keys)
    sj = ej.encrypt(xj, enc_flags=None if fl is None
                    else jnp.asarray(fl, jnp.uint32))
    st = et.encrypt(xt, nonce2=(5, 9), enc_flags=None if fl is None
                    else torch.from_numpy(fl.astype(np.int32)))
    assert (st.scheme, st.orig_len, st.shape, st.nonce2) == \
        (sj.scheme, sj.orig_len, sj.shape, sj.nonce2) == \
        ("direct", sj.orig_len, tuple(shape), (0, 0))
    np.testing.assert_array_equal(u32.to_numpy(st.payload),
                                  np.asarray(sj.payload))
    np.testing.assert_array_equal(u32.to_numpy(st.counters),
                                  np.asarray(sj.counters))
    assert st.stored_bytes() == sj.stored_bytes() == n_lines * 128
    assert st.extra_streams() == sj.extra_streams() == 1
    words = TE.tensor_to_words(xt)[0]
    assert torch.equal(AES.lines_encrypt_plain(et.round_keys, words,
                                               st.counters), st.payload)
    back = et.decrypt(st)
    assert back.dtype == xt.dtype and back.shape == xt.shape
    assert torch.equal(back.view(torch.int16 if dtype == "bfloat16"
                                 else torch.int32),
                       xt.view(torch.int16 if dtype == "bfloat16"
                               else torch.int32))
    if flags == "bypass":                       # stored verbatim
        assert torch.equal(st.payload.reshape(-1)[:st.orig_len], words)


@pytest.mark.parametrize("orig_len", [1, 3, 31, 32, 33, 95])
def test_lines_decrypt_cuts_to_orig_len(orig_len):
    """Any ``orig_len``, a multiple of neither 32 nor 4: the words before it
    come back, nothing after."""
    rng = np.random.RandomState(orig_len)
    words = u32.words(rng.randint(0, 2**32, orig_len, dtype=np.uint64))
    rk = TC.round_keys_tensor(JC.aes128_key_schedule(
        rng.randint(0, 256, 16).astype(np.uint8)))
    flags = torch.tensor([1, 0, 1][:-(-orig_len // 32)], dtype=torch.int32)
    ct = ops.aes128_lines_encrypt(rk, words, flags)
    assert ct.shape == (-(-orig_len // 32), 32)
    assert torch.equal(ops.aes128_lines_decrypt(rk, ct, flags, orig_len),
                       words)


def test_direct_is_deterministic_dictionary_attackable():
    """Counterpart of ``test_engine.py``'s: equal plaintext lines give equal
    ciphertext lines under Direct, not under the counter-mode engines."""
    x = torch.zeros((64,), dtype=torch.float32)  # two identical 128 B lines
    s = TE.make_engine("direct", KEY).encrypt(x)
    assert torch.equal(s.payload[0], s.payload[1])
    assert not torch.equal(s.payload[0], x.view(torch.int32)[:32])
    for mode in ["counter", "coloe"]:
        data = TE.make_engine(mode, KEY).encrypt(x).payload[:, :32]
        assert not torch.equal(data[0], data[1])


def test_direct_line_record_and_macs_match_reference():
    """The flag word rides after each line's 32 words in the MAC message,
    as in the reference; tags and verdicts bitwise; a flipped flag fails
    its line only."""
    rng = np.random.RandomState(5)
    x = rng.randn(9, 40).astype(np.float32)
    flags = (rng.rand(12) < 0.5).astype(np.uint32)
    ej, et = JE.make_engine("direct", KEY), TE.make_engine("direct", KEY)
    sj = ej.encrypt(jnp.asarray(x), enc_flags=jnp.asarray(flags))
    st = et.encrypt(torch.from_numpy(x),
                    enc_flags=torch.from_numpy(flags.astype(np.int32)))
    tweak = (3, 2**32 - 1, 0)
    np.testing.assert_array_equal(u32.to_numpy(et.line_record(st)),
                                  np.asarray(ej.line_record(sj)))
    macs = et.line_macs(st, tweak)
    np.testing.assert_array_equal(u32.to_numpy(macs),
                                  np.asarray(ej.line_macs(sj, tweak)))
    assert bool(et.verify_lines(st, macs, tweak).all())
    st.counters[4] ^= 1
    ok = et.verify_lines(st, macs, tweak)
    assert ok.tolist() == [i != 4 for i in range(ok.shape[0])]


def test_engine_protocol_is_shared():
    """The line-record MAC hooks live once, on ``EngineProtocol``; Direct
    has no tile or cache-block layout."""
    for cls in (TE.DirectEngine, TE.CounterEngine, TE.ColoEEngine):
        assert issubclass(cls, TE.EngineProtocol)
        for hook in ("line_record", "line_macs", "verify_lines"):
            assert getattr(cls, hook) is getattr(TE.EngineProtocol, hook)
    eng = TE.make_engine("direct", KEY)
    assert not eng.supports_fused
    for call in (lambda: eng.encrypt_tiles(None, None, None, 0, 8, 8),
                 lambda: eng.decrypt_tiles(None, None, None, 0, 8, 8),
                 lambda: eng.seal_cache_blocks(None, None, None, None, None)):
        with pytest.raises(NotImplementedError):
            call()
