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


# --------------------------------------------------------------------------
# the kernel's tables, as csrc/aes128.cu stages and indexes them
# --------------------------------------------------------------------------

REGION_WORDS = 16384            # a 64 KB region: 256 entries x 2 slots x 32


def _staged(inverse):
    """The words of the kernel's dynamic shared memory (``stage``): word w
    is lane w % 32 of entry (w >> 6) % 256 of slot 2 (w >> 14) + (w >> 5) %
    2; slots 0..3 are T0..T3, slot 4 the inverse S-box (inverse cipher
    only); other words are never read."""
    tab = AES.kernel_tables("cpu")[int(inverse)].to(torch.int64) & 0xFFFFFFFF
    slots = 4 + int(inverse)
    w = torch.arange((slots + 1) // 2 * REGION_WORDS)
    slot = 2 * (w >> 14) + ((w >> 5) & 1)
    img = tab[slot.clamp(max=4), (w >> 6) & 255]
    return torch.where(slot < slots, img, torch.full_like(img, -1))


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm`` on int64 tensors of u32 values."""
    out = torch.zeros_like(x)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        src = x if k < 4 else y
        out |= ((src >> (8 * (k & 3))) & 0xFF) << (8 * n)
    return out


def _mirror(blocks, rk, inverse):
    """The kernel's rounds (``cipher``) on (n, 16) uint8 blocks, block b on
    lane b % 32, every lookup checked to fall in its lane's bank."""
    img = _staged(inverse)
    n = blocks.shape[0]
    lane4 = 4 * (torch.arange(n) % 32)

    def entry(w, j):
        return _byte_perm(w, lane4, 0x5504 | (j << 4))

    def lookup(e, slot):
        word = (e + (slot >> 1) * REGION_WORDS * 4 + (slot & 1) * 128) >> 2
        assert bool((word % 32 == lane4 // 4).all())     # no bank conflict
        got = img[word]
        assert bool((got >= 0).all())                    # a staged word
        return got

    rkw = rk.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    keys = rkw.reshape(11, 4)
    if inverse:                  # the equivalent inverse cipher's keys
        mixed = AES._inv_mix_columns(AES._tables("cpu"), rk[1:10])
        keys = keys.clone()
        keys[1:10] = (mixed.contiguous().view(torch.int32).to(torch.int64)
                      & 0xFFFFFFFF).reshape(9, 4)
    d = 3 if inverse else 1
    s = [(blocks.contiguous().view(torch.int32).to(torch.int64)
          & 0xFFFFFFFF).reshape(n, 4)[:, c] for c in range(4)]
    k = keys[10 if inverse else 0]
    s = [s[c] ^ k[c] for c in range(4)]
    for r in range(1, 10):
        k = keys[10 - r if inverse else r]
        s = [lookup(entry(s[c], 0), 0) ^ lookup(entry(s[(c + d) % 4], 1), 1)
             ^ lookup(entry(s[(c + 2 * d) % 4], 2), 2)
             ^ lookup(entry(s[(c + 3 * d) % 4], 3), 3) ^ k[c]
             for c in range(4)]
    k = keys[0 if inverse else 10]
    slot, p = (4, 0) if inverse else (0, 1)
    out = []
    for c in range(4):
        w = [lookup(entry(s[(c + j * d) % 4], j), slot) for j in range(4)]
        lo = _byte_perm(w[0], w[1], p | ((p + 4) << 4))
        hi = _byte_perm(w[2], w[3], p | ((p + 4) << 4))
        out.append(_byte_perm(lo, hi, 0x5410) ^ k[c])
    words = torch.stack(out, dim=1)
    return torch.from_numpy(words.numpy().astype(np.uint32).view(np.uint8)
                            ).reshape(n, 16)


def test_kernel_tables_are_the_reference_t_tables():
    """Te0/Td0 from the reference's S-boxes and GF(2^8) products, Tj their
    8j-bit rotations, row 4 the S-box of the direction."""
    t = u32.to_numpy(AES.kernel_tables("cpu"))
    assert t.shape == (2, 5, 256)
    s, inv = TC.SBOX.astype(np.uint32), TC._INV_SBOX.astype(np.uint32)
    mul = {m: np.array([TC._gf_mul(x, m) for x in range(256)], np.uint32)
           for m in (2, 3, 9, 11, 13, 14)}
    te0 = mul[2][s] | (s << 8) | (s << 16) | (mul[3][s] << 24)
    td0 = (mul[14][inv] | (mul[9][inv] << 8) | (mul[13][inv] << 16)
           | (mul[11][inv] << 24))
    for d, (t0, box) in enumerate(((te0, s), (td0, inv))):
        for j in range(4):
            rot = (t0.astype(np.uint64) << (8 * j)) | (t0 >> (32 - 8 * j)
                                                       if j else 0)
            np.testing.assert_array_equal(t[d, j], rot.astype(np.uint32))
        np.testing.assert_array_equal(t[d, 4], box)


@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_table_rounds_match_reference(inverse):
    """A mirror of the kernel's rounds over its staged, bank-replicated
    tables (byte-permute entries, four lookups a column, the last round's
    S-box bytes joined by byte permutes) equals the reference's AES,
    bitwise, on 256 blocks, and inverts the other direction; every lookup
    lands in its lane's bank."""
    rng = np.random.RandomState(41 + int(inverse))
    blocks = rng.randint(0, 256, (256, 16)).astype(np.uint8)
    rk = JC.aes128_key_schedule(rng.randint(0, 256, 16).astype(np.uint8))
    rkt = torch.from_numpy(np.array(rk))
    ref = JC.aes128_decrypt_blocks if inverse else JC.aes128_encrypt_blocks
    back = JC.aes128_encrypt_blocks if inverse else JC.aes128_decrypt_blocks
    want = np.asarray(ref(jnp.asarray(blocks), rk))
    got = _mirror(torch.from_numpy(blocks), rkt, inverse)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(back(jnp.asarray(got.numpy()), rk)), blocks)


def test_kernel_table_rounds_fips197_vector():
    """The mirror of the kernel's rounds on FIPS-197 appendix C.1, both
    ways."""
    rk = torch.from_numpy(np.array(JC.aes128_key_schedule(
        np.arange(16, dtype=np.uint8))))
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       np.uint8)[None]
    ct = _mirror(torch.from_numpy(pt.copy()), rk, False)
    assert bytes(ct.numpy().reshape(-1)) == bytes.fromhex(
        "69c4e0d86a7b0430d8cdb78070b4c55a")
    np.testing.assert_array_equal(_mirror(ct, rk, True).numpy(), pt)
