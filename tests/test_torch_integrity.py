"""Integrity of the port's sealed KV cache (``core/mac.py``, the MAC branches
of ``models/paged.py``, ``ServeEngine(verify=True)``,
``core/security/tamper.py``, ``runtime/fault.py``) held against the JAX
package on the CPU.

Tolerances: none. Hash keys, hashes, pads and tags compare bitwise as u32
words (lengths 1, 16 and 8,192, with 0xFFFFFFFF and bit-31 words); the
cache's MAC words, verdicts and the plain ``cache_tags`` bitwise; greedy
token streams and the engines' integrity stats (``mac_checks``,
``mac_failures``, ``retries``) exactly, the cross-framework streams in f32
(XLA and PyTorch sum in different orders, so bf16 roundings could flip a
near-tied argmax between the two frameworks).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import mac as JM
from repro.core import sealed_store as JSS
from repro.core.security.tamper import TamperInjector as JTamperInjector
from repro.models import cache as JMC
from repro.models import paged as JPG
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import u32
from repro_torch.config import SealConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import mac as TM
from repro_torch.core import sealed_store as TSS
from repro_torch.core.security.tamper import (FAULT_KINDS, TamperInjector,
                                               make_injectors)
from repro_torch.kernels import chacha20 as CC
from repro_torch.models import cache as TMC
from repro_torch.models import paged as TPG
from repro_torch.runtime.fault import (Heartbeat, StepWatchdog,
                                       StragglerTimeout, retry)
from repro_torch.serve.engine import ServeEngine, StragglerTimeout as ESTO

KEY = bytes(range(32))


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_chacha():
    """The reference's ``fori_loop`` ChaCha recompiles at every eager call;
    the same function under ``jax.jit`` is cached per shape. Integer-only,
    so the reference's words are unchanged."""
    from repro.core import cipher as JC
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "chacha20_block", jax.jit(JC.chacha20_block))
        yield


def _u32(rng, shape):
    return rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _edge_words(rng, shape):
    """Random words with 0xFFFFFFFF, 0, and bit-31 words planted."""
    w = _u32(rng, shape).reshape(-1)
    w[0] = 0xFFFFFFFF
    w[-1] = 0x80000000
    w[len(w) // 2] = 0
    w[1::7] |= np.uint32(0x80000000)
    return w.reshape(shape)


# --------------------------------------------------------------------------
# core/mac.py
# --------------------------------------------------------------------------

def test_fold_and_mul_mod_match_reference():
    vals = np.array([0, 1, TM.P31 - 1, TM.P31, TM.P31 + 1, 2**31,
                     2**32 - 1, 0x9E3779B9], np.uint32)
    want = np.asarray(JM._fold(jnp.asarray(vals)))
    got = TM._fold(torch.from_numpy(vals.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    a = np.array([0, 1, TM.P31 - 1, 12345678, 2**30], np.uint32)[:, None]
    b = np.array([0, 1, 0xFFFF, 0x8000], np.uint32)[None, :]
    want = np.asarray(JM._mul_mod(jnp.asarray(a), jnp.asarray(b)))
    got = TM._mul_mod(torch.from_numpy(a.astype(np.int64)),
                      torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the u32 construction computes the exact product mod p
    np.testing.assert_array_equal(
        got.numpy(), (a.astype(np.int64) * b.astype(np.int64)) % TM.P31)


@pytest.mark.parametrize("n", [1, 16, 8192])
def test_uhash_keys_pads_and_tags_match_reference(n):
    rng = np.random.RandomState(n)
    words = _edge_words(rng, (3, n))
    hk = TM._hash_keys_host(KEY, 2 * n)
    np.testing.assert_array_equal(hk, JM._hash_keys_host(KEY, 2 * n))
    assert hk.min() >= 1 and hk.max() < TM.P31
    got = TM.uhash(torch.from_numpy(hk.view(np.int32)), u32.words(words))
    want = JM.uhash(jnp.asarray(hk), jnp.asarray(words))
    np.testing.assert_array_equal(u32.to_numpy(got), np.asarray(want))
    addrs = np.array([0, 5, 2**31 + 3], np.int64)
    wcs = np.array([0, 7, 2**32 - 1], np.uint32)
    nonce = (0x12345678, 2**32 - 1, 7)
    kw = JM.mac_context(KEY, "kvcache").key_words
    want = JM.mac_pads(kw, nonce, jnp.asarray(addrs.astype(np.uint32)),
                       jnp.asarray(wcs), 3)
    got = TM.mac_pads(u32.words(np.asarray(kw)), nonce,
                      torch.from_numpy(addrs), u32.words(wcs), 3)
    np.testing.assert_array_equal(u32.to_numpy(got), np.asarray(want))
    cj = JM.mac_context(KEY, "kvcache")
    ct = TM.mac_context(KEY, "kvcache", "cpu")
    assert ct.nonce3 == cj.nonce3
    tweak = (1, 2**32 - 2, 3)
    want = cj.tags(jnp.asarray(words), jnp.asarray([1, 2, 3]),
                   jnp.asarray(wcs), 9, tweak=tweak)
    got = ct.tags(u32.words(words), torch.tensor([1, 2, 3]), u32.words(wcs),
                  9, tweak=tweak)
    np.testing.assert_array_equal(u32.to_numpy(got), np.asarray(want))


def test_tag_binds_message_address_counter_layer_tweak():
    """Port of the reference's binding check: a flipped bit, another
    address, counter, layer, tweak or domain changes the tag."""
    ctx = TM.mac_context(KEY, "kvcache", "cpu")
    ct = u32.words(_u32(np.random.RandomState(0), (2, 64)))
    addrs = torch.arange(2)
    t0 = ctx.tags(ct, addrs, 3, 1)
    assert torch.equal(t0, ctx.tags(ct, addrs, 3, 1))
    flip = ct.clone()
    flip[0, 17] ^= 1
    tf = ctx.tags(flip, addrs, 3, 1)
    assert tf[0] != t0[0] and tf[1] == t0[1]
    for other in (ctx.tags(ct, addrs + 1, 3, 1), ctx.tags(ct, addrs, 4, 1),
                  ctx.tags(ct, addrs, 3, 2),
                  ctx.tags(ct, addrs, 3, 1, tweak=(0, 0, 5)),
                  TM.mac_context(KEY, "weights", "cpu").tags(ct, addrs, 3,
                                                             1)):
        assert not torch.equal(t0, other)


# --------------------------------------------------------------------------
# the cache's MAC words
# --------------------------------------------------------------------------

def _cfgs(dtype="float32"):
    return (jget_reduced("internlm2_1_8b").with_(dtype=dtype),
            get_reduced("internlm2_1_8b").with_(dtype=dtype))


def _seals():
    return (JSS.cache_seal_config(KEY, verify=True),
            TSS.cache_seal_config(KEY, "cpu", verify=True))


def test_cache_tags_plain_matches_reference_tags():
    """``cache_tags_plain`` over two layers, k and v, a list of blocks with
    a dead entry: the reference's ``seal.mac.tags`` with each stream's
    nonce as tweak, 0 where dead."""
    seal_j, seal_t = _seals()
    rng = np.random.RandomState(1)
    n, nb, wpb = 2, 6, 48
    pk, pv = _edge_words(rng, (n, nb, wpb)), _u32(rng, (n, nb, wpb))
    wc = _u32(rng, (nb,))
    wc[2] = 2**32 - 1
    lids = np.array([4, 2**32 - 1], np.uint32)
    blocks = np.array([2, 0, 5, 2], np.int64)
    live = np.array([True, True, False, True])
    got = CC.cache_tags_plain(
        seal_t.mac.key_words, seal_t.mac.hash_keys(wpb),
        *seal_t.mac_nonces(), u32.words(pk), u32.words(pv), u32.words(lids),
        torch.from_numpy(blocks), torch.from_numpy(live), u32.words(wc))
    assert got.shape == (n, 2, 4)
    for s, (pool, nonce) in enumerate(((pk, seal_j.nonce_k),
                                       (pv, seal_j.nonce_v))):
        want = np.asarray(seal_j.mac.tags(
            jnp.asarray(pool[:, blocks]), jnp.asarray(blocks, jnp.uint32),
            jnp.asarray(wc[blocks]), jnp.asarray(lids)[:, None],
            tweak=nonce))
        want = np.where(live, want, 0)
        np.testing.assert_array_equal(u32.to_numpy(got[:, s]), want)


BS, B, MB = 4, 2, 4
NB = 1 + B * MB


def _tables():
    return (1 + np.arange(B * MB)).reshape(B, MB).astype(np.int64)


def _write(cfg_j, cfg_t, seal_j, seal_t, pools_j, pools_t, wc_j, wc_t, rng,
           lengths, counts, c):
    n = cfg_t.n_superblocks()
    shape = (n, B, c, cfg_t.num_kv_heads, cfg_t.head_dim)
    k, v = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    tables = _tables()
    dt = getattr(torch, cfg_t.dtype)
    pools_j, wc_j = JPG.append_tokens(
        cfg_j, seal_j, pools_j,
        ({"k_new": jnp.asarray(k).astype(cfg_j.dtype),
          "v_new": jnp.asarray(v).astype(cfg_j.dtype)},),
        jnp.asarray(tables, jnp.int32), jnp.asarray(lengths, jnp.int32),
        jnp.asarray(counts, jnp.int32), wc_j)
    TPG.append_tokens(cfg_t, seal_t, pools_t,
                      ({"k_new": torch.from_numpy(k).to(dt),
                        "v_new": torch.from_numpy(v).to(dt)},),
                      torch.from_numpy(tables), torch.from_numpy(lengths),
                      torch.from_numpy(counts), wc_t)
    return pools_j, wc_j


def _written_pools(cfg_j, cfg_t, seal_j, seal_t):
    """Both packages' pools after the same chunk writes and decode appends
    (a masked row included), with their write counters."""
    rng = np.random.RandomState(4)
    pools_j = JMC.paged_pool_init(cfg_j, NB, BS)
    pools_t = TMC.paged_pool_init(cfg_t, NB, BS, "cpu")
    wc_j = jnp.zeros((NB,), jnp.uint32)
    wc_t = torch.zeros((NB,), dtype=torch.int32)
    lengths = np.zeros((B,), np.int64)
    for c, counts in ((5, [5, 3]), (5, [4, 0]), (1, [1, 1]), (1, [0, 1])):
        counts = np.asarray(counts, np.int64)
        pools_j, wc_j = _write(cfg_j, cfg_t, seal_j, seal_t, pools_j,
                               pools_t, wc_j, wc_t, rng, lengths, counts, c)
        lengths = lengths + counts
        for key in ("k", "v", "mac_k", "mac_v"):
            np.testing.assert_array_equal(
                u32.to_numpy(pools_t[0][key]), np.asarray(pools_j[0][key]),
                err_msg=key)
        np.testing.assert_array_equal(u32.to_numpy(wc_t), np.asarray(wc_j))
    return pools_j, pools_t, wc_j, wc_t, lengths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_tokens_mac_words_match_reference(dtype):
    """Every write re-tags the blocks it touched under the bumped counter:
    the MAC words (and pool words, counters) bitwise the reference's after
    each write; untouched blocks keep zero tags."""
    cfg_j, cfg_t = _cfgs(dtype)
    _, pools_t, _, _, _ = _written_pools(cfg_j, cfg_t, *_seals())
    assert int((pools_t[0]["mac_k"] != 0).sum()) > 0
    assert int((pools_t[0]["mac_k"][:, 0] != 0).sum()) == 0   # scratch


@pytest.mark.parametrize("tamper", ["none", "resident", "past the length"])
def test_dense_view_verdict_matches_reference(tamper):
    """A layer's verdict (``_verify`` over a one-layer pool) against the
    reference's ``_dense_view`` verdict, over resident blocks only: a
    flipped word in a resident block fails that slot alone; one in a table
    entry past ceil(length / block_size) is not checked."""
    cfg_j, cfg_t = _cfgs()
    seal_j, seal_t = _seals()
    pools_j, pools_t, wc_j, wc_t, lengths = _written_pools(
        cfg_j, cfg_t, seal_j, seal_t)
    tables = _tables()
    if tamper != "none":
        # slot 1 holds 5 tokens: entry 1 is resident, entry 3 is not
        blk = int(tables[1, 1 if tamper == "resident" else 3])
        pools_t[0]["v"][0, blk, 3] ^= u32.const(1 << 31)
        pj = dict(pools_j[0])
        pj["v"] = pj["v"].at[0, blk, 3].set(
            pj["v"][0, blk, 3] ^ np.uint32(1 << 31))
        pools_j = (pj,)
    assert list(lengths) == [10, 5]
    for i in range(cfg_t.n_superblocks()):
        vj, okj = JPG._dense_view(
            cfg_j, seal_j, {k: pools_j[0][k][i] for k in pools_j[0]},
            jnp.asarray(tables, jnp.int32), jnp.asarray(lengths, jnp.int32),
            wc_j)
        vt = TPG._dense_view(
            cfg_t, seal_t, {k: pools_t[0][k][i] for k in pools_t[0]},
            torch.from_numpy(tables), torch.from_numpy(lengths), wc_t)
        okt = TPG._verify(seal_t, {k: pools_t[0][k][i:i + 1]
                                   for k in pools_t[0]},
                          torch.from_numpy(tables),
                          torch.from_numpy(lengths), wc_t, BS)
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        want = [True, not (tamper == "resident" and i == 0)]
        assert okt.tolist() == want
        np.testing.assert_array_equal(vt["k"].numpy(),
                                      np.asarray(vj["k"]))


@pytest.mark.parametrize("tamper", ["none", "layer 0", "last layer",
                                    "past the length"])
def test_cache_verify_plain_is_the_and_of_reference_layer_verdicts(tamper):
    """A pass's one check over every layer (``cache_verify_plain``, and
    ``_verify_pass`` that the decode and chunk passes run) equals the AND
    of the reference's per-layer ``_dense_view`` verdicts: a flipped word in
    a resident block of the first or the last layer fails its slot alone;
    one past the slot's length is not checked."""
    cfg_j, cfg_t = _cfgs()
    seal_j, seal_t = _seals()
    pools_j, pools_t, wc_j, wc_t, lengths = _written_pools(
        cfg_j, cfg_t, seal_j, seal_t)
    tables = _tables()
    n = cfg_t.n_superblocks()
    # slot 0 holds 10 tokens (entries 0-2 resident), slot 1 holds 5 (0-1)
    site = {"layer 0": ("k", 0, 1, 1), "last layer": ("v", n - 1, 0, 2),
            "past the length": ("k", n - 1, 1, 3)}.get(tamper)
    if site is not None:
        key, layer, slot, col = site
        blk = int(tables[slot, col])
        pools_t[0][key][layer, blk, 5] ^= u32.const(1 << 31)
        pj = dict(pools_j[0])
        pj[key] = pj[key].at[layer, blk, 5].set(
            pj[key][layer, blk, 5] ^ np.uint32(1 << 31))
        pools_j = (pj,)
    want = np.ones((B,), bool)
    for i in range(n):
        _, okj = JPG._dense_view(
            cfg_j, seal_j, {k: pools_j[0][k][i] for k in pools_j[0]},
            jnp.asarray(tables, jnp.int32), jnp.asarray(lengths, jnp.int32),
            wc_j)
        want &= np.asarray(okj)
    pt = pools_t[0]
    mac = seal_t.mac
    got = CC.cache_verify_plain(
        mac.key_words, mac.hash_keys(pt["k"].shape[-1]), *seal_t.mac_nonces(),
        pt["k"], pt["v"], pt["mac_k"], pt["mac_v"], pt["lid"],
        torch.from_numpy(tables), torch.from_numpy(lengths), wc_t, BS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == {"none": [True, True], "layer 0": [True, False],
                            "last layer": [False, True],
                            "past the length": [True, True]}[tamper]
    assert torch.equal(TPG._verify_pass(cfg_t, seal_t, pools_t,
                                        torch.from_numpy(tables),
                                        torch.from_numpy(lengths), wc_t), got)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

PROMPT_LENS = (11, 7, 9)
MAX_TOK = 10


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = _cfgs()
    pj = JT.init_params(cfg_j, jax.random.key(0))
    return cfg_j, cfg_t, pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def _prompts(vocab):
    rng = np.random.RandomState(7)
    return [rng.randint(1, vocab, (n,)).astype(np.int32) for n in PROMPT_LENS]


def _serve(cls, cfg, params, *, verify, hooks=(), **kw):
    dev = {} if cls is JServeEngine else {"device": "cpu"}
    eng = cls(cfg, params, batch_slots=2, max_len=48, seal=None,
              seal_cache=True, verify=verify, fault_hooks=hooks, **dev, **kw)
    reqs = [eng.submit(p, max_tokens=MAX_TOK)
            for p in _prompts(cfg.vocab_size)]
    eng.run(max_steps=400)
    return eng, reqs


@pytest.fixture(scope="module")
def baseline(model):
    """The reference's unverified streams, and the port's."""
    cfg_j, cfg_t, pj, pt = model
    _, rj = _serve(JServeEngine, cfg_j, pj, verify=False)
    _, rt = _serve(ServeEngine, cfg_t, pt, verify=False)
    return [r.out for r in rj], [r.out for r in rt]


def test_verify_on_streams_equal_verify_off_and_reference(model, baseline):
    cfg_j, cfg_t, pj, pt = model
    ref, reqs_j = _serve(JServeEngine, cfg_j, pj, verify=True)
    eng, reqs = _serve(ServeEngine, cfg_t, pt, verify=True)
    assert baseline[1] == baseline[0]
    assert [r.out for r in reqs] == baseline[1]
    assert [r.out for r in reqs] == [r.out for r in reqs_j]
    assert all(r.error is None for r in reqs)
    for key in ("mac_checks", "mac_failures", "retries", "tokens"):
        assert eng.stats[key] == ref.stats[key], key
    assert eng.stats["mac_checks"] > 0 and eng.stats["mac_failures"] == 0
    # verification changes no word the run writes, only adds the tags
    # (the two frameworks' K/V differ in the last bits, so the pools are
    # held to the reference word for word in the tests above, on the same
    # K/V, and here to the port's unverified run)
    plain, _ = _serve(ServeEngine, cfg_t, pt, verify=False)
    for key in ("k", "v"):
        assert torch.equal(eng._pools[0][key], plain._pools[0][key])
    assert torch.equal(eng._state.wc, plain._state.wc)
    assert bool((eng._pools[0]["mac_k"] != 0).any())
    assert not bool((plain._pools[0]["mac_k"] != 0).any())


@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_fault_detected_victim_retried_others_exact(kind, model, baseline):
    """Each fault class is detected and fails only its victim, which is
    re-prefilled once; the other requests' streams stay exact; nothing
    leaks; the integrity stats equal the reference engine's on the same
    trace and fault."""
    cfg_j, cfg_t, pj, pt = model
    inj = TamperInjector(kind, slot=0, start_step=3)
    eng, reqs = _serve(ServeEngine, cfg_t, pt, verify=True, hooks=(inj,))
    jinj = JTamperInjector(kind, slot=0, start_step=3)
    ref, reqs_j = _serve(JServeEngine, cfg_j, pj, verify=True, hooks=(jinj,))
    assert inj.fired and inj.events[0].kind == kind
    assert [(e.kind, e.step, e.slot, e.block) for e in inj.events] == \
        [(e.kind, e.step, e.slot, e.block) for e in jinj.events]
    assert eng.stats["mac_failures"] >= 1 and eng.stats["retries"] >= 1
    for key in ("mac_checks", "mac_failures", "retries", "tokens",
                "prefills", "decode_steps"):
        assert eng.stats[key] == ref.stats[key], key
    assert [r.retries for r in reqs] == [r.retries for r in reqs_j]
    assert any(r.retries > 0 for r in reqs)
    for r, want in zip(reqs, baseline[1]):
        assert r.done and r.error is None
        assert r.out == want if r.retries == 0 else len(r.out) == MAX_TOK
    assert [r.out for r in reqs] == [r.out for r in reqs_j]
    assert eng._alloc.free_count == eng.num_blocks - 1
    eng.check_device_mirror()


class _PersistentTamper(TamperInjector):
    """Re-arms every step: an adversary who keeps corrupting the victim's
    cache, exhausting the one re-prefill the engine grants."""

    def on_step(self, engine):
        self.fired = False
        super().on_step(engine)


def test_persistent_tamper_exhausts_retry_budget(model):
    _, cfg_t, _, pt = model
    inj = _PersistentTamper("bitflip", slot=0, start_step=3)
    eng, reqs = _serve(ServeEngine, cfg_t, pt, verify=True, hooks=(inj,))
    failed = [r for r in reqs if r.error == "integrity"]
    assert failed and all(r.done and r.retries == 1 for r in failed)
    assert eng.stats["mac_failures"] >= 2
    assert eng._alloc.free_count == eng.num_blocks - 1


def test_tampered_shared_source_fails_the_copy(model):
    """A bit flipped in a registered tail block: the sharer's copy-on-write
    checks its source before the re-key, fails, purges the donor's chains
    and re-prefills the sharer, which then shares nothing tampered; the
    stats equal the reference's on the same trace."""
    cfg_j, cfg_t, pj, pt = model
    base = np.random.RandomState(3).randint(1, cfg_t.vocab_size, 27)

    def run(cls, params, cfg):
        dev = {} if cls is JServeEngine else {"device": "cpu"}
        eng = cls(cfg, params, batch_slots=2, max_len=48, seal=None,
                  seal_cache=True, verify=True, prefix_share=True, **dev)
        eng.submit(base.copy(), max_tokens=3)
        eng.run()
        tail = eng._registry._partial[next(iter(eng._registry._partial))][0]
        if cls is JServeEngine:
            p0 = dict(eng._pools[0])
            p0["k"] = p0["k"].at[0, tail, 5].set(
                p0["k"][0, tail, 5] ^ np.uint32(4))
            eng._pools = (p0,)
        else:
            eng._pools[0]["k"][0, tail, 5] ^= 4
        r = eng.submit(base.copy(), max_tokens=3)
        eng.run()
        return eng, r

    ref, rj = run(JServeEngine, pj, cfg_j)
    eng, rt = run(ServeEngine, pt, cfg_t)
    assert rt.retries == 1 and rt.error is None and rt.done
    assert rt.out == rj.out
    for key in ("mac_checks", "mac_failures", "retries", "cow_copies",
                "shared_prefix_blocks", "shared_prefix_tokens"):
        assert eng.stats[key] == ref.stats[key], key
    assert eng.stats["mac_failures"] == 1
    assert eng._alloc.refcount == ref._alloc.refcount


def test_verify_requires_something_sealed(model):
    _, cfg_t, _, pt = model
    with pytest.raises(ValueError):
        ServeEngine(cfg_t, pt, batch_slots=2, max_len=48, seal=None,
                    seal_cache=False, verify=True, device="cpu")


def test_verify_over_sealed_weights_names_its_slice(model):
    """Verification over sealed weights is ported: the engine seals the
    weights with MACs (``seal.verify`` turned on, as the reference does)
    and the store tags every leaf; ``tests/test_torch_weight_integrity.py``
    holds both to the reference."""
    _, cfg_t, _, pt = model
    eng = ServeEngine(cfg_t, pt, batch_slots=2, max_len=48, seal=SealConfig(),
                      verify=True, device="cpu")
    assert eng.seal.verify and eng.cache_seal.mac is not None
    assert all(t.macs is not None for t in eng.sealed.tensors.values())
    sp = TSS.seal_params(pt, SealConfig(verify=True), KEY)
    assert TSS.n_macs(sp) == TSS.n_macs(eng.sealed) > 0


def test_make_injectors_csv():
    inj = make_injectors("bitflip, replay", start_step=5)
    assert [i.kind for i in inj] == ["bitflip", "replay"]
    assert all(i.start_step == 5 for i in inj)
    with pytest.raises(ValueError):
        TamperInjector("scramble")


# --------------------------------------------------------------------------
# run guards and runtime/fault.py
# --------------------------------------------------------------------------

def test_run_step_limit_raises_straggler(model):
    _, cfg_t, _, pt = model
    eng = ServeEngine(cfg_t, pt, batch_slots=2, max_len=48, seal_cache=True,
                      max_run_steps=2, device="cpu")
    eng.submit(_prompts(cfg_t.vocab_size)[0], max_tokens=MAX_TOK)
    with pytest.raises(StragglerTimeout):
        eng.run()
    assert ESTO is StragglerTimeout          # still importable from there


def test_run_watchdog_wired_into_step_loop(model):
    _, cfg_t, _, pt = model
    wd = StepWatchdog(warmup_steps=1, hard_limit_s=1e-9)
    eng = ServeEngine(cfg_t, pt, batch_slots=2, max_len=48, seal_cache=True,
                      watchdog=wd, device="cpu")
    eng.submit(_prompts(cfg_t.vocab_size)[0], max_tokens=MAX_TOK)
    with pytest.raises(StragglerTimeout):
        eng.run()


def test_retry_rejects_nonpositive_attempts():
    with pytest.raises(ValueError):
        retry(n=0)(lambda: None)
    with pytest.raises(ValueError):
        retry(n=-2)(lambda: None)


def test_retry_preserves_identity_and_exception_filter():
    @retry(n=3, backoff=0.0)
    def documented_name():
        """docstring survives"""
        raise KeyError("not retryable")

    assert documented_name.__name__ == "documented_name"
    assert documented_name.__doc__ == "docstring survives"
    with pytest.raises(KeyError):
        documented_name()


def test_retry_jitter_still_converges():
    calls = []

    @retry(n=4, backoff=0.001, jitter=0.5)
    def flaky():
        calls.append(1)
        if len(calls) < 4:
            raise OSError("transient")
        return "ok"

    assert flaky() == "ok" and len(calls) == 4


def test_heartbeat_scan_tolerates_torn_records(tmp_path):
    hb = Heartbeat(str(tmp_path), "h1", timeout=10.0)
    hb.beat(step=1)
    with open(os.path.join(str(tmp_path), "hb_stale.json"), "w") as f:
        json.dump({"host": "stale"}, f)          # no "time": infinitely old
    with open(os.path.join(str(tmp_path), "hb_anon.json"), "w") as f:
        json.dump({"time": 0.0}, f)              # no "host": the filename
    with open(os.path.join(str(tmp_path), "hb_bad.json"), "w") as f:
        f.write("{not json")                     # corrupt: skipped
    alive, dead = hb.alive_hosts(), hb.dead_hosts()
    assert set(alive) == {"h1"}
    assert set(dead) == {"stale", "anon"}
