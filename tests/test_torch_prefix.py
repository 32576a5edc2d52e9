"""Copy-on-write prefix sharing in the port (``models/cache.py``
``PrefixRegistry``, ``models/paged.py`` ``copy_blocks``, ``serve/step.py``
``cow``, ``ServeEngine(prefix_share=True)``) held against the JAX package on
the CPU.

Tolerances: none. Registry decisions, refcounts and free lists compare
exactly; pool words, MAC words, write counters and the copy's verdict
bitwise (u32 words; the copy's plain version on the CPU); greedy token
streams and the engines' stats exactly, in f32 (XLA and PyTorch sum in
different orders, so bf16 roundings could flip a near-tied argmax between
the two frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import sealed_store as JSS
from repro.models import cache as JMC
from repro.models import paged as JPG
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import u32
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import sealed_store as TSS
from repro_torch.models import cache as TMC
from repro_torch.models import paged as TPG
from repro_torch.serve import step as ST
from repro_torch.serve.engine import ServeEngine

KEY = bytes(range(32))
SEALS = ["plaintext", "sealed", "sealed+mac"]


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_chacha():
    """The reference's ``fori_loop`` ChaCha recompiles at every eager call;
    the same function under ``jax.jit`` is cached per shape. Integer-only,
    so the reference's words are unchanged."""
    from repro.core import cipher as JC
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "chacha20_block", jax.jit(JC.chacha20_block))
        yield


def _seals(kind):
    if kind == "plaintext":
        return None, None
    verify = kind == "sealed+mac"
    return (JSS.cache_seal_config(KEY, verify=verify),
            TSS.cache_seal_config(KEY, "cpu", verify=verify))


def _u32(rng, shape):
    return rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


# --------------------------------------------------------------------------
# PrefixRegistry
# --------------------------------------------------------------------------

def _registry_state(alloc, reg):
    return (list(alloc.refcount), list(alloc._free), dict(reg._full),
            dict(reg._partial), dict(reg._parent), dict(reg._lru),
            reg.hits)


@pytest.mark.parametrize("seed", range(4))
def test_registry_matches_reference(seed):
    """A seeded stream of prompts over a few shared stems: every match
    (full blocks, partial tail, shared tokens), registration, slot release,
    purge and LRU eviction leaves both registries and allocators in the
    same state."""
    rng = np.random.RandomState(seed)
    bs, nb = 4, 40
    jalloc, talloc = JMC.BlockAllocator(nb), TMC.BlockAllocator(nb)
    jreg = JMC.PrefixRegistry(jalloc, bs)
    treg = TMC.PrefixRegistry(talloc, bs)
    stems = [rng.randint(0, 50, rng.randint(3, 14)) for _ in range(3)]
    live = []
    for _ in range(14):
        stem = stems[rng.randint(len(stems))]
        cut = rng.randint(1, len(stem) + 1)
        prompt = np.concatenate([stem[:cut],
                                 rng.randint(0, 50, rng.randint(1, 7))])
        mj, mt = jreg.match(prompt), treg.match(prompt)
        assert mt == mj
        full, partial, _ = mt
        held = list(full) + ([partial[0]] if partial else [])
        for a in (jalloc, talloc):
            a.incref(held)
        need = -(-len(prompt) // bs) + 1 - len(full)
        if need > talloc.free_count:
            assert treg.evict_lru(need) == jreg.evict_lru(need)
        pj, pt = jalloc.alloc(need), talloc.alloc(need)
        assert pt == pj
        if pt is None:
            for a in (jalloc, talloc):
                a.decref(held)
            continue
        for a in (jalloc, talloc):
            a.incref(full)
            a.decref(held)
        table = full + pt
        jreg.register(prompt, table)
        treg.register(prompt, table)
        live.append(table)
        if len(live) > 2:              # the oldest slot finishes
            done = live.pop(0)
            assert talloc.decref(done) == jalloc.decref(done)
        if rng.rand() < 0.2:           # an integrity failure on one block
            bad = [table[rng.randint(len(table))]]
            assert treg.purge_blocks(bad) == jreg.purge_blocks(bad)
        assert _registry_state(talloc, treg) == _registry_state(jalloc, jreg)
    for table in live:
        assert talloc.decref(table) == jalloc.decref(table)
    assert treg.evict_lru(nb - 1) == jreg.evict_lru(nb - 1)
    assert _registry_state(talloc, treg) == _registry_state(jalloc, jreg)


def test_registry_purge_cascades_to_descendants():
    """Port of the reference's cascade case: purging the middle block kills
    its chain and every descendant but spares the ancestor; the owner's
    references keep the blocks until it lets them go."""
    alloc = TMC.BlockAllocator(12)
    reg = TMC.PrefixRegistry(alloc, 4)
    blocks = alloc.alloc(4)
    prompt = np.arange(100, 114, dtype=np.int32)     # 3 full blocks + tail
    reg.register(prompt, blocks)
    assert len(reg._full) == 3 and len(reg._partial) == 1
    assert reg.purge_blocks([blocks[1]]) == 0
    assert len(reg._full) == 1 and not reg._partial
    full, partial, n_shared = reg.match(prompt)
    assert full == [blocks[0]] and partial is None and n_shared == 4
    assert len(alloc.decref(blocks)) == 3
    assert alloc.free_count == 11 - 1


# --------------------------------------------------------------------------
# copy_blocks
# --------------------------------------------------------------------------

def _random_pools(cfg_j, cfg_t, rng, nb, bs):
    """The same random words (k, v and MAC words) in both packages' pools,
    and write counters with every third at 2^32 - 1."""
    pools_j = JMC.paged_pool_init(cfg_j, nb, bs)
    pools_t = TMC.paged_pool_init(cfg_t, nb, bs, "cpu")
    out_j = []
    for pj, pt in zip(pools_j, pools_t):
        pj = dict(pj)
        for key in ("k", "v", "mac_k", "mac_v"):
            w = _u32(rng, pj[key].shape)
            pj[key] = jnp.asarray(w)
            pt[key].copy_(u32.words(w))
        out_j.append(pj)
    wc = _u32(rng, (nb,))
    wc[::3] = 2**32 - 1
    return tuple(out_j), pools_t, wc


def _assert_pools(pools_j, pools_t, wc_j, wc_t):
    for pj, pt in zip(pools_j, pools_t):
        for key in ("k", "v", "mac_k", "mac_v", "lid"):
            np.testing.assert_array_equal(u32.to_numpy(pt[key]),
                                          np.asarray(pj[key]), err_msg=key)
    np.testing.assert_array_equal(u32.to_numpy(wc_t), np.asarray(wc_j))


@pytest.mark.parametrize("kind", SEALS)
@pytest.mark.parametrize("tamper", [False, True])
def test_copy_blocks_matches_reference(kind, tamper):
    """Two copy pairs and a padded (masked-off) one: pool words, MAC words,
    write counters and the verdict bitwise against the reference's
    ``copy_blocks``; with ``tamper`` one source's tag is stale, which only a
    MAC-armed seal notices."""
    cfg_j = jget_reduced("internlm2_1_8b")
    cfg_t = get_reduced("internlm2_1_8b")
    rng = np.random.RandomState(5)
    nb, bs = 12, 4
    pools_j, pools_t, wc = _random_pools(cfg_j, cfg_t, rng, nb, bs)
    seal_j, seal_t = _seals(kind)
    src = np.array([3, 7, 0], np.int64)
    dst = np.array([9, 10, 0], np.int64)
    mask = np.array([True, True, False])
    if seal_t is not None and seal_t.mac is not None:
        # the sources carry their true tags, the copy's own check passes
        for pj, pt in zip(pools_j, pools_t):
            for key, nonce in (("mac_k", seal_j.nonce_k),
                               ("mac_v", seal_j.nonce_v)):
                words = "k" if key == "mac_k" else "v"
                tags = seal_j.mac.tags(pj[words][:, src], src,
                                       jnp.asarray(wc)[src],
                                       pj["lid"][:, None], tweak=nonce)
                pj[key] = pj[key].at[:, src].set(tags)
                pt[key][:, torch.from_numpy(src)] = u32.words(
                    np.asarray(tags))
    if tamper:
        for pj, pt in zip(pools_j, pools_t):
            pj["mac_v"] = pj["mac_v"].at[0, 7].set(pj["mac_v"][0, 7] ^ 1)
            pt["mac_v"][0, 7] ^= 1
    new_j, wc_j, ok_j = JPG.copy_blocks(
        cfg_j, seal_j, pools_j, jnp.asarray(wc), jnp.asarray(src, jnp.int32),
        jnp.asarray(dst, jnp.int32), jnp.asarray(mask))
    wc_t = u32.words(wc)
    ok_t = TPG.copy_blocks(cfg_t, seal_t, pools_t, wc_t, torch.from_numpy(src),
                           torch.from_numpy(dst), torch.from_numpy(mask))
    _assert_pools(new_j, pools_t, wc_j, wc_t)
    assert bool(ok_t) == bool(ok_j)
    assert bool(ok_t) == (not tamper or kind != "sealed+mac")


def test_copy_blocks_refuses_overlapping_pairs():
    cfg_t = get_reduced("internlm2_1_8b")
    pools = TMC.paged_pool_init(cfg_t, 8, 4, "cpu")
    wc = torch.zeros((8,), dtype=torch.int32)
    with pytest.raises(ValueError, match="overlap"):
        TPG.copy_blocks(cfg_t, TSS.cache_seal_config(KEY, "cpu"), pools, wc,
                        torch.tensor([2, 3]), torch.tensor([3, 4]),
                        torch.tensor([True, True]))


def _kv_updates(cfg, rng, b, c):
    n = cfg.n_superblocks()
    shape = (n, b, c, cfg.num_kv_heads, cfg.head_dim)
    return [rng.randn(*shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("kind", SEALS)
def test_append_into_cowed_shared_tail(kind):
    """A donor writes 7 tokens (one full block of 4 and a tail of 3); a
    sharer matches the full block and 2 tail tokens, copies the tail block
    into its first private block and writes from position 6 on, in the
    copy, never in the donor's blocks. Pools, MAC words and counters
    bitwise against the reference doing the same."""
    cfg_j = jget_reduced("internlm2_1_8b").with_(dtype="float32")
    cfg_t = get_reduced("internlm2_1_8b").with_(dtype="float32")
    rng = np.random.RandomState(3)
    bs, nb, mb = 4, 9, 4
    seal_j, seal_t = _seals(kind)
    pools_j = JMC.paged_pool_init(cfg_j, nb, bs)
    pools_t = TMC.paged_pool_init(cfg_t, nb, bs, "cpu")
    wc_j = jnp.zeros((nb,), jnp.uint32)
    wc_t = torch.zeros((nb,), dtype=torch.int32)
    donor = np.array([[1, 2, 3, 4]], np.int64)
    sharer = np.array([[1, 5, 6, 7]], np.int64)      # block 1 shared

    def write(table, length, count, c):
        nonlocal pools_j, wc_j
        k, v = _kv_updates(cfg_t, rng, 1, c)
        lengths = np.array([length], np.int64)
        counts = np.array([count], np.int64)
        pools_j, wc_j = JPG.append_tokens(
            cfg_j, seal_j, pools_j, ({"k_new": jnp.asarray(k),
                                      "v_new": jnp.asarray(v)},),
            jnp.asarray(table, jnp.int32), jnp.asarray(lengths, jnp.int32),
            jnp.asarray(counts, jnp.int32), wc_j)
        TPG.append_tokens(cfg_t, seal_t, pools_t,
                          ({"k_new": torch.from_numpy(k),
                            "v_new": torch.from_numpy(v)},),
                          torch.from_numpy(table), torch.from_numpy(lengths),
                          torch.from_numpy(counts), wc_t)

    write(donor, 0, 7, 8)
    donor_words = [pools_t[0][key][:, [1, 2]].clone() for key in ("k", "v")]
    src, dst = np.array([2, 0]), np.array([5, 0])     # padded like the engine
    mask = np.array([True, False])
    pools_j, wc_j, ok_j = JPG.copy_blocks(
        cfg_j, seal_j, pools_j, wc_j, jnp.asarray(src, jnp.int32),
        jnp.asarray(dst, jnp.int32), jnp.asarray(mask))
    state = ST.sched_init(1, mb, nb, "cpu")
    state.wc = wc_t
    ok_t = ST.cow(cfg_t, pools_t, state, torch.from_numpy(src),
                  torch.from_numpy(dst), torch.from_numpy(mask), seal_t)
    assert bool(ok_t) and bool(ok_j)
    _assert_pools(pools_j, pools_t, wc_j, wc_t)
    write(sharer, 6, 5, 5)          # from the shared tail's 3rd token on
    write(sharer, 11, 1, 1)         # and a decode write
    _assert_pools(pools_j, pools_t, wc_j, wc_t)
    for key, before in zip(("k", "v"), donor_words):   # the donor's intact
        assert torch.equal(pools_t[0][key][:, [1, 2]], before)
    if seal_t is not None:           # the sharer reads its view back
        TPG._dense_view(
            cfg_t, seal_t, {key: pools_t[0][key][0] for key in
                            ("k", "v", "mac_k", "mac_v", "lid")},
            torch.from_numpy(sharer), torch.tensor([12]), wc_t)
        ok = TPG._verify_pass(cfg_t, seal_t, pools_t,
                              torch.from_numpy(sharer), torch.tensor([12]),
                              wc_t)
        assert bool(ok.all())


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_model():
    cfg_j = jget_reduced("internlm2_1_8b").with_(dtype="float32")
    cfg_t = get_reduced("internlm2_1_8b").with_(dtype="float32")
    pj = JT.init_params(cfg_j, jax.random.key(1))
    return cfg_j, cfg_t, pj, params_from_numpy(jax.tree.map(np.asarray, pj))


STAT_KEYS = ("prefills", "prefill_chunks", "decode_steps", "tokens",
             "cow_copies", "shared_prefix_blocks", "shared_prefix_tokens",
             "mac_checks", "mac_failures", "retries")


def _shared_trace(eng, vocab):
    """The reference's prefix-sharing trace (tests/test_serve_paged.py):
    a donor of 27 tokens (one full block and an 11-token tail) registers its
    prefix, then a clone and a fork of its first 20 tokens arrive; all
    greedy."""
    rng = np.random.RandomState(7)
    base = rng.randint(0, vocab, 27)
    fork = np.concatenate([base[:20], rng.randint(0, vocab, 7)])
    r0 = eng.submit(base.copy(), max_tokens=6)
    for _ in range(3):
        eng.step()
    r1 = eng.submit(base.copy(), max_tokens=6)
    r2 = eng.submit(fork.copy(), max_tokens=5)
    eng.run()
    return [r0.out, r1.out, r2.out]


@pytest.mark.parametrize("seal_cache", [False, True])
def test_prefix_sharing_engine_matches_reference(f32_model, seal_cache):
    """Shared runs of the port against the reference's shared run: streams,
    write counters, refcounts, free list and stats exactly; and against the
    port's own unshared run: the same streams."""
    cfg_j, cfg_t, pj, pt = f32_model
    kw = dict(batch_slots=2, max_len=48, seal=None, seal_cache=seal_cache)
    ref = JServeEngine(cfg_j, pj, prefix_share=True, **kw)
    want = _shared_trace(ref, cfg_t.vocab_size)
    eng = ServeEngine(cfg_t, pt, prefix_share=True, device="cpu", **kw)
    assert _shared_trace(eng, cfg_t.vocab_size) == want
    unshared = ServeEngine(cfg_t, pt, device="cpu", **kw)
    assert _shared_trace(unshared, cfg_t.vocab_size) == want
    for key in STAT_KEYS:
        assert eng.stats[key] == ref.stats[key], key
    assert eng.stats["cow_copies"] >= 1
    assert eng.stats["shared_prefix_tokens"] >= 26
    assert unshared.stats["shared_prefix_blocks"] == 0
    np.testing.assert_array_equal(u32.to_numpy(eng._state.wc),
                                  np.asarray(ref._state.wc))
    assert eng._alloc.refcount == ref._alloc.refcount
    assert eng._free == ref._free
    eng.check_device_mirror()


def test_refcounted_blocks_freed_with_last_reader(f32_model):
    """Port of the reference's lifecycle check: shared blocks return to the
    free list only when the last reader (a live slot or the registry) drops
    them; registry-held blocks go by LRU eviction under pressure."""
    _, cfg_t, _, pt = f32_model
    base = np.random.RandomState(9).randint(0, cfg_t.vocab_size, 27)
    eng = ServeEngine(cfg_t, pt, batch_slots=2, max_len=48, seal=None,
                      seal_cache=False, prefix_share=True, device="cpu")
    eng.submit(base.copy(), max_tokens=4)
    eng.run()
    assert eng.num_blocks - 1 - len(eng._free) == 2   # full block + tail
    shared_block = eng._registry._full[next(iter(eng._registry._full))]
    assert eng._alloc.refcount[shared_block] == 1     # registry only
    eng.submit(base.copy(), max_tokens=4)
    eng._admit()
    assert eng._alloc.refcount[shared_block] == 2     # + the live slot
    eng.run()
    assert eng._alloc.refcount[shared_block] == 1
    assert eng.num_blocks - 1 - len(eng._free) >= 2
    eng._registry.evict_lru(eng.num_blocks - 1)
    assert len(eng._free) == eng.num_blocks - 1
    eng.check_device_mirror()
