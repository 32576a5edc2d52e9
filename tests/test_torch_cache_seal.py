"""The port's fused ChaCha routes (``kernels/chacha20.py``: ``cache_view``,
``cache_splice``, ``lines_unseal``, ``lines_gather_rows``) held bitwise
against the JAX package on the CPU, where each route takes its plain
version; and the serving view that leaves the token embedding line-sealed
(``sealed_store.serving_params``).

Inputs are made with numpy from a seed. Every comparison is of u32 words,
or of floats compared as their bits: cache views and pools against the
reference's ``_dense_view`` and ``append_tokens``, unsealed leaves against
the reference engines' ``decrypt``, gathered rows against the reference's
decrypt-then-``jnp.take(w.astype(dt), tokens)``. Greedy streams of the
port's sealed engines (which serve from the new view) compare exactly with
the reference plaintext engines' in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import engine as JE
from repro.core import sealed_store as JSS
from repro.models import paged as JPG
from repro.models import transformer as JT
from repro.serve.engine import GroupServeEngine as JGroupServeEngine
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import u32
from repro_torch.config import SealConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import engine as TE
from repro_torch.core import sealed_store as TSS
from repro_torch.core.sealed_tensor import SealedTensor
from repro_torch.kernels import chacha20 as CC
from repro_torch.kernels import ops
from repro_torch.models import cache as TMC
from repro_torch.models import paged as TPG
from repro_torch.models import transformer as T
from repro_torch.serve.engine import GroupServeEngine, ServeEngine
from repro_torch.tree import flatten_with_path

KEY = bytes(range(32))
KEY_WORDS = u32.words(np.frombuffer(KEY, np.uint32))
WC_EDGE = 2**32 - 1


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_chacha():
    """The reference's ``fori_loop`` ChaCha recompiles at every eager call;
    the same function under ``jax.jit`` is cached per shape. Integer-only,
    so the reference's words are unchanged."""
    from repro.core import cipher as JC
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "chacha20_block", jax.jit(JC.chacha20_block))
        yield


def _bits(a):
    """The bits of a numpy or JAX array (u32 or u16 per element)."""
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16}[a.dtype.itemsize])


def _tbits(t):
    """The bits of a torch tensor, as ``_bits`` gives them."""
    two = t.element_size() == 2
    return _bits(t.view(torch.int16 if two else torch.int32).numpy())


def _u32(rng, shape):
    return rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _cfgs(dtype, kv_heads, head_dim):
    kw = dict(dtype=dtype, num_kv_heads=kv_heads, head_dim=head_dim)
    return (jget_reduced("internlm2_1_8b").with_(**kw),
            get_reduced("internlm2_1_8b").with_(**kw))


# dtype, kv heads, head dim: wpt words a token. (f32, 2, 16): 32 words, whole
# 16-word units; (bf16, 2, 16): 16; (f32, 1, 6): 6 words, so a 4-token block
# of 24 words ends in a partial unit and a unit spans three tokens.
GEOMS = [("float32", 2, 16), ("bfloat16", 2, 16), ("float32", 1, 6)]


# --------------------------------------------------------------------------
# the paged cache: the dense view and the write splice
# --------------------------------------------------------------------------

def _cache_state(rng, cfg_t, bs, b, mb, nb, lids):
    """Pools of ``len(lids)`` layers holding real K/V values of the model's
    dtype, sealed by the reference's ``cache_block_otp`` under the cache
    seal; tables of distinct blocks; write counters with some at 2^32 - 1.
    (Real values: on random words the reference's bf16 ``where`` would
    canonicalize NaN payloads.)"""
    from repro.kernels import ref as JKR
    from repro.models import cache as JMC
    n, wpt = len(lids), TMC.kv_words_per_token(cfg_t)
    wpb = bs * wpt
    tables = (1 + rng.permutation(nb - 1)[:b * mb]).reshape(b, mb)
    wc = _u32(rng, (nb,))
    wc[::3] = WC_EDGE
    seal = JSS.cache_seal_config(KEY)
    pools = []
    for nonce in (seal.nonce_k, seal.nonce_v):
        x = jnp.asarray(rng.randn(n, nb, wpb * 4 // jnp.dtype(
            cfg_t.dtype).itemsize), jnp.float32).astype(cfg_t.dtype)
        otp = JKR.cache_block_otp(seal.key_words, nonce,
                                  np.arange(nb)[None, :], wc[None, :],
                                  np.asarray(lids, np.uint32)[:, None], wpb)
        pools.append(np.asarray(JMC.kv_to_words(x) ^ otp))
    return pools[0], pools[1], tables.astype(np.int64), wc


@pytest.mark.parametrize("geom", GEOMS, ids=str)
@pytest.mark.parametrize("path", ["decode", "chunk"])
def test_cache_view_matches_reference(geom, path):
    """``_dense_view`` (one ``cache_view`` per layer) against the
    reference's: k, v and pos bitwise, lengths 0, partial and full, and on
    the chunk path positions valid up to ``lengths + chunk_len``."""
    cfg_j, cfg_t = _cfgs(*geom)
    rng = np.random.RandomState(11)
    bs, b, mb = 4, 4, 3
    lids = [3, WC_EDGE]
    k, v, tables, wc = _cache_state(rng, cfg_t, bs, b, mb, 1 + b * mb, lids)
    lengths = np.array([0, 1, bs * mb, 5], np.int64)
    pos_len = lengths + np.array([3, 2, 0, 4]) if path == "chunk" else None
    seal_j = JSS.cache_seal_config(KEY)
    seal_t = TSS.cache_seal_config(KEY, "cpu")
    for i in range(2):
        lid = np.uint32(lids[i])
        vj, _ = JPG._dense_view(
            cfg_j, seal_j, {"k": jnp.asarray(k[i]), "v": jnp.asarray(v[i]),
                            "lid": jnp.asarray(lid)},
            jnp.asarray(tables, jnp.int32), jnp.asarray(lengths, jnp.int32),
            jnp.asarray(wc),
            None if pos_len is None else jnp.asarray(pos_len, jnp.int32))
        pt = {"k": u32.words(k)[i], "v": u32.words(v)[i],
              "lid": u32.words(lid)}
        vt = TPG._dense_view(
            cfg_t, seal_t, pt, torch.from_numpy(tables),
            torch.from_numpy(lengths), u32.words(wc),
            None if pos_len is None else torch.from_numpy(pos_len))
        for key in ("k", "v"):     # random words: NaNs of every payload
            np.testing.assert_array_equal(_tbits(vt[key]), _bits(vj[key]),
                                          err_msg=key)
        np.testing.assert_array_equal(vt["pos"].numpy(), np.asarray(vj["pos"]))
        # no MAC context: nothing checked, every slot passes
        assert bool(TPG._verify_pass(
            cfg_t, seal_t, ({key: x[None] for key, x in pt.items()},),
            torch.from_numpy(tables), torch.from_numpy(lengths),
            u32.words(wc)).all())


@pytest.mark.parametrize("geom", GEOMS, ids=str)
def test_cache_view_plain_words(geom):
    """The plain version's words directly: the reference's gather XOR its
    ``cache_block_otp``, zero at every word of a token at or past the
    slot's length."""
    from repro.kernels import ref as JKR
    _, cfg_t = _cfgs(*geom)
    rng = np.random.RandomState(12)
    bs, b, mb = 4, 4, 3
    wpt = TMC.kv_words_per_token(cfg_t)
    k, v, tables, wc = _cache_state(rng, cfg_t, bs, b, mb, 1 + b * mb,
                                    [0, 9])
    lengths = np.array([2, 0, bs * mb, 7], np.int64)
    nonce_k, nonce_v = (1, WC_EDGE, 3), (7, 0, 2**31)
    got = ops.cache_view(
        KEY_WORDS, nonce_k, nonce_v, u32.words(k[1]), u32.words(v[1]),
        u32.words(np.uint32(9)), torch.from_numpy(tables),
        torch.from_numpy(lengths), u32.words(wc), wpt)
    wpb = k.shape[-1]
    live = (np.arange(mb * wpb) // wpt)[None, :] < lengths[:, None]
    for pool, nonce, g in ((k[1], nonce_k, got[0]), (v[1], nonce_v, got[1])):
        otp = np.asarray(JKR.cache_block_otp(
            jnp.asarray(np.frombuffer(KEY, np.uint32)), nonce,
            jnp.asarray(tables), jnp.asarray(wc[tables]), jnp.uint32(9), wpb))
        want = np.where(live, (pool[tables] ^ otp).reshape(b, -1), 0)
        np.testing.assert_array_equal(u32.to_numpy(g), want)


def _splice_case(c):
    """(lengths, counts) of a write of ``c`` tokens per row: counts 0 and
    C, a write that starts at a block's end, one from a block's middle."""
    if c == 1:
        return [0, 3, 16, 7], [1, 1, 0, 1]
    return [0, 15, 16, 40], [32, 0, 20, 32]


@pytest.mark.parametrize("geom", GEOMS, ids=str)
@pytest.mark.parametrize("c", [1, 32])
def test_cache_splice_matches_reference(geom, c):
    """``append_tokens`` (one ``cache_splice`` per write) against the
    reference's: pools and write counters bitwise after a write of C = 1
    (decode) or C = 32 (a chunk: with 16-token blocks a write spans up to
    nspan = 3 blocks), rows with counts 0, counters at 2^32 - 1."""
    cfg_j, cfg_t = _cfgs(*geom)
    rng = np.random.RandomState(13 + c)
    bs, b, mb = 16, 4, 5
    nb = 1 + b * mb
    lid = np.array([0, WC_EDGE], np.uint32)
    k, v, tables, wc = _cache_state(rng, cfg_t, bs, b, mb, nb, lid)
    lengths, counts = (np.array(a, np.int64) for a in _splice_case(c))
    # the kernel's in-place update needs distinct touched blocks
    nspan = 1 + (c + bs - 2) // bs
    pb, touched = CC.splice_blocks(torch.from_numpy(tables),
                                   torch.from_numpy(lengths),
                                   torch.from_numpy(counts), bs, nspan)
    hit = pb[touched]
    assert nspan == (3 if c == 32 else 1)
    assert hit.numel() == torch.unique(hit).numel() > 0
    n = 2
    shape = (n, b, c, cfg_t.num_kv_heads, cfg_t.head_dim)
    kn, vn = rng.randn(*shape), rng.randn(*shape)
    dt_j, dt_t = jnp.dtype(geom[0]), getattr(torch, geom[0])
    up_j = ({"k_new": jnp.asarray(kn, jnp.float32).astype(dt_j),
             "v_new": jnp.asarray(vn, jnp.float32).astype(dt_j)},)
    up_t = ({"k_new": torch.from_numpy(kn).float().to(dt_t),
             "v_new": torch.from_numpy(vn).float().to(dt_t)},)
    pools_j = ({"k": jnp.asarray(k), "v": jnp.asarray(v),
                "lid": jnp.asarray(lid), "mac_k": None, "mac_v": None},)
    pools_t = ({"k": u32.words(k), "v": u32.words(v),
                "lid": u32.words(lid)},)
    wc_t = u32.words(wc)
    new_j, wc_j = JPG.append_tokens(
        cfg_j, JSS.cache_seal_config(KEY), pools_j, up_j,
        jnp.asarray(tables, jnp.int32), jnp.asarray(lengths, jnp.int32),
        jnp.asarray(counts, jnp.int32), jnp.asarray(wc))
    TPG.append_tokens(cfg_t, TSS.cache_seal_config(KEY, "cpu"), pools_t,
                      up_t, torch.from_numpy(tables),
                      torch.from_numpy(lengths), torch.from_numpy(counts),
                      wc_t)
    for key in ("k", "v"):
        np.testing.assert_array_equal(u32.to_numpy(pools_t[0][key]),
                                      np.asarray(new_j[0][key]), err_msg=key)
        assert not np.array_equal(u32.to_numpy(pools_t[0][key]),
                                  {"k": k, "v": v}[key])
    np.testing.assert_array_equal(u32.to_numpy(wc_t), np.asarray(wc_j))


# --------------------------------------------------------------------------
# line-sealed leaves
# --------------------------------------------------------------------------

def _sealed_leaf(scheme, x, rng):
    """The reference's sealed buffer of ``x`` with mixed per-line flags and
    write counters near the top of their range, and the same buffer in the
    port's types."""
    eng_j = JE.make_engine(scheme, KEY)
    words, _, _ = JE.tensor_to_words(jnp.asarray(x))
    n_lines = -(-words.shape[0] // 32)
    top = 2**32 - 1 if scheme == "coloe" else 2**31 - 1
    wc = (top - rng.randint(0, 3, n_lines)).astype(np.uint32)
    flags = rng.randint(0, 2, n_lines).astype(np.uint32)
    flags[0] = 1
    sj = eng_j.encrypt(jnp.asarray(x), nonce2=(WC_EDGE, 77),
                       write_counters=jnp.asarray(wc),
                       enc_flags=jnp.asarray(flags))
    counters = None if sj.counters is None else u32.words(np.asarray(
        sj.counters))
    st = TE.SealedBuffer(scheme, u32.words(np.asarray(sj.payload)), counters,
                         sj.orig_len, tuple(x.shape),
                         getattr(torch, str(sj.dtype)), sj.nonce2)
    return eng_j, sj, st


@pytest.mark.parametrize("scheme", ["coloe", "counter"])
@pytest.mark.parametrize("dtype,shape", [("float32", (24, 41)),
                                         ("float32", (3, 7)),
                                         ("bfloat16", (5, 13))], ids=str)
def test_lines_unseal_matches_reference_decrypt(scheme, dtype, shape):
    """The engines' ``decrypt`` (one ``lines_unseal``) against the
    reference's: mixed SE flags, a final line that is partly filled (every
    shape here), write counters at the top of the scheme's range."""
    rng = np.random.RandomState(sum(shape))
    x = np.asarray(jnp.asarray(rng.randn(*shape), jnp.float32).astype(dtype))
    eng_j, sj, st = _sealed_leaf(scheme, x, rng)
    assert sj.orig_len % 32
    want = _bits(eng_j.decrypt(sj))
    got = TE.make_engine(scheme, KEY, "cpu").decrypt(st)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(_tbits(got), want)
    words = ops.lines_unseal(KEY_WORDS,
                             st.payload, st.counters, st.orig_len, st.nonce2)
    np.testing.assert_array_equal(
        u32.to_numpy(words), np.asarray(JE.tensor_to_words(
            eng_j.decrypt(sj))[0]))


@pytest.mark.parametrize("scheme", ["coloe", "counter"])
@pytest.mark.parametrize("d", [64, 24, 40])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_lines_gather_rows_matches_reference(scheme, d, out):
    """Rows of a line-sealed (V, D) f32 leaf, in f32 and bf16, against the
    reference's decrypt then ``jnp.take(w.astype(dt), tokens, axis=0)``;
    D = 24 and 40 put rows off line boundaries."""
    rng = np.random.RandomState(d)
    vocab = 50
    x = rng.randn(vocab, d).astype(np.float32)
    eng_j, sj, st = _sealed_leaf(scheme, x, rng)
    tokens = np.array([[0, vocab - 1, 7], [7, 30, 1]], np.int64)
    want = jnp.take(eng_j.decrypt(sj).astype(out), jnp.asarray(tokens),
                    axis=0)
    got = ops.lines_gather_rows(
        KEY_WORDS, st.payload, st.counters,
        st.nonce2, (vocab, d), torch.float32, torch.from_numpy(tokens),
        getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (2, 3, d)
    np.testing.assert_array_equal(_tbits(got), _bits(want))
    with pytest.raises(IndexError):
        ops.lines_gather_rows(
            KEY_WORDS, st.payload, st.counters,
            st.nonce2, (vocab, d), torch.float32,
            torch.tensor([vocab]), getattr(torch, out))


# --------------------------------------------------------------------------
# the serving view and the engines that serve from it
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_model():
    cfg_j = jget_reduced("internlm2_1_8b").with_(dtype="float32")
    cfg_t = get_reduced("internlm2_1_8b").with_(dtype="float32")
    pj = JT.init_params(cfg_j, jax.random.key(3))
    return cfg_j, cfg_t, pj, params_from_numpy(jax.tree.map(np.asarray, pj))


@pytest.mark.parametrize("mode", ["coloe", "counter"])
@pytest.mark.parametrize("tied", [False, True])
def test_serving_view_keeps_the_embedding_sealed(f32_model, mode, tied):
    """``serving_params`` is ``fused_params`` but for ``embed/w``: line
    sealed with the key words on its device (decrypted when the embedding
    is tied), and ``_embed`` through it gives the decrypted rows bitwise."""
    _, cfg_t, _, pt = f32_model
    sp = TSS.seal_params(pt, SealConfig(mode=mode), KEY)
    fused = dict(("/".join(p), t) for p, t in
                 flatten_with_path(TSS.fused_params(sp, KEY)))
    view = dict(("/".join(p), t) for p, t in
                flatten_with_path(TSS.serving_params(sp, KEY, tied)))
    assert list(view) == list(fused)
    for path, leaf in view.items():
        if path == "embed/w" and not tied:
            assert isinstance(leaf, SealedTensor)
            assert leaf.meta.layout == "lines" and leaf.payload is \
                sp.tensors[path].payload
            assert leaf.key_words.device == leaf.payload.device
        elif isinstance(leaf, SealedTensor):
            assert leaf is fused[path]
        else:
            assert torch.equal(leaf.view(torch.int32),
                               fused[path].view(torch.int32)), path
    tokens = torch.tensor([[3, 0, 255], [17, 17, 9]])
    for dt in ("float32", "bfloat16"):
        cfg = cfg_t.with_(dtype=dt)
        got = T._embed(cfg, {"embed": {"w": view["embed/w"]}}, tokens)
        want = T._embed(cfg, {"embed": {"w": fused["embed/w"]}}, tokens)
        assert got.dtype == getattr(torch, dt)
        np.testing.assert_array_equal(_tbits(got), _tbits(want))


def test_serving_plaintext_bytes(f32_model):
    """What the serving view materializes per dispatch: the line leaves but
    the embedding, plus the embedded rows; the reference's count (every line
    leaf) stays on ``plaintext_bytes_materialized``."""
    _, cfg_t, _, pt = f32_model
    sp = TSS.seal_params(pt, SealConfig(), KEY)
    embed = sp.tensors["embed/w"].logical_bytes()
    lines = sp.plaintext_bytes_materialized()
    d = cfg_t.d_model
    assert sp.serving_plaintext_bytes(4, torch.bfloat16) == \
        lines - embed + 4 * d * 2
    assert sp.serving_plaintext_bytes(3, torch.float32, True) == lines
    eng = ServeEngine(cfg_t, pt, seal=SealConfig(), batch_slots=2,
                      max_len=32, device="cpu")
    assert eng.stats["weights_plaintext_bytes_per_step"] == \
        lines - embed + 2 * d * 4


def _prompts(vocab, lens):
    rng = np.random.RandomState(5)
    return [rng.randint(0, vocab, n) for n in lens]


@pytest.mark.parametrize("mode", ["coloe", "counter"])
def test_sealed_continuous_streams_match_reference(f32_model, mode):
    """The port's sealed ``ServeEngine`` (sealed weights and cache, served
    through the new view and routes) emits the reference plaintext engine's
    greedy streams and bumps the same write counters."""
    cfg_j, cfg_t, pj, pt = f32_model
    kw = dict(batch_slots=2, max_len=48, chunk_tokens=8)
    prompts = _prompts(cfg_t.vocab_size, (6, 19, 11))
    ref = JServeEngine(cfg_j, pj, seal=None, seal_cache=False, **kw)
    eng = ServeEngine(cfg_t, pt, seal=SealConfig(mode=mode), device="cpu",
                      **kw)
    outs = []
    for e in (ref, eng):
        hs = [e.submit(p, max_tokens=5) for p in prompts]
        e.run()
        outs.append([h.out for h in hs])
    assert outs[1] == outs[0]
    np.testing.assert_array_equal(eng._state.wc.numpy().view(np.uint32),
                                  np.asarray(ref._state.wc))


@pytest.mark.parametrize("mode", ["coloe", "counter"])
def test_sealed_group_streams_match_reference(f32_model, mode):
    """The port's sealed ``GroupServeEngine`` (embedding rows gathered from
    the line-sealed leaf) emits the reference plaintext group engine's
    greedy streams."""
    cfg_j, cfg_t, pj, pt = f32_model
    kw = dict(batch_slots=2, max_len=32)
    prompts = _prompts(cfg_t.vocab_size, (5, 12, 9))
    ref = JGroupServeEngine(cfg_j, pj, seal=None, **kw)
    eng = GroupServeEngine(cfg_t, pt, seal=SealConfig(mode=mode),
                           device="cpu", **kw)
    outs = []
    for e in (ref, eng):
        hs = [e.submit(p, max_tokens=4) for p in prompts]
        e.run()
        outs.append([h.out for h in hs])
    assert outs[1] == outs[0]
