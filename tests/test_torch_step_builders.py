"""The step builders of ``serve/step.py`` (``make_decode_step``,
``make_paged_prefill``, ``make_paged_decode_step``,
``make_sealed_decode_step``) and the paged helpers they use
(``models/paged.py``: ``prefill_logits``, ``prefill_write``,
``apply_paged_updates``), held against the JAX package on the CPU in f32.

* The paged builders, run as the reference's oracle runs them
  (``tests/test_serve_paged.py:30-65``: a prefill of 8 tokens, then 6
  teacher-forced decode steps, the host bumping the write counters): their
  logits equal the port's contiguous prefill and decode steps bit for bit,
  on plaintext and sealed pools, dense and GQA; sealed pools hold other
  words than plaintext ones but give the same logits and tokens. Against
  the reference's builders in the same loop (sealed, GQA): logits within
  1e-5 of their scale (XLA and PyTorch sum in different orders), tokens
  equal.
* The write paths fed the same K/V as the reference's (its prefill cache
  and its decode updates): pools, MAC words and counters bitwise after
  every step, plaintext and sealed with MACs; so are inactive slots'
  appends into the shared scratch block.
* ``make_sealed_decode_step`` fused and unfused and ``make_decode_step``
  give the port's plaintext ``transformer.decode_step`` logits, caches and
  tokens bit for bit (the invariant of the reference's
  ``tests/test_sealed_tensor.py::test_fused_decode_matches_plaintext_exactly``)
  under ColoE, Counter and Direct, and the reference's plaintext
  ``decode_step`` within 1e-5 of scale; a frontend-stub config decodes its
  ``embeds`` through both builders.
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
from repro.serve import step as JST
from repro_torch import u32
from repro_torch.config import SealConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import sealed_store as SS
from repro_torch.models import cache as MC
from repro_torch.models import paged as PG
from repro_torch.models import transformer as T
from repro_torch.serve import sampling as SM
from repro_torch.serve import step as ST

KEY = bytes(range(32))
BS = 4
PLEN, STEPS = 8, 6
MB = (PLEN + STEPS + BS - 1) // BS + 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Plain PyTorch on one thread while this module runs: under
    pytest-xdist each worker's intra-op threads contend with every other
    worker's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_chacha():
    """The reference's ``fori_loop`` ChaCha recompiles at every eager call;
    the same function under ``jax.jit`` is cached per shape (integer-only:
    the same words)."""
    from repro.core import cipher as JC
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "chacha20_block", jax.jit(JC.chacha20_block))
        yield


def _model(arch="internlm2_1_8b", **kw):
    cfg_j = jget_reduced(arch).with_(dtype="float32", **kw)
    cfg_t = get_reduced(arch).with_(dtype="float32", **kw)
    pj = JT.init_params(cfg_j, jax.random.key(0))
    return cfg_j, cfg_t, pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _tables(b):
    t = np.zeros((b, MB), np.int64)
    for i in range(b):
        t[i] = 1 + i * MB + np.arange(MB)
    return t


def _sampling(b):
    """Row 0 greedy, the others sampled (temperature 0.8, top-k 8)."""
    temp = np.where(np.arange(b) == 0, 0.0, 0.8).astype(np.float32)
    topk = np.full((b,), 8, np.int64)
    topp = np.ones((b,), np.float32)
    kd = torch.stack([SM.request_key_data(7, r) for r in range(b)])
    return kd, temp, topk, topp


def _port_loop(cfg, params, toks, seal):
    """The reference oracle's loop through the port's builders; returns
    (logits (1 + STEPS, B, V), tokens (1 + STEPS, B), pools)."""
    b = toks.shape[0]
    nb = 1 + b * MB
    pools = MC.paged_pool_init(cfg, nb, BS, "cpu")
    tables = _tables(b)
    wc = np.zeros((nb,), np.int64)
    bt = tables[:, :PLEN // BS]
    kd, temp, topk, topp = _sampling(b)
    prefill = ST.make_paged_prefill(cfg, lambda t: t, seal)
    step = ST.make_paged_decode_step(cfg, lambda t: t, seal)
    wc[bt] += 1                              # sealed under the bumped wc
    tok, logits, pools = prefill(
        params, pools, torch.from_numpy(toks[:, :PLEN]),
        torch.full((b,), PLEN), torch.from_numpy(bt),
        u32.from_i64(torch.from_numpy(wc)), kd, torch.from_numpy(temp),
        torch.from_numpy(topk), torch.from_numpy(topp))
    out, outt = [logits], [tok]
    lengths = np.full((b,), PLEN, np.int64)
    for t in range(STEPS):
        tok, logits, pools = step(
            params, pools, torch.from_numpy(tables),
            torch.from_numpy(lengths), u32.from_i64(torch.from_numpy(wc)),
            torch.from_numpy(toks[:, PLEN + t][:, None]), kd,
            torch.full((b,), t + 1), torch.from_numpy(temp),
            torch.from_numpy(topk), torch.from_numpy(topp))
        wc[tables[np.arange(b), lengths // BS]] += 1   # the host's mirror
        lengths += 1
        out.append(logits)
        outt.append(tok)
    return torch.stack(out), torch.stack(outt), pools


def _reference_loop(cfg, params, toks, seal):
    """The same loop through the reference's builders, jitted as its
    engines jit them. Each call is waited for before the host bumps the
    counters and lengths it was given: on the CPU a call may read a numpy
    buffer in place while it runs."""
    b = toks.shape[0]
    nb = 1 + b * MB
    pools = JMC.paged_pool_init(cfg, nb, BS)
    tables = _tables(b).astype(np.int32)
    wc = np.zeros((nb,), np.uint32)
    bt = tables[:, :PLEN // BS]
    kd, temp, topk, topp = _sampling(b)
    kd = jnp.asarray(u32.to_numpy(kd))
    prefill = jax.jit(JST.make_paged_prefill(cfg, lambda t: t, seal))
    step = jax.jit(JST.make_paged_decode_step(cfg, lambda t: t, seal))
    wc[bt] += 1
    tok, logits, pools = prefill(
        params, pools, jnp.asarray(toks[:, :PLEN], jnp.int32),
        jnp.full((b,), PLEN, jnp.int32), jnp.asarray(bt), jnp.asarray(wc),
        kd, temp, topk.astype(np.int32), topp)
    jax.block_until_ready(logits)
    out, outt = [logits], [tok]
    lengths = np.full((b,), PLEN, np.int32)
    for t in range(STEPS):
        tok, logits, pools = step(
            params, pools, jnp.asarray(tables), jnp.asarray(lengths),
            jnp.asarray(wc), jnp.asarray(toks[:, PLEN + t][:, None],
                                         jnp.int32),
            kd, jnp.full((b,), t + 1, jnp.int32), temp,
            topk.astype(np.int32), topp)
        jax.block_until_ready(logits)
        wc[tables[np.arange(b), lengths // BS]] += 1
        lengths += 1
        out.append(logits)
        outt.append(tok)
    return np.stack(out), np.stack(outt)


def _contiguous(cfg, params, toks):
    """The port's prefill and decode steps over a contiguous cache as wide
    as the paged view, so that the sums run in the same order."""
    logits, cache = T.prefill(cfg, params, torch.from_numpy(toks[:, :PLEN]),
                              MB * BS)
    out = [logits]
    for t in range(STEPS):
        logits, cache, _ = T.decode_step(
            cfg, params, cache, torch.from_numpy(toks[:, PLEN + t][:, None]),
            PLEN + t)
        out.append(logits)
    return torch.stack(out)


@pytest.mark.parametrize("kv_heads", [4, 2])          # dense MHA / GQA
def test_paged_builders_match_contiguous_and_reference(kv_heads):
    cfg_j, cfg_t, pj, pt = _model(num_kv_heads=kv_heads)
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg_t.vocab_size, (2, PLEN + STEPS)).astype(
        np.int64)
    want = _contiguous(cfg_t, pt, toks)
    runs = {}
    for sealed in (False, True):
        seal = SS.cache_seal_config(KEY, "cpu") if sealed else None
        runs[sealed] = _port_loop(cfg_t, pt, toks, seal)
        np.testing.assert_array_equal(runs[sealed][0].numpy(), want.numpy())
    assert torch.equal(runs[True][1], runs[False][1])
    assert not torch.equal(runs[True][2][0]["k"], runs[False][2][0]["k"])
    if kv_heads != 2:
        return                 # the reference's loop once, at GQA
    ref_logits, ref_toks = _reference_loop(
        cfg_j, pj, toks, JSS.cache_seal_config(KEY))
    _close(runs[True][0].numpy(), ref_logits)
    np.testing.assert_array_equal(runs[True][1].numpy(), ref_toks)


def _assert_pools_equal(pt, pj):
    for j in range(len(pj)):
        for key in ("k", "v", "mac_k", "mac_v", "lid"):
            np.testing.assert_array_equal(u32.to_numpy(pt[j][key]),
                                          np.asarray(pj[j][key]),
                                          err_msg=key)


@pytest.mark.parametrize("seal", ["none", "verified"])
def test_write_paths_bitwise(seal):
    """``prefill_write`` and ``apply_paged_updates`` fed the reference's own
    prefill cache and decode updates."""
    cfg_j, cfg_t, pj, _ = _model(num_kv_heads=2)
    seal_j = seal_t = None
    if seal != "none":
        verify = seal == "verified"
        seal_j = JSS.cache_seal_config(KEY, verify=verify)
        seal_t = SS.cache_seal_config(KEY, "cpu", verify=verify)
    b = 2
    nb = 1 + b * MB
    rng = np.random.RandomState(4)
    toks = rng.randint(0, cfg_t.vocab_size, (b, PLEN + STEPS))
    pools_j = JMC.paged_pool_init(cfg_j, nb, BS)
    pools_t = MC.paged_pool_init(cfg_t, nb, BS, "cpu")
    tables = _tables(b)
    wc = np.zeros((nb,), np.int64)
    bt = tables[:, :PLEN // BS]
    # the reference's passes jitted, as its engines run them
    write = jax.jit(lambda pools, cache, bt, wc: JPG.prefill_write(
        cfg_j, seal_j, pools, cache, bt, wc))
    logits = jax.jit(lambda pools, tables, lengths, wc, tok: JPG.decode_logits(
        cfg_j, pj, pools, tables, lengths, wc, tok, seal_j))
    append = jax.jit(lambda pools, updates, tables, lengths, wc:
                     JPG.apply_paged_updates(cfg_j, seal_j, pools, updates,
                                             tables, lengths, wc))
    _, cache = JPG.prefill_logits(cfg_j, pj, jnp.asarray(toks[:, :PLEN]),
                                  jnp.full((b,), PLEN, jnp.int32))
    wc[bt] += 1
    pools_j = write(pools_j, cache, jnp.asarray(bt, jnp.int32),
                    jnp.array(wc, jnp.uint32))
    cache_t = tuple({k: torch.from_numpy(np.array(v)) for k, v in c.items()}
                    for c in cache)
    PG.prefill_write(cfg_t, seal_t, pools_t, cache_t, torch.from_numpy(bt),
                     u32.from_i64(torch.from_numpy(wc)))
    _assert_pools_equal(pools_t, pools_j)
    lengths = np.full((b,), PLEN, np.int64)
    for t in range(STEPS):
        _, updates, _ = logits(
            pools_j, jnp.asarray(tables, jnp.int32),
            jnp.array(lengths, jnp.int32), jnp.array(wc, jnp.uint32),
            jnp.asarray(toks[:, PLEN + t][:, None]))
        pools_j = append(pools_j, updates, jnp.asarray(tables, jnp.int32),
                         jnp.array(lengths, jnp.int32),
                         jnp.array(wc, jnp.uint32))
        upd_t = tuple({k: torch.from_numpy(np.array(v))
                       for k, v in u.items()} for u in updates)
        wc_t = u32.from_i64(torch.from_numpy(wc))
        PG.apply_paged_updates(cfg_t, seal_t, pools_t, upd_t,
                               torch.from_numpy(tables),
                               torch.from_numpy(lengths), wc_t)
        assert torch.equal(wc_t, u32.from_i64(torch.from_numpy(wc)))
        _assert_pools_equal(pools_t, pools_j)
        wc[tables[np.arange(b), lengths // BS]] += 1
        lengths += 1
    if seal == "verified":      # the tags written are the ones a read checks
        ok = PG._verify_pass(cfg_t, seal_t, pools_t, torch.from_numpy(tables),
                             torch.from_numpy(lengths),
                             u32.from_i64(torch.from_numpy(wc)))
        assert bool(ok.all())


def test_inactive_rows_append_into_the_scratch_block_bitwise():
    """``apply_paged_updates`` with two inactive slots (length 0, zeroed
    table row) that append the same token into the scratch block, beside
    a live one, sealed with MACs: the pools and tags equal the reference's,
    the scratch block tagged under ``wc + 1`` once though two rows wrote
    it, and ``wc`` is left as it was."""
    cfg_j, cfg_t, _, _ = _model(num_kv_heads=2)
    seal_j = JSS.cache_seal_config(KEY, verify=True)
    seal_t = SS.cache_seal_config(KEY, "cpu", verify=True)
    b = 3
    nb = 1 + b * MB
    tables = _tables(b)
    tables[1:] = 0
    lengths = np.array([5, 0, 0], np.int64)
    wc = np.arange(nb, dtype=np.int64) % 3 + 1
    rng = np.random.RandomState(5)
    pools_j = JMC.paged_pool_init(cfg_j, nb, BS)
    pools_t = MC.paged_pool_init(cfg_t, nb, BS, "cpu")
    updates = []
    for pj in pools_t:
        u = {}
        for key in ("k_new", "v_new"):
            x = rng.standard_normal((pj["lid"].shape[0], b, 1,
                                     cfg_t.num_kv_heads, cfg_t.head_dim))
            x[:, 2] = x[:, 1]
            u[key] = x.astype(np.float32)
        updates.append(u)
    pools_j = JPG.apply_paged_updates(
        cfg_j, seal_j, pools_j,
        tuple({k: jnp.asarray(x) for k, x in u.items()} for u in updates),
        jnp.asarray(tables, jnp.int32), jnp.asarray(lengths, jnp.int32),
        jnp.asarray(wc, jnp.uint32))
    wc_t = u32.from_i64(torch.from_numpy(wc))
    PG.apply_paged_updates(
        cfg_t, seal_t, pools_t,
        tuple({k: torch.from_numpy(x) for k, x in u.items()}
              for u in updates),
        torch.from_numpy(tables), torch.from_numpy(lengths), wc_t)
    assert torch.equal(wc_t, u32.from_i64(torch.from_numpy(wc)))
    _assert_pools_equal(pools_t, pools_j)
    assert not (np.asarray(pools_j[0]["mac_k"])[:, 0] == 0).all()


def _clone(cache):
    return tuple({k: t.clone() for k, t in c.items()} for c in cache)


@pytest.mark.parametrize("mode", ["coloe", "counter", "direct"])
def test_sealed_decode_step_equals_plaintext(mode):
    cfg_j, cfg_t, pj, pt = _model()
    sp = SS.seal_params(pt, SealConfig(mode=mode, smart_ratio=0.5), KEY)
    toks = (np.arange(16).reshape(2, 8) % cfg_t.vocab_size).astype(np.int64)
    _, cache = T.prefill(cfg_t, pt, torch.from_numpy(toks), 16)
    nxt = torch.tensor([[3], [5]])
    want, want_cache, want_tok = T.decode_step(cfg_t, pt, _clone(cache), nxt,
                                               8)
    batch = {"tokens": nxt}
    runs = {"plain": ST.make_decode_step(cfg_t)(pt, _clone(cache), batch,
                                                torch.tensor(8))}
    for fused in (True, False):
        fn = ST.make_sealed_decode_step(cfg_t, sp, KEY, fused=fused)
        runs[fused] = fn(sp.tensors, _clone(cache), batch, 8)
    for logits, c, tok in runs.values():
        assert torch.equal(logits, want) and torch.equal(tok, want_tok)
        for cj, wj in zip(c, want_cache):
            assert all(torch.equal(cj[k], wj[k]) for k in wj)
    _, cache_j = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks)}, 16)
    lj, _, tj = JT.decode_step(cfg_j, pj, cache_j,
                               {"tokens": jnp.asarray(nxt.numpy())},
                               jnp.int32(8))
    _close(want.numpy(), lj)
    np.testing.assert_array_equal(want_tok.numpy(), np.asarray(tj))


def test_frontend_config_decodes_embeds():
    """internvl2-1b's stub frontend: the builders hand ``embeds`` to the
    step, plain and sealed, for three steps from an empty cache."""
    cfg_j, cfg_t, pj, pt = _model("internvl2_1b")
    sp = SS.seal_params(pt, SealConfig(mode="coloe", smart_ratio=0.5), KEY)
    emb = np.random.RandomState(2).randn(2, 3, cfg_t.d_model).astype(
        np.float32)
    cache_t = MC.model_cache_init(cfg_t, 2, 8, "cpu")
    cache_s = _clone(cache_t)
    cache_j = JMC.model_cache_init(cfg_j, 2, 8)
    plain = ST.make_decode_step(cfg_t)
    sealed = ST.make_sealed_decode_step(cfg_t, sp, KEY)
    for pos in range(3):
        e = emb[:, pos:pos + 1]
        lt, cache_t, _ = plain(pt, cache_t, {"embeds": torch.from_numpy(e)},
                               pos)
        ls, cache_s, _ = sealed(sp.tensors, cache_s,
                                {"embeds": torch.from_numpy(e)}, pos)
        lj, cache_j, _ = JT.decode_step(cfg_j, pj, cache_j,
                                        {"embeds": jnp.asarray(e)},
                                        jnp.int32(pos))
        assert torch.equal(ls, lt)
        _close(lt.numpy(), lj)
