"""Verified sealed weights in the port (``core/mac.py`` ``tile_tags`` and
``line_tags``, the ``macs`` of ``core/sealed_tensor.py``, the engines'
``line_macs``, ``sealed_store.seal_params(verify=True)``/``verify_params``/
``n_macs``, and ``ServeEngine(verify=True)`` over sealed weights) held
against the JAX package on the CPU.

Tolerances: none. Tags compare bitwise as u32 words (the kernels' plain
versions, which the CPU runs); ``verify_params`` verdicts exactly, the
port's against the reference's on the same image; token streams and the
integrity stats exactly, the cross-framework streams in f32 (XLA and
PyTorch sum in different orders, so bf16 roundings could flip a near-tied
argmax between the two frameworks). The weight-sweep tests use a
four-layer reduced internlm2: at two layers the first and last block are
forced fully encrypted, so no leaf has an SE bypass row to flip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SealConfig as JSealConfig
from repro.configs import get_reduced as jget_reduced
from repro.core import mac as JM
from repro.core import plan as JP
from repro.core import sealed_store as JSS
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import u32
from repro_torch.config import SealConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import mac as TM
from repro_torch.core import plan as TP
from repro_torch.core import sealed_store as TSS
from repro_torch.core.mac import SealedIntegrityError
from repro_torch.kernels import chacha20 as CC
from repro_torch.serve.engine import ServeEngine
from test_torch_store import _masks_with_ties

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
    w = rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[::5] |= np.uint32(0x80000000)
    w.reshape(-1)[0] = 0xFFFFFFFF
    return w


# --------------------------------------------------------------------------
# core/mac.py: tile_tags and line_tags
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k,n,bk,bn,lead", [
    (64, 64, 32, 32, ()), (128, 48, 64, 16, (3,)), (16, 256, 8, 128, (2,)),
    (256, 128, 128, 128, ()), (24, 40, 8, 8, (1,))], ids=str)
def test_tile_tags_match_reference(k, n, bk, bn, lead):
    """Bitwise over several seal tiles, stacked and not, with random SE
    masks (an all-bypass tile among them), write counters and tweaks."""
    rng = np.random.RandomState(k * n + bk)
    ct = _u32(rng, lead + (k, n))
    mask = rng.rand(*lead, k) < 0.5
    mask[..., :bk] = False                    # the first row of tiles bypass
    wc = rng.randint(0, 2**32, lead, dtype=np.uint64).astype(np.uint32)
    tweak = tuple(int(v) for v in rng.randint(0, 2**32, 3, dtype=np.uint64))
    cj = JM.mac_context(KEY, "weights")
    ctx = TM.mac_context(KEY, "weights", "cpu")
    want = JM.tile_tags(cj, ct, mask, wc, bk, bn, tweak=tweak)
    got = TM.tile_tags(ctx, u32.words(ct), torch.from_numpy(mask),
                       u32.words(wc), bk, bn, tweak=tweak)
    assert got.shape == lead + (k // bk, n // bn)
    np.testing.assert_array_equal(u32.to_numpy(got), np.asarray(want))
    # a flip in a bypass row leaves the tag; one in an encrypted row not
    r_by, r_enc = np.argwhere(~mask.reshape(-1, k)[0])[0, 0], \
        np.argwhere(mask.reshape(-1, k)[0])[0, 0]
    for row, same in ((r_by, True), (r_enc, False)):
        flip = ct.copy().reshape(-1, k, n)
        flip[0, row, 3] ^= np.uint32(1 << 9)
        t = TM.tile_tags(ctx, u32.words(flip.reshape(ct.shape)),
                         torch.from_numpy(mask), u32.words(wc), bk, bn,
                         tweak=tweak)
        assert torch.equal(t, got) == same, row


@pytest.mark.parametrize("scheme", ["coloe", "counter"])
@pytest.mark.parametrize("n_lines", [1, 37, 300])
def test_line_tags_match_reference(scheme, n_lines):
    """Bitwise for ColoE's 34-word records and the counter layout's 32 data
    words plus its counter word (passed apart, as the store keeps it); a
    slice tagged at its own first address equals the tags of those lines."""
    rng = np.random.RandomState(n_lines)
    width = 34 if scheme == "coloe" else 32
    payload = _u32(rng, (n_lines, width))
    counters = None if scheme == "coloe" else _u32(rng, (n_lines,))
    records = payload if counters is None else np.concatenate(
        [payload, counters[:, None]], axis=1)
    tweak = (0x9E3779B9, 7, 0)
    want = JM.line_tags(JM.mac_context(KEY, "weights"), records, tweak)
    ctx = TM.mac_context(KEY, "weights", "cpu")
    cw = None if counters is None else u32.words(counters)
    got = TM.line_tags(ctx, u32.words(payload), tweak, counters=cw)
    np.testing.assert_array_equal(u32.to_numpy(got), np.asarray(want))
    a = n_lines // 3
    part = CC.line_tags_plain(ctx.key_words, ctx.hash_keys(records.shape[1]),
                              ctx.nonce(tweak), u32.words(payload[a:]),
                              None if cw is None else cw[a:], line0=a)
    assert torch.equal(part, got[a:])


# --------------------------------------------------------------------------
# the sealed image: macs per leaf and verify_params
# --------------------------------------------------------------------------

def _seal_both(mode, ratio, layers, monkeypatch):
    """Reduced internlm2 of ``layers`` layers sealed with ``verify`` by both
    packages on the same weights (an SE near-tie flipped by the two
    frameworks' ℓ1 sums is reported and sealed with the reference mask)."""
    cfg = jget_reduced("internlm2_1_8b").with_(num_layers=layers)
    pj = JT.init_params(cfg, jax.random.key(0))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj))
    js = JSealConfig(mode=mode, smart_ratio=ratio, verify=True)
    ts = SealConfig(mode=mode, smart_ratio=ratio, verify=True)
    plans_j, plans_t = JP.make_plan(pj, js), TP.make_plan(pt, ts)
    flips = _masks_with_ties(plans_j, plans_t)
    if flips:
        print(f"SE mask near-ties flipped in {flips}; sealing with the "
              f"reference masks")
        for path in flips:
            plans_t[path].mask = torch.from_numpy(
                np.asarray(plans_j[path].mask))
        monkeypatch.setattr(TP, "make_plan", lambda *_: plans_t)
    return JSS.seal_params(pj, js, KEY), TSS.seal_params(pt, ts, KEY)


@pytest.fixture(scope="module", params=["coloe", "counter"])
def image(request):
    with pytest.MonkeyPatch.context() as mp:
        yield request.param, _seal_both(request.param, 0.5, 4, mp)


def test_sealed_macs_match_reference(image):
    """Every leaf's ``macs`` bitwise, and counted in its stored bytes."""
    _, (spj, spt) = image
    assert list(spt.tensors) == list(spj.tensors)
    for path, stj in spj.tensors.items():
        stt = spt.tensors[path]
        np.testing.assert_array_equal(u32.to_numpy(stt.payload),
                                      np.asarray(stj.payload), err_msg=path)
        np.testing.assert_array_equal(u32.to_numpy(stt.macs),
                                      np.asarray(stj.macs), err_msg=path)
        assert stt.stored_bytes() == stj.stored_bytes(), path
    assert TSS.n_macs(spt) == JSS.n_macs(spj) > 0
    assert spt.stored_bytes() == spj.stored_bytes()


@pytest.mark.parametrize("mode", ["coloe", "counter"])
def test_line_record_macs_and_verify_lines_match_reference(mode):
    """The engines' line hooks on a sealed leaf with mixed SE flags: the
    full record (counter word appended in counter mode), its tags and the
    per-line verdicts, bitwise the reference's; one flipped counter word
    fails its line only."""
    from repro.core import engine as JE
    from repro_torch.core import engine as TE
    rng = np.random.RandomState(5)
    x = rng.randn(9, 40).astype(np.float32)
    flags = (rng.rand(12) < 0.5).astype(np.uint32)
    ej, et = JE.make_engine(mode, KEY), TE.make_engine(mode, KEY)
    sj = ej.encrypt(jnp.asarray(x), nonce2=(5, 9),
                    enc_flags=jnp.asarray(flags))
    st = et.encrypt(torch.from_numpy(x), nonce2=(5, 9),
                    enc_flags=torch.from_numpy(flags.astype(np.int32)))
    tweak = (3, 2**32 - 1, 0)
    np.testing.assert_array_equal(u32.to_numpy(et.line_record(st)),
                                  np.asarray(ej.line_record(sj)))
    macs = et.line_macs(st, tweak)
    np.testing.assert_array_equal(u32.to_numpy(macs),
                                  np.asarray(ej.line_macs(sj, tweak)))
    assert bool(et.verify_lines(st, macs, tweak).all())
    if mode == "coloe":
        st.payload[4, 32] ^= 1                  # line 4's write counter
    else:
        st.counters[4] ^= 1
    ok = et.verify_lines(st, macs, tweak)
    assert ok.tolist() == [i != 4 for i in range(ok.shape[0])]


def _flip(spj, spt, path, index, bit=1 << 4):
    """XOR one bit into word ``index`` (flat) of a leaf's payload in both
    images."""
    stt, stj = spt.tensors[path], spj.tensors[path]
    stt.payload.view(-1)[index] ^= u32.const(bit)
    pay = np.array(stj.payload)
    pay.reshape(-1)[index] ^= np.uint32(bit)
    stj.payload = jnp.asarray(pay)


def _flip_sites(spt):
    """(what, path, flat word index): an encrypted word of a stacked block
    leaf, a word of an SE bypass row there (out of MAC scope by
    construction), a word of the LM head, and a word of an embedding
    line."""
    sites = []
    for path, st in spt.tensors.items():
        m = st.meta
        if m.layout != "tiles" or m.n_batch != 1:
            continue
        mask = st.row_mask.numpy()                       # (n, K)
        n = st.payload[0].numel() // mask.shape[1]       # N
        i, r = np.argwhere(mask)[-1]
        sites.append(("encrypted tile word", path,
                      (int(i) * mask.shape[1] + int(r)) * n + 3))
        if not mask.all():
            i, r = np.argwhere(~mask)[0]
            sites.append(("bypass row word", path,
                          (int(i) * mask.shape[1] + int(r)) * n + 5))
        break
    sites.append(("head word", "head/w", 7 * 256 + 11))
    sites.append(("embedding line word", "embed/w",
                  2 * spt.tensors["embed/w"].payload.shape[1] + 9))
    return sites


def test_verify_params_flags_flips_like_the_reference(image):
    """True when intact; False after one flipped bit in an encrypted tile
    word, a head word or an embedding line word; True again once restored;
    True after a flip in a bypass row. Each verdict is the reference's
    ``verify_params`` on the same image."""
    _, (spj, spt) = image
    sites = _flip_sites(spt)
    assert [s[0] for s in sites] == ["encrypted tile word", "bypass row word",
                                     "head word", "embedding line word"]
    ok = TSS.verify_params(spt, KEY)
    assert ok.shape == () and ok.dtype == torch.bool and bool(ok)
    for what, path, index in sites:
        _flip(spj, spt, path, index)
        got = bool(TSS.verify_params(spt, KEY))
        assert got == bool(JSS.verify_params(spj, KEY)), what
        assert got == (what == "bypass row word"), what
        _flip(spj, spt, path, index)
        assert bool(TSS.verify_params(spt, KEY)), what


def test_verify_params_without_macs_is_true():
    cfg = get_reduced("internlm2_1_8b")
    from repro_torch.models import transformer as T
    sp = TSS.seal_params(T.init_params(cfg, seed=0, device="cpu"),
                         SealConfig(), KEY)
    assert TSS.n_macs(sp) == 0 and bool(TSS.verify_params(sp, KEY))
    assert all(t.macs is None for t in sp.tensors.values())


# --------------------------------------------------------------------------
# the verified sealed engine
# --------------------------------------------------------------------------

PROMPT_LENS = (11, 7, 9)
MAX_TOK = 10


@pytest.fixture(scope="module")
def model():
    cfg_j = jget_reduced("internlm2_1_8b").with_(dtype="float32")
    cfg_t = get_reduced("internlm2_1_8b").with_(dtype="float32")
    pj = JT.init_params(cfg_j, jax.random.key(0))
    return cfg_j, cfg_t, pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def _prompts(vocab):
    rng = np.random.RandomState(7)
    return [rng.randint(1, vocab, (n,)).astype(np.int32) for n in PROMPT_LENS]


def _serve(cls, cfg, params, *, verify, seal=None, **kw):
    dev = {} if cls is JServeEngine else {"device": "cpu"}
    eng = cls(cfg, params, batch_slots=2, max_len=48, seal=seal,
              seal_cache=True, sample_seed=5, verify=verify, **dev, **kw)
    reqs = [eng.submit(p, max_tokens=MAX_TOK)
            for p in _prompts(cfg.vocab_size)]
    eng.run(max_steps=400)
    return eng, reqs


@pytest.fixture(scope="module")
def reference_runs(model):
    """The reference's plaintext-weight runs on the sealed cache, without
    and with verification."""
    cfg_j, _, pj, _ = model
    return (_serve(JServeEngine, cfg_j, pj, verify=False),
            _serve(JServeEngine, cfg_j, pj, verify=True))


@pytest.mark.parametrize("mode", ["coloe", "counter"])
def test_verified_sealed_engine_matches_reference(mode, model,
                                                  reference_runs):
    """Verified sealed serving (SE 0.5, sealed cache) emits the reference's
    plaintext tokens and the port's unverified tokens; it counts one MAC
    check for the weight sweep on top of the reference's cache checks
    (``ServeEngine._verify_weights`` counts one a sweep, one sweep a
    ``run``), and no failure."""
    _, cfg_t, _, pt = model
    (_, ref_plain), (ref_v, _) = reference_runs
    seal = SealConfig(mode=mode, smart_ratio=0.5)
    eng, reqs = _serve(ServeEngine, cfg_t, pt, verify=True, seal=seal)
    plain, reqs_u = _serve(ServeEngine, cfg_t, pt, verify=False, seal=seal)
    assert eng.seal.verify and not plain.seal.verify
    assert TSS.n_macs(eng.sealed) > 0 and TSS.n_macs(plain.sealed) == 0
    assert [r.out for r in reqs] == [r.out for r in ref_plain]
    assert [r.out for r in reqs] == [r.out for r in reqs_u]
    assert all(r.error is None for r in reqs)
    assert eng.stats["mac_checks"] == ref_v.stats["mac_checks"] + 1
    assert eng.stats["mac_failures"] == ref_v.stats["mac_failures"] == 0
    assert eng.stats["retries"] == 0


@pytest.mark.parametrize("where", ["tile", "head", "embed"])
def test_weight_tamper_is_fail_stop(where, model):
    """A flipped bit anywhere in the MAC'd weight image stops the engine at
    the sweep, before any token, with scope "weights"; ``step`` sweeps
    lazily once, ``run`` at its entry."""
    _, cfg_t, _, pt = model
    eng = ServeEngine(cfg_t, pt, batch_slots=2, max_len=48,
                      seal=SealConfig(mode="coloe"), verify=True,
                      device="cpu")
    path, index = {"tile": ("blocks/0/mlp/wi", (1, 2, 3)),
                   "head": ("head/w", (5, 6)),
                   "embed": ("embed/w", (4, 33))}[where]
    st = eng.sealed.tensors[path]
    if where != "embed":
        assert bool(st.row_mask[index[:-1]])          # an encrypted row
    st.payload[index] ^= 1 << 20
    reqs = [eng.submit(p, max_tokens=4) for p in _prompts(cfg_t.vocab_size)]
    with pytest.raises(SealedIntegrityError) as err:
        eng.step()
    assert err.value.scope == "weights"
    assert eng.stats["mac_checks"] == 1 and eng.stats["mac_failures"] == 1
    assert all(r.out == [] for r in reqs) and eng.stats["tokens"] == 0
    with pytest.raises(SealedIntegrityError):
        eng.run()
    assert eng.stats["mac_failures"] == 2
    st.payload[index] ^= 1 << 20                       # restored: it serves
    done = eng.run()
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    assert eng.stats["mac_failures"] == 2 and eng.stats["mac_checks"] > 3
