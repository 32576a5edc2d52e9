"""The port's sealed weight store (``core.engine``, ``core.criticality``,
``core.plan``, ``core.sealed_tensor``, ``core.sealed_store``) held against
the JAX package on the CPU, on the same weights (reduced internlm2 params
made by the reference and converted through numpy).

Tolerances: ciphertext, counters, flags and masks are u32/bool data and
compare bitwise; decrypted weights compare bitwise with the plaintext. The
fused matmul of a sealed leaf compares at f32 summation order (rtol 1e-5,
atol 1e-4). SE masks come from ℓ1 sums taken in another float order; should
a near-tie flip a row, the test says so and feeds the reference mask to the
ciphertext check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SealConfig as JSealConfig
from repro.configs import get_reduced as jget_reduced
from repro.core import engine as JE
from repro.core import plan as JP
from repro.core import sealed_store as JSS
from repro.models import transformer as JT
from repro_torch import u32
from repro_torch.config import SealConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import engine as TE
from repro_torch.core import plan as TP
from repro_torch.core import sealed_store as TSS
from repro_torch.core.sealed_tensor import SealedTensor
from repro_torch.tree import flatten_with_path

KEY = bytes(range(32))


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_chacha():
    """The reference seals eagerly, and its ``fori_loop`` ChaCha recompiles
    at every call; the same function under ``jax.jit`` is cached per shape.
    Integer-only, so the reference's words are unchanged — only faster."""
    from repro.core import cipher as JC
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "chacha20_block", jax.jit(JC.chacha20_block))
        yield


@pytest.fixture(scope="module")
def params():
    """Reduced internlm2 params from the reference, and the same numbers in
    the port's tree."""
    cfg = jget_reduced("internlm2_1_8b")
    pj = JT.init_params(cfg, jax.random.key(0))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def _np(t):
    if t is None:
        return None
    if t.dtype == torch.int32:
        return u32.to_numpy(t)
    return t.numpy()


@pytest.mark.parametrize("mode", ["counter", "coloe"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_line_engines_bitwise(mode, dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(7, 45).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16"
                                else torch.float32)
    flags = (rng.rand(-(-x.size * xt.element_size() // 128)) < 0.5)
    ej, et = JE.make_engine(mode, KEY), TE.make_engine(mode, KEY)
    sj = ej.encrypt(xj, nonce2=(5, 9), enc_flags=jnp.asarray(flags, jnp.uint32))
    st = et.encrypt(xt, nonce2=(5, 9),
                    enc_flags=torch.from_numpy(flags.astype(np.int32)))
    np.testing.assert_array_equal(_np(st.payload), np.asarray(sj.payload))
    if mode == "counter":
        np.testing.assert_array_equal(_np(st.counters),
                                      np.asarray(sj.counters))
    assert st.stored_bytes() == sj.stored_bytes()
    back = et.decrypt(st)
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(xj, np.float32))
    # write-back bumps the counters: new ciphertext, same plaintext
    rj, rt = ej.rewrite(sj, xj), et.rewrite(st, xt)
    np.testing.assert_array_equal(_np(rt.payload), np.asarray(rj.payload))
    np.testing.assert_array_equal(et.decrypt(rt).float().numpy(),
                                  np.asarray(xj, np.float32))


@pytest.mark.parametrize("mode", ["counter", "coloe"])
def test_cache_block_seal_is_an_involution(mode):
    et = TE.make_engine(mode, KEY)
    words = torch.arange(2 * 3 * 40, dtype=torch.int32).reshape(2, 3, 40)
    bids = torch.tensor([[1, 2, 3], [4, 5, 6]])
    sealed = et.seal_cache_blocks(words, (1, 2, 3), bids, 7, 1)
    assert not torch.equal(sealed, words)
    assert torch.equal(et.unseal_cache_blocks(sealed, (1, 2, 3), bids, 7, 1),
                       words)
    want = JE.make_engine(mode, KEY).seal_cache_blocks(
        jnp.asarray(words.numpy().view(np.uint32)), (1, 2, 3),
        jnp.asarray(bids.numpy()), jnp.uint32(7), jnp.uint32(1))
    np.testing.assert_array_equal(u32.to_numpy(sealed), np.asarray(want))


def test_paths_and_order_match_the_reference(params):
    pj, pt = params
    jpaths = ["/".join(JP._path_tuple(k))
              for k, _ in jax.tree_util.tree_flatten_with_path(pj)[0]]
    tpaths = ["/".join(p) for p, _ in flatten_with_path(pt)]
    assert tpaths == jpaths
    assert "blocks/0/attn/wq" in tpaths and "head/w" in tpaths


def _masks_with_ties(plans_j, plans_t):
    """Paths whose SE mask differs; each difference must be an ℓ1 near-tie
    (reported, then the reference mask is used for the ciphertext)."""
    flips = []
    for path, pj in plans_j.items():
        pt = plans_t[path]
        assert pj.mode == pt.mode and pj.total_bytes == pt.total_bytes
        if pj.mask is None:
            assert pt.mask is None
            continue
        mj, mt = np.asarray(pj.mask), pt.mask.numpy()
        if not np.array_equal(mj, mt):
            flips.append(path)
    return flips


def check_sealed_image(params, mode, ratio, monkeypatch):
    """The port's whole sealed image equals the reference's word for word
    (ciphertext, counters, SE masks, write counters), and unseals to the
    params bit for bit. Shared with test_torch_store_counter.py."""
    pj, pt = params
    js = JSealConfig(mode=mode, smart_ratio=ratio)
    ts = SealConfig(mode=mode, smart_ratio=ratio)
    plans_j, plans_t = JP.make_plan(pj, js), TP.make_plan(pt, ts)
    flips = _masks_with_ties(plans_j, plans_t)
    if flips:
        print(f"SE mask near-ties flipped in {flips}; sealing with the "
              f"reference masks")
        for path in flips:
            plans_t[path].mask = torch.from_numpy(
                np.asarray(plans_j[path].mask))
        monkeypatch.setattr(TP, "make_plan", lambda *_: plans_t)
    spj, spt = JSS.seal_params(pj, js, KEY), TSS.seal_params(pt, ts, KEY)
    assert list(spt.tensors) == list(spj.tensors)
    for path, stj in spj.tensors.items():
        stt = spt.tensors[path]
        assert stt.meta.layout == stj.meta.layout, path
        assert (stt.meta.bk, stt.meta.bn, stt.meta.nonce, stt.meta.shape) == \
            (stj.meta.bk, stj.meta.bn, stj.meta.nonce, stj.meta.shape), path
        np.testing.assert_array_equal(_np(stt.payload),
                                      np.asarray(stj.payload), err_msg=path)
        for a, b in ((stt.counters, stj.counters), (stt.row_mask, stj.row_mask),
                     (stt.wc, stj.wc)):
            assert (a is None) == (b is None), path
            if a is not None:
                np.testing.assert_array_equal(_np(a), np.asarray(b),
                                              err_msg=path)
        assert stt.stored_bytes() == stj.stored_bytes(), path
    assert spt.fused_paths() == spj.fused_paths()
    assert spt.plaintext_bytes_materialized() == \
        spj.plaintext_bytes_materialized()
    assert spt.enc_fraction() == pytest.approx(spj.enc_fraction())
    # unseal gives the params back bit for bit
    back = TSS.unseal_params(spt, KEY)
    for (p, a), (_, b) in zip(flatten_with_path(back), flatten_with_path(pt)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), p


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
def test_sealed_image_word_for_word_coloe(params, ratio, monkeypatch):
    check_sealed_image(params, "coloe", ratio, monkeypatch)


def test_fused_params_keep_tiles_sealed(params):
    _, pt = params
    sp = TSS.seal_params(pt, SealConfig(), KEY)
    fp = TSS.fused_params(sp, KEY)
    orig = dict(("/".join(p), t) for p, t in flatten_with_path(pt))
    for p, leaf in flatten_with_path(fp):
        path = "/".join(p)
        if path in sp.fused_paths():
            assert isinstance(leaf, SealedTensor)
        else:
            assert torch.equal(leaf, orig[path])
    assert len(sp.fused_paths()) == 8


def test_sliced_sealed_matmul_matches_plain(params):
    """A stacked leaf's slice i decrypts under write counter i inside the
    matmul and equals the plaintext product."""
    _, pt = params
    sp = TSS.seal_params(pt, SealConfig(mode="coloe", smart_ratio=0.5), KEY)
    st = sp.tensors["blocks/0/mlp/wi"]
    assert not st.sliced
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 64)
                         .astype(np.float32))
    w = pt["blocks"][0]["mlp"]["wi"]
    for i in range(w.shape[0]):
        s = st.slice(i)
        assert s.sliced and s.out_shape == (128,) and s.k_size == 64
        np.testing.assert_allclose(s.matmul(x).numpy(), (x @ w[i]).numpy(),
                                   rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        st.matmul(x)


def test_tile_geometry_matches_reference(params):
    pj, pt = params
    seal_j, seal_t = JSealConfig(), SealConfig()
    for (kp, lj), (p, lt) in zip(jax.tree_util.tree_flatten_with_path(pj)[0],
                                 flatten_with_path(pt)):
        path = JP._path_tuple(kp)
        assert TSS.tile_geometry(p, tuple(lt.shape), lt.dtype, seal_t) == \
            JSS.tile_geometry(path, lj.shape, lj.dtype, seal_j), path


def test_cache_seal_nonces_match_reference():
    cj = JSS.cache_seal_config(KEY)
    ct = TSS.cache_seal_config(KEY, "cpu")
    assert (ct.nonce_k, ct.nonce_v) == (cj.nonce_k, cj.nonce_v)
    np.testing.assert_array_equal(u32.to_numpy(ct.key_words),
                                  np.asarray(cj.key_words))
    # verify arms CacheSeal.mac: the reference's MAC context, its key words
    # and its hash keys
    mj = JSS.cache_seal_config(KEY, verify=True).mac
    mt = TSS.cache_seal_config(KEY, "cpu", verify=True).mac
    assert ct.mac is None and cj.mac is None
    assert mt.nonce3 == mj.nonce3 and mt.key_bytes == mj.key_bytes
    np.testing.assert_array_equal(u32.to_numpy(mt.key_words),
                                  np.asarray(mj.key_words))
    np.testing.assert_array_equal(u32.to_numpy(mt.hash_keys(24)),
                                  np.asarray(mj.hash_keys(24)))
