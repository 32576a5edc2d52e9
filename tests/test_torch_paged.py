"""The port's paged KV cache (``models/cache.py``, the write path and the
gathered view of ``models/paged.py``) held against the JAX package on the
CPU: pools and write counters compare bitwise after the same sequence of
admits (block tables), chunk writes and decode-tick writes, fed the same K/V
updates, plaintext and sealed; so do the gathered, unsealed views. The
model passes over these pools are in test_torch_model.py.
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
from repro_torch import u32
from repro_torch.configs import get_reduced
from repro_torch.core import sealed_store as TSS
from repro_torch.models import cache as TMC
from repro_torch.models import paged as TPG

KEY = bytes(range(32))
BS = 4                 # tokens per block
B, MB = 2, 5           # slots, blocks per slot
NB = 1 + B * MB


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_chacha():
    """The reference runs these passes eagerly, and its ``fori_loop`` ChaCha
    recompiles at every call; the same function under ``jax.jit`` is cached
    per shape. Integer-only, so the reference's words are unchanged."""
    from repro.core import cipher as JC
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "chacha20_block", jax.jit(JC.chacha20_block))
        yield


def _cfgs(dtype):
    return (jget_reduced("internlm2_1_8b").with_(dtype=dtype),
            get_reduced("internlm2_1_8b").with_(dtype=dtype))


def _tables():
    t = np.zeros((B, MB), np.int64)
    for i in range(B):
        t[i] = 1 + i * MB + np.arange(MB)
    return t


def _seals(sealed):
    if not sealed:
        return None, None
    return JSS.cache_seal_config(KEY), TSS.cache_seal_config(KEY, "cpu")


def _assert_pools_equal(pj, pt, wcj, wct):
    for j in range(len(pj)):
        for key in ("k", "v", "mac_k", "mac_v", "lid"):
            np.testing.assert_array_equal(u32.to_numpy(pt[j][key]),
                                          np.asarray(pj[j][key]), err_msg=key)
    np.testing.assert_array_equal(u32.to_numpy(wct), np.asarray(wcj))


def _updates(cfg_t, rng, c, dt_t):
    n = cfg_t.n_superblocks()
    shape = (n, B, c, cfg_t.num_kv_heads, cfg_t.head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    upj = ({"k_new": jnp.asarray(k).astype(dt_t[0]),
            "v_new": jnp.asarray(v).astype(dt_t[0])},)
    upt = ({"k_new": torch.from_numpy(k).to(dt_t[1]),
            "v_new": torch.from_numpy(v).to(dt_t[1])},)
    return upj, upt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sealed", [False, True])
def test_pool_writes_bitwise(dtype, sealed):
    """Ragged chunk writes, then decode-tick appends with a masked slot:
    pools, counters and the unsealed views match the reference."""
    cfg_j, cfg_t = _cfgs(dtype)
    seal_j, seal_t = _seals(sealed)
    dts = (jnp.dtype(dtype), getattr(torch, dtype))
    rng = np.random.RandomState(7)
    pools_j = JMC.paged_pool_init(cfg_j, NB, BS)
    pools_t = TMC.paged_pool_init(cfg_t, NB, BS, "cpu")
    tables = _tables()
    wc_j = jnp.zeros((NB,), jnp.uint32)
    wc_t = torch.zeros((NB,), dtype=torch.int32)
    lengths = np.zeros((B,), np.int64)
    steps = [(5, [5, 3]), (5, [5, 5]), (5, [1, 0]), (1, [1, 1]),
             (1, [0, 1]), (1, [1, 1])]
    for c, counts in steps:
        upj, upt = _updates(cfg_t, rng, c, dts)
        counts = np.asarray(counts, np.int64)
        pools_j, wc_j = JPG.append_tokens(
            cfg_j, seal_j, pools_j, upj, jnp.asarray(tables, jnp.int32),
            jnp.asarray(lengths, jnp.int32), jnp.asarray(counts, jnp.int32),
            wc_j)
        TPG.append_tokens(cfg_t, seal_t, pools_t, upt,
                          torch.from_numpy(tables), torch.from_numpy(lengths),
                          torch.from_numpy(counts), wc_t)
        lengths = lengths + counts
        _assert_pools_equal(pools_j, pools_t, wc_j, wc_t)
        for i in range(cfg_t.n_superblocks()):
            pj = {k: pools_j[0][k][i] for k in ("k", "v", "lid")}
            pt = {k: pools_t[0][k][i] for k in ("k", "v", "lid")}
            vj, _ = JPG._dense_view(cfg_j, seal_j, pj,
                                    jnp.asarray(tables, jnp.int32),
                                    jnp.asarray(lengths, jnp.int32), wc_j)
            vt = TPG._dense_view(cfg_t, seal_t, pt, torch.from_numpy(tables),
                                 torch.from_numpy(lengths), wc_t)
            # no MAC context: nothing checked, every slot passes
            assert bool(TPG._verify_pass(
                cfg_t, seal_t, pools_t, torch.from_numpy(tables),
                torch.from_numpy(lengths), wc_t).all())
            for key in ("k", "v"):
                np.testing.assert_array_equal(
                    vt[key].float().numpy(),
                    np.asarray(vj[key].astype(jnp.float32)))
            np.testing.assert_array_equal(vt["pos"].numpy(),
                                          np.asarray(vj["pos"]))
    assert int(wc_t.sum()) > 0
    if sealed:      # the pool image is ciphertext: it differs from plaintext
        plain = TMC.paged_pool_init(cfg_t, NB, BS, "cpu")
        assert not torch.equal(plain[0]["k"], pools_t[0]["k"])


def test_kv_words_roundtrip_bf16():
    x = torch.randn(3, 4, 8).to(torch.bfloat16)
    w = TMC.kv_to_words(x)
    assert w.dtype == torch.int32 and w.shape == (3, 4, 4)
    assert torch.equal(TMC.words_to_kv(w, torch.bfloat16), x)
    want = JMC.kv_to_words(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(u32.to_numpy(w), np.asarray(want))


def test_block_allocator_refcounts():
    a = TMC.BlockAllocator(6)
    blocks = a.alloc(3)
    assert blocks == [1, 2, 3] and a.free_count == 2
    assert a.alloc(3) is None
    a.incref(blocks[:1])
    assert a.decref(blocks) == [2, 3]
    assert a.decref(blocks[:1]) == [1]
    with pytest.raises(ValueError):
        a.decref([1])
