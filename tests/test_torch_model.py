"""The port's model passes over the paged cache (``models/paged.py``
``chunk_logits``/``decode_logits``, through ``models/blocks.py``,
``models/layers.py`` and ``models/transformer.py``) held against the JAX
package on the CPU.

* Chunk and decode logits compare allclose in f32 (rtol 1e-4, atol 1e-4):
  XLA and PyTorch sum matmuls and softmax in different orders, nothing else
  differs.
* In the port, the fused sealed weights give the plaintext logits bit for
  bit, in f32 and in bf16 (the sealed branch takes the kernel's plain
  version, which computes the plaintext contraction's arithmetic).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cache as JMC
from repro.models import paged as JPG
from repro.models import transformer as JT
from repro_torch.config import SealConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import sealed_store as TSS
from repro_torch.models import cache as TMC
from repro_torch.models import paged as TPG
from test_torch_paged import (B, BS, KEY, NB, _assert_pools_equal,  # noqa: F401
                              _cfgs, _seals, _tables, jitted_reference_chacha)


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = _cfgs("float32")
    pj = JT.init_params(cfg_j, jax.random.key(3))
    return cfg_j, cfg_t, pj, params_from_numpy(jax.tree.map(np.asarray, pj))


@pytest.mark.parametrize("sealed", [False, True])
def test_chunk_and_decode_logits_allclose(model, sealed):
    """A chunked prefill of 11 tokens in chunks of 5, then three
    teacher-forced decode ticks: every pass's logits match the reference's in
    f32; both sides write the reference's K/V, so the pools stay bitwise
    equal and each pass sees the same cache."""
    cfg_j, cfg_t, pj, pt = model
    seal_j, seal_t = _seals(sealed)
    rng = np.random.RandomState(5)
    toks = rng.randint(0, cfg_t.vocab_size, (B, 14))
    pools_j = JMC.paged_pool_init(cfg_j, NB, BS)
    pools_t = TMC.paged_pool_init(cfg_t, NB, BS, "cpu")
    tables = _tables()
    tj, tt = jnp.asarray(tables, jnp.int32), torch.from_numpy(tables)
    wc_j = jnp.zeros((NB,), jnp.uint32)
    wc_t = torch.zeros((NB,), dtype=torch.int32)
    lengths = np.zeros((B,), np.int64)

    def write(upj, counts):
        nonlocal pools_j, wc_j, lengths
        upt = tuple({k: torch.from_numpy(np.array(u[k])) for k in u}
                    for u in upj)
        pools_j, wc_j = JPG.append_tokens(
            cfg_j, seal_j, pools_j, upj, tj, jnp.asarray(lengths, jnp.int32),
            jnp.asarray(counts, jnp.int32), wc_j)
        TPG.append_tokens(cfg_t, seal_t, pools_t, upt, tt,
                          torch.from_numpy(lengths), torch.from_numpy(counts),
                          wc_t)
        lengths = lengths + counts

    for off in (0, 5, 10):
        n = min(5, 11 - off)
        chunk = np.zeros((B, 5), np.int64)
        chunk[:, :n] = toks[:, off:off + n]
        cl = np.full((B,), n, np.int64)
        lj, upj, _ = JPG.chunk_logits(
            cfg_j, pj, pools_j, tj, jnp.asarray(lengths, jnp.int32), wc_j,
            jnp.asarray(chunk, jnp.int32), jnp.asarray(cl, jnp.int32), seal_j)
        lt, upt, okt = TPG.chunk_logits(cfg_t, pt, pools_t, tt,
                                        torch.from_numpy(lengths), wc_t,
                                        torch.from_numpy(chunk),
                                        torch.from_numpy(cl), seal_t)
        assert bool(okt.all())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(upt[0]["k_new"].numpy(),
                                   np.asarray(upj[0]["k_new"]), rtol=1e-4,
                                   atol=1e-4)
        write(upj, cl)
    for t in range(3):
        step = toks[:, 11 + t][:, None]
        lj, upj, _ = JPG.decode_logits(
            cfg_j, pj, pools_j, tj, jnp.asarray(lengths, jnp.int32), wc_j,
            jnp.asarray(step, jnp.int32), seal_j)
        lt, _, okt = TPG.decode_logits(cfg_t, pt, pools_t, tt,
                                       torch.from_numpy(lengths), wc_t,
                                       torch.from_numpy(step), seal_t)
        assert bool(okt.all())
        assert lt.shape == (B, cfg_t.vocab_size)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)
        write(upj, np.ones((B,), np.int64))
    _assert_pools_equal(pools_j, pools_t, wc_j, wc_t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_sealed_logits_equal_plaintext_exactly(dtype):
    """Decode over still-sealed weights (ColoE, SE 0.5) gives the plaintext
    weights' logits bit for bit."""
    cfg_j, cfg_t = _cfgs(dtype)
    pt = params_from_numpy(jax.tree.map(
        np.asarray, JT.init_params(cfg_j, jax.random.key(1))))
    fp = TSS.fused_params(TSS.seal_params(pt, SealConfig(), KEY), KEY)
    rng = np.random.RandomState(2)
    pools = TMC.paged_pool_init(cfg_t, NB, BS, "cpu")
    tables = torch.from_numpy(_tables())
    wc = torch.zeros((NB,), dtype=torch.int32)
    lengths = torch.zeros((B,), dtype=torch.int64)
    chunk = torch.from_numpy(rng.randint(0, cfg_t.vocab_size, (B, 7)))
    cl = torch.tensor([7, 4])
    lp, up, _ = TPG.chunk_logits(cfg_t, pt, pools, tables, lengths, wc,
                                 chunk, cl, None)
    lf, uf, _ = TPG.chunk_logits(cfg_t, fp, pools, tables, lengths, wc,
                                 chunk, cl, None)
    assert torch.equal(lp, lf)
    assert torch.equal(up[0]["k_new"], uf[0]["k_new"])
    TPG.append_tokens(cfg_t, None, pools, up, tables, lengths, cl, wc)
    step = torch.from_numpy(rng.randint(0, cfg_t.vocab_size, (B, 1)))
    dp, _, _ = TPG.decode_logits(cfg_t, pt, pools, tables, lengths + cl, wc,
                                 step, None)
    df, _, _ = TPG.decode_logits(cfg_t, fp, pools, tables, lengths + cl, wc,
                                 step, None)
    assert torch.equal(dp, df)
