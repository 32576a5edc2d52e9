"""The port's fused decrypt-in-matmul (``kernels.sealed_matmul`` through
``kernels.ops``) held against the JAX package on the CPU, where the wrapper
takes the kernel's plain PyTorch version.

Tolerances: in f32 the port multiplies the whole unsealed weight in one
product while the Pallas kernel accumulates per k-tile, so they agree to f32
summation order — rtol 1e-5, atol 1e-4, the reference's own kernel-vs-oracle
tolerance (tests/test_kernels.py). With bf16 operands 2e-2, as
tests/test_sealed_tensor.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch import u32
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels import sealed_matmul as TSM

KEY = np.frombuffer(bytes(range(32)), np.uint32).copy()


def _u32(rng, shape):
    return rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _sealed_case(m, k, n, bk, bn, ratio, wc, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(k, n).astype(np.float32)
    x = rng.randn(m, k).astype(np.float32)
    mask = rng.rand(k) < ratio
    nonce = _u32(rng, 3)
    ct = np.asarray(JR.seal_weights_ref(jnp.asarray(w), jnp.asarray(KEY),
                                        jnp.asarray(nonce), bk, bn,
                                        jnp.asarray(mask), wc))
    return w, x, mask, nonce, ct


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("wc", [0, 5])
def test_sealed_matmul_plain_matches_oracle(ratio, wc):
    m, k, n, bk, bn = 4, 64, 128, 32, 64
    w, x, mask, nonce, ct = _sealed_case(m, k, n, bk, bn, ratio, wc)
    want = np.asarray(JR.sealed_matmul_ref(
        jnp.asarray(x), jnp.asarray(ct), jnp.asarray(KEY), jnp.asarray(nonce),
        bk, bn, jnp.asarray(mask), wc))
    got = TO.sealed_matmul(torch.from_numpy(x), u32.words(ct),
                           torch.from_numpy(mask), u32.words(KEY),
                           u32.words(nonce), wc, bk=bk, bn=bn)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    own = TR.sealed_matmul_ref(torch.from_numpy(x), u32.words(ct),
                               u32.words(KEY), u32.words(nonce), bk, bn,
                               torch.from_numpy(mask), wc)
    np.testing.assert_allclose(got.numpy(), own.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_sealed_matmul_matches_pallas_interpret():
    """One small shape against the Pallas kernel in interpret mode, with
    bf16 operands, write counter 3 and a ragged M (not a multiple of bm)."""
    m, k, n, bk, bn = 5, 32, 32, 32, 32
    w, x, mask, nonce, ct = _sealed_case(m, k, n, bk, bn, 0.5, 3, seed=2)
    want = np.asarray(JO.sealed_matmul(
        jnp.asarray(x), jnp.asarray(ct), jnp.asarray(mask), jnp.asarray(KEY),
        jnp.asarray(nonce), 3, bm=8, bk=bk, bn=bn, interpret=True,
        compute_dtype="bfloat16"))
    got = TO.sealed_matmul(torch.from_numpy(x), u32.words(ct),
                           torch.from_numpy(mask), u32.words(KEY),
                           u32.words(nonce), 3, bm=8, bk=bk, bn=bn,
                           compute_dtype="bfloat16")
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_sealed_matmul_bf16_rounds_operands():
    m, k, n, bk, bn = 3, 64, 32, 64, 32
    w, x, mask, nonce, ct = _sealed_case(m, k, n, bk, bn, 0.5, 0, seed=3)
    got = TSM.sealed_matmul_plain(torch.from_numpy(x), u32.words(ct),
                                  torch.from_numpy(mask), u32.words(KEY),
                                  u32.words(nonce), 0, bk=bk, bn=bn,
                                  compute_dtype="bfloat16")
    want = jnp.dot(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


def test_ops_pads_m_like_the_reference():
    """M above bm and not a multiple of it is padded and cut back."""
    m, k, n, bk, bn = 9, 32, 32, 32, 32
    w, x, mask, nonce, ct = _sealed_case(m, k, n, bk, bn, 1.0, 1, seed=5)
    got = TO.sealed_matmul(torch.from_numpy(x), u32.words(ct),
                           torch.from_numpy(mask), u32.words(KEY),
                           u32.words(nonce), 1, bm=4, bk=bk, bn=bn)
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("m,n,bk,bn,cdt,want", [
    (3560, 8192, 128, 128, "bfloat16", "sealed_matmul_tc"),  # group prefill
    (65, 128, 8, 16, "bfloat16", "sealed_matmul_tc"),        # the smallest
    (64, 8192, 128, 128, "bfloat16", "sealed_matmul_dec"),   # decode sizes
    (4, 92544, 128, 128, "bfloat16", "sealed_matmul_dec"),
    (3560, 8192, 128, 128, "float32", "sealed_matmul"),      # exact f32 path
    # the decode kernel on every main-path leaf (wq/wo, wk/wv, MLP wi/wg,
    # MLP wo, head) at decode ticks (M = slots) and 32-row chunks
    *[(m, n, 128, 128, "bfloat16", "sealed_matmul_dec")
      for m in (1, 4, 32, 64) for n in (2048, 1024, 8192, 92544)],
    (4, 2048, 128, 128, "float32", "sealed_matmul"),         # f32 at decode
    (32, 8192, 128, 128, "float32", "sealed_matmul"),
    (4, 2056, 128, 8, "bfloat16", "sealed_matmul"),          # bn == 8
    (65, 2048, 128, 128, "bfloat16", "sealed_matmul_tc"),    # M = 65
    (65, 1024, 128, 128, "bfloat16", "sealed_matmul_tc"),
    (4, 96, 32, 32, "bfloat16", "sealed_matmul"),            # N % 64 != 0
    (4, 384, 24, 128, "bfloat16", "sealed_matmul"),          # bk not 2^k
    (3560, 2056, 128, 8, "bfloat16", "sealed_matmul"),       # bn == 8
    (3560, 192, 64, 64, "bfloat16", "sealed_matmul"),        # N % 128 != 0
    (1000, 384, 128, 8, "bfloat16", "sealed_matmul"),        # bn < 16
    (1000, 384, 24, 128, "bfloat16", "sealed_matmul"),       # bk not 2^k
    (1000, 384, 128, 48, "bfloat16", "sealed_matmul"),       # bn not 2^k
])
def test_variant_picks_by_dtype_and_shape(m, n, bk, bn, cdt, want):
    assert TSM._variant(m, n, bk, bn, cdt) == want


_LEAVES = {"wq/wo": (2048, 2048), "wk/wv": (2048, 1024),
           "mlp_wi/wg": (2048, 8192), "mlp_wo": (8192, 2048),
           "head": (2048, 92544)}


@pytest.mark.parametrize("leaf", sorted(_LEAVES))
def test_dec_geometry_keeps_its_promises(leaf):
    """The decode kernel's launch geometry on every main-path leaf of
    internlm2-1.8B and every M it takes: the K split divides K into whole
    64-row slabs, every block has work, the grid fills the H100's 132 SMs,
    and the wgmma width holds M."""
    k, n = _LEAVES[leaf]
    for m in range(1, 65):
        nw, strips, splits, kps = TSM.dec_geometry(m, k, n)
        assert nw in (8, 16, 32, 64) and m <= nw and (nw == 8 or nw // 2 < m)
        assert strips == n // TSM.DEC_BN and n % TSM.DEC_BN == 0
        assert kps % TSM.DEC_BK == 0 and kps * splits == k
        assert strips * splits >= 132


@pytest.mark.parametrize("m", [0, 65])
def test_dec_geometry_refuses_m_out_of_range(m):
    with pytest.raises(ValueError):
        TSM.dec_geometry(m, 2048, 2048)


def test_dense_takes_bf16_x_bitwise():
    """A sealed leaf gives the same bits on the CPU whether x arrives as
    bf16 or as f32 holding the same bf16 values (the kernels round x to the
    compute dtype with the same round-to-nearest)."""
    from repro_torch.config import SealConfig
    from repro_torch.configs import get_reduced
    from repro_torch.core import sealed_store as TSS
    from repro_torch.models import layers as TL
    from repro_torch.models import transformer as TT
    cfg = get_reduced("internlm2_1_8b")
    sp = TSS.seal_params(TT.init_params(cfg, seed=0, device="cpu"),
                         SealConfig(), bytes(range(32)))
    leaf = sp.tensors["blocks/0/mlp/wi"].slice(0)
    rng = np.random.RandomState(4)
    xb = torch.from_numpy(rng.randn(2, 75, leaf.k_size).astype(np.float32)
                          ).to(torch.bfloat16)  # M = 150 rows, padded to 256
    got = TL.dense(xb, leaf, "bsd,df->bsf", torch.bfloat16)
    again = TL.dense(xb.float(), leaf, "bsd,df->bsf", torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 75) + leaf.out_shape
    assert torch.equal(got, again)


@pytest.mark.parametrize("m,bm,rows", [(9, 4, 12), (3, 8, 3), (16, 8, 16),
                                       (70, 128, 70), (130, 128, 256)])
def test_ops_pad_rule_on_cpu_is_the_reference(monkeypatch, m, bm, rows):
    """On the CPU, ops.sealed_matmul hands the kernel's plain version M
    padded as the reference pads it (none when M < bm, else up to a
    multiple of bm), and cuts the result back to M rows."""
    seen = []
    real = TSM.sealed_matmul

    def spy(x, *a, **kw):
        seen.append(x.shape[0])
        return real(x, *a, **kw)

    monkeypatch.setattr(TSM, "sealed_matmul", spy)
    k, n, bk, bn = 32, 32, 32, 32
    w, x, mask, nonce, ct = _sealed_case(m, k, n, bk, bn, 0.5, 2, seed=m)
    got = TO.sealed_matmul(torch.from_numpy(x), u32.words(ct),
                           torch.from_numpy(mask), u32.words(KEY),
                           u32.words(nonce), 2, bm=bm, bk=bk, bn=bn)
    assert seen == [rows] and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-4, atol=1e-3)
