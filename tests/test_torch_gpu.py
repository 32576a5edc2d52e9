"""The port's CUDA kernels and sealed serving on the card, held against the
plain PyTorch versions. Marked ``gpu``: each test asks the ``cuda`` fixture
for the card and skips without one. On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: keystreams bitwise; each fused-matmul kernel (CUDA cores, and
tensor cores at bf16 decode and prefill sizes) against the plain version at
1e-4 of the output scale in f32 and in bf16 (both round the same operands
and sum in f32; only the order of the sums differs), and the decode kernel
bitwise against itself; the CUDA-core flash kernel against
its plain version's f32 result at 2e-5 of the output scale in f32, plus one
bf16 rounding of each element in bf16; the tensor-core flash kernel (bf16,
head dim 64 or 128, probabilities rounded to bf16 before ``p @ v``) under
``flash_attention.bf16_gate``; the card's sealed logits and the group
engine's tokens against the CPU's plain f32 path at 1e-4 relative and
exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch import u32
from repro_torch.config import SealConfig
from repro_torch.configs import get_reduced
from repro_torch.kernels import chacha20 as CC
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sealed_matmul as SMK
from repro_torch.models import transformer as T
from repro_torch.serve.engine import GroupServeEngine, ServeEngine
from repro_torch.tree import map_leaves

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); run on the card")
    return torch.device("cuda")


def _words(gen, shape, dev):
    return torch.randint(-2**31, 2**31, shape, generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("n", [1, 300, 4097])
@pytest.mark.parametrize("per_block", [False, True])
def test_chacha_kernel_bitwise(cuda, n, per_block):
    gen = torch.Generator(device=cuda).manual_seed(n)
    key = _words(gen, (8,), cuda)
    ctr = _words(gen, (n,), cuda)
    nz = _words(gen, (n, 3) if per_block else (3,), cuda)
    got = CC.chacha20_blocks(key, ctr, nz)
    torch.cuda.synchronize()
    assert torch.equal(got, CC.chacha20_blocks_plain(key, ctr, nz))


@pytest.mark.parametrize("m,k,n,bk,bn", [(4, 256, 192, 128, 64),
                                         (33, 128, 136, 64, 8),
                                         (70, 96, 32, 32, 32),
                                         # bf16: the tensor-core kernel
                                         (65, 512, 128, 128, 128),
                                         (200, 192, 384, 64, 16),
                                         (1000, 96, 256, 32, 32),
                                         (300, 1024, 640, 128, 128)])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_sealed_matmul_kernel_matches_plain(cuda, m, k, n, bk, bn, cdt):
    gen = torch.Generator(device=cuda).manual_seed(m * k)
    w = torch.randn((k, n), generator=gen, device=cuda)
    x = torch.randn((m, k), generator=gen, device=cuda)
    mask = torch.rand((k,), generator=gen, device=cuda) < 0.5
    key, nonce = _words(gen, (8,), cuda), _words(gen, (3,), cuda)
    wc = torch.tensor(u32.const(3), dtype=torch.int32, device=cuda)
    ct = ref.seal_weights_ref(w, key, nonce, bk, bn, mask, wc)
    variant = SMK._variant(m, n, bk, bn, cdt)
    before = ops.launch_counts()[variant]
    got = ops.sealed_matmul(x, ct, mask, key, nonce, wc, bk=bk, bn=bn,
                            compute_dtype=cdt)
    torch.cuda.synchronize()
    assert ops.launch_counts()[variant] == before + 1
    want = SMK.sealed_matmul_plain(x, ct, mask, key, nonce, wc, bk=bk, bn=bn,
                                   compute_dtype=cdt)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("m,k,n,bk,bn", [(1, 256, 64, 128, 64),
                                         (5, 512, 192, 64, 16),
                                         (17, 1024, 128, 128, 128),
                                         (33, 200, 320, 8, 64),
                                         (64, 2048, 1024, 128, 128)])
@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("wc", [0, 5])
def test_sealed_matmul_dec_kernel(cuda, m, k, n, bk, bn, ratio, wc):
    """The decode kernel (bf16, M <= 64): ragged M, a K that is not a
    multiple of its 64-row slab, SE 0/0.5/1, two write counters; one launch
    counted per call, and two launches give the same bits (the split-K sum
    runs in split order)."""
    gen = torch.Generator(device=cuda).manual_seed(m * n + int(10 * ratio))
    w = torch.randn((k, n), generator=gen, device=cuda)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    mask = torch.rand((k,), generator=gen, device=cuda) < ratio
    key, nonce = _words(gen, (8,), cuda), _words(gen, (3,), cuda)
    wcw = torch.tensor(u32.const(wc), dtype=torch.int32, device=cuda)
    ct = ref.seal_weights_ref(w, key, nonce, bk, bn, mask, wcw)
    assert SMK._variant(m, n, bk, bn, "bfloat16") == "sealed_matmul_dec"
    before = ops.launch_counts()
    got = ops.sealed_matmul(x, ct, mask, key, nonce, wcw, bk=bk, bn=bn,
                            compute_dtype="bfloat16")
    again = ops.sealed_matmul(x, ct, mask, key, nonce, wcw, bk=bk, bn=bn,
                              compute_dtype="bfloat16")
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert {name: after[name] - before[name] for name in after} == {
        name: 2 if name == "sealed_matmul_dec" else 0 for name in after}
    assert torch.equal(got, again)
    want = SMK.sealed_matmul_plain(x, ct, mask, key, nonce, wcw, bk=bk, bn=bn,
                                   compute_dtype="bfloat16")
    assert got.shape == (m, n)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("m", [24, 32])
def test_sealed_matmul_dec_kernel_repeats_at_width(cuda, m):
    """Many blocks a wave, long K loops and no pads (SE 0, the fastest
    consumers): ten launches in a row all give the plain version's result,
    so no warpgroup reads a ring stage before its load has landed."""
    k, n = 2048, 32768
    gen = torch.Generator(device=cuda).manual_seed(m)
    w = torch.randn((k, n), generator=gen, device=cuda)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    mask = torch.zeros((k,), dtype=torch.bool, device=cuda)
    key, nonce = _words(gen, (8,), cuda), _words(gen, (3,), cuda)
    wcw = torch.tensor(u32.const(0), dtype=torch.int32, device=cuda)
    ct = ref.seal_weights_ref(w, key, nonce, 128, 128, mask, wcw)
    want = SMK.sealed_matmul_plain(x, ct, mask, key, nonce, wcw, bk=128,
                                   bn=128, compute_dtype="bfloat16")
    for _ in range(10):
        got = SMK.sealed_matmul_dec_cuda(x, ct, mask, key, nonce, wcw,
                                         bk=128, bn=128)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


def test_sealed_serving_on_the_card_matches_cpu(cuda):
    cfg = get_reduced("internlm2_1_8b").with_(dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (5, 19, 40)]
    outs = []
    for dev, seal in (("cpu", None), (cuda, SealConfig())):
        eng = ServeEngine(cfg, map_leaves(lambda t: t.to(dev), params),
                          batch_slots=2, max_len=64, chunk_tokens=8,
                          seal=seal, device=dev)
        hs = [eng.submit(p, max_tokens=6) for p in prompts]
        eng.run()
        outs.append([h.out for h in hs])
    assert outs[0] == outs[1]


FLASH_CASES = [  # b, s, t, hq, hkv, dh, window, softcap
    (2, 256, 256, 4, 2, 32, 0, 0.0),        # the reference test's grid
    (1, 512, 512, 8, 1, 32, 128, 50.0),
    (2, 256, 256, 6, 6, 16, 0, 0.0),
    (1, 128, 128, 2, 2, 64, 32, 0.0),
    (2, 200, 200, 4, 2, 128, 0, 0.0),       # ragged tail, internlm2 heads
    (1, 300, 300, 4, 2, 256, 100, 30.0),    # gemma2-like head dim
    (1, 96, 160, 2, 1, 64, 0, 0.0),         # s < t: top-left causal
    (2, 333, 333, 8, 2, 128, 0, 0.0),       # ragged 128-row q tiles
    (1, 700, 700, 4, 4, 64, 200, 30.0),     # window edges inside tiles
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, s, t, hq, hkv, dh, win, cap = case
    gen = torch.Generator(device=cuda).manual_seed(s * dh + win)
    # q is a strided view (heads sliced out of a wider tensor), as the
    # model hands it over
    q = torch.randn((b, s, hq + 1, dh), generator=gen, device=cuda)[:, :, 1:]
    k = torch.randn((b, t, hkv, dh), generator=gen, device=cuda)
    v = torch.randn((b, t, hkv, dh), generator=gen, device=cuda)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    kw = dict(scale=dh ** -0.5, softcap=cap, window=win)
    variant = FA._variant(dtype, dh)
    before = ops.launch_counts()[variant]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()[variant] == before + 1
    assert got.dtype == dtype and got.shape == (b, s, hq, dh)
    if variant == "flash_attention_tc":
        ok, share, rms = FA.bf16_gate(q, k, v, got, **kw)
        assert ok, (share, rms)
        return
    # the plain version's f32 result on the same inputs, before rounding to
    # the output dtype: f32 agrees to 2e-5 of the scale, and bf16 adds one
    # rounding of each element (2^-8 of its size)
    want = FA.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    allowed = 2e-5 * want.abs().max()
    if dtype == torch.bfloat16:
        allowed = allowed + 2.0 ** -8 * want.abs()
    diff = (got.float() - want).abs()
    assert bool((diff <= allowed).all()), float((diff / allowed).max())


def test_group_engine_on_the_card_matches_cpu(cuda):
    """The sealed group engine (one-shot prefill through the flash kernel)
    on the card emits the CPU plaintext engine's greedy tokens, in f32."""
    cfg = get_reduced("internlm2_1_8b").with_(dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (7, 19, 40, 33)]
    outs = []
    for dev, seal in (("cpu", None), (cuda, SealConfig())):
        eng = GroupServeEngine(cfg, map_leaves(lambda t: t.to(dev), params),
                               batch_slots=2, max_len=64, seal=seal,
                               device=dev)
        hs = [eng.submit(p, max_tokens=6) for p in prompts]
        eng.run()
        outs.append([h.out for h in hs])
    assert outs[0] == outs[1]
