"""The port's CUDA kernels and sealed serving on the card, held against the
plain PyTorch versions. Marked ``gpu``: each test asks the ``cuda`` fixture
for the card and skips without one. On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: keystreams bitwise, and so are the kernels that make their pads
inside the pass that uses them (the paged cache's view, splice,
copy-on-write, MAC tags and MAC check, the line layout's unseal and row
gather: each
against its plain version, twice), and so are the card's prefix-sharing and
verified cache paths against the CPU's;
each fused-matmul kernel (CUDA cores, and
tensor cores at bf16 decode and prefill sizes) against the plain version at
1e-4 of the output scale in f32 and in bf16 (both round the same operands
and sum in f32; only the order of the sums differs), and the decode kernel
bitwise against itself; the CUDA-core flash kernel against
its plain version's f32 result at 2e-5 of the output scale in f32, plus one
bf16 rounding of each element in bf16; the tensor-core flash kernels (bf16,
head dim 64, 128 or 256, probabilities rounded to bf16 before ``p @ v``) under
``flash_attention.bf16_gate``; the card's sealed logits and the group
engine's tokens against the CPU's plain f32 path at 1e-4 relative and
exactly; the AES kernel (FIPS-197, blocks, Direct lines) bitwise against
its plain version, and Direct serving on the card equal to the CPU's;
the paper's CNNs (reduced VGG-16, ResNet-18, ResNet-34) on the card
against the CPU: ``init_cnn`` within 1e-6 relative (``prng.normal``'s
tolerance), logits, loss and the gradients with respect to every parameter
and the input at 1e-4 of each tensor's scale, ``cnn_channel_masks`` equal,
a full-width VGG-16 conv (cuDNN with TF32 off) at 1e-5 of its scale, and a
tiny ``evaluate(device=None)`` report within 0.05 of the CPU's; the flash
kernel and the fused matmul refusing inputs that require grad, and a
reduced internlm2's training gradients on the card (every attention weight
reached) against the CPU's at 1e-4 of each tensor's scale; the paper's
five weight-sealing variants of ``launch/sealed_dryrun.py`` at the reduced
granite in f32, the card's first-step logits against the CPU's at 1e-4
relative and the unfused variants' bitwise equal to the baseline's, with
one ``lines_unseal`` a line leaf holding ciphertext and one CUDA-core fused
matmul a tile slice each step.
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
    # head dim 256 (csrc/flash_attention_tc256.cu in bf16): MQA 16:1 past
    # its window, ragged 64-row tiles; GQA 2:1 with s < t and softcap 50;
    # MHA, an odd group, on one warpgroup a block
    (2, 333, 333, 16, 1, 256, 200, 0.0),
    (1, 100, 230, 4, 2, 256, 0, 50.0),
    (1, 1100, 1100, 16, 16, 256, 300, 0.0),
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
    kernel = FA._kernel(dtype, dh)
    before = ops.launch_counts()[kernel]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()[kernel] == before + 1
    assert got.dtype == dtype and got.shape == (b, s, hq, dh)
    if kernel != "flash_attention":
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


@pytest.mark.parametrize("case", [
    (2, 333, 333, 16, 1, 256, 200, 0.0),    # MQA 16:1 past its window
    (1, 100, 230, 4, 2, 256, 0, 50.0),      # GQA 2:1, s < t, softcap 50
], ids=str)
def test_flash_tc256_grids_agree(cuda, case):
    """The dh-256 kernel's two grids (one q head of 64 rows a block, or two
    q heads of one kv head a block) give the same bits, inside
    ``bf16_gate``; an odd group is refused the paired grid."""
    b, s, t, hq, hkv, dh, win, cap = case
    gen = torch.Generator(device=cuda).manual_seed(s + hq)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(
        torch.bfloat16) for shape in ((b, s, hq, dh), (b, t, hkv, dh),
                                      (b, t, hkv, dh)))
    kw = dict(scale=dh ** -0.5, softcap=cap, window=win)
    one, two = (FA.flash_attention_tc256_cuda(q, k, v, warpgroups=w, **kw)
                for w in (1, 2))
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    ok, share, rms = FA.bf16_gate(q, k, v, two, **kw)
    assert ok, (share, rms)
    with pytest.raises(RuntimeError, match="launch failed"):
        FA.flash_attention_tc256_cuda(q.new_zeros((b, s, 3 * hkv, dh)), k,
                                      v, warpgroups=2, **kw)


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


def _launched(before, name, n):
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: n if k == name else 0 for k in after}


def _pools(gen, dev, n, nb, wpb):
    """A stacked (n, NB, wpb) pool pair of random words, sliced from a
    wider buffer so that rows are strided as a view of a larger pool."""
    wide = _words(gen, (2, n, nb, wpb + 8), dev)
    return wide[0, :, :, :wpb], wide[1, :, :, :wpb]


# (wpb, wpt): whole 16-word units (16-byte paths) and a partial final unit
# with a unit spanning several tokens
CACHE_GEOMS = [(512, 32), (8192, 512), (24, 6), (40, 10)]


@pytest.mark.parametrize("wpb,wpt", CACHE_GEOMS)
def test_cache_view_kernel_bitwise(cuda, wpb, wpt):
    """One layer's view: lengths 0, partial and full, write counters at and
    near 2^32 - 1, strided pool rows; two launches equal the plain
    version's words."""
    gen = torch.Generator(device=cuda).manual_seed(wpb)
    bs = wpb // wpt
    b, mb, n = 4, 5, 2
    nb = 1 + b * mb
    pk, pv = _pools(gen, cuda, n, nb, wpb)
    tables = torch.randperm(nb - 1, generator=gen, device=cuda)[:b * mb]
    tables = (1 + tables).reshape(b, mb)
    lengths = torch.tensor([0, 1, bs * mb, bs * 2 + 3], device=cuda)
    wc = _words(gen, (nb,), cuda)
    wc[1::3] = -1                                   # 2^32 - 1
    key = _words(gen, (8,), cuda)
    lids = torch.tensor([7, -2], dtype=torch.int32, device=cuda)
    nk, nv = (1, 2, 3), (2**32 - 1, 5, 2**31)
    i = 1
    before = ops.launch_counts()
    got = [CC.cache_view(key, nk, nv, pk[i], pv[i], lids[i], tables, lengths,
                         wc, wpt) for _ in range(2)]
    torch.cuda.synchronize()
    _launched(before, "chacha20_cache_view", 2)
    want = CC.cache_view_plain(key, nk, nv, pk[i], pv[i], lids[i], tables,
                               lengths, wc, wpt)
    assert torch.equal(got[0], want) and torch.equal(got[1], want)


@pytest.mark.parametrize("wpb,wpt", CACHE_GEOMS)
@pytest.mark.parametrize("c", [1, 5, 32])
def test_cache_splice_kernel_bitwise(cuda, wpb, wpt, c):
    """A write over every layer, k and v: rows with counts 0, 1 and C, at
    offsets inside a block and at a block's end, write counters at 2^32 - 1;
    the pools after two kernel launches (on two copies) equal the plain
    composition's, word for word."""
    gen = torch.Generator(device=cuda).manual_seed(wpb * c)
    bs = wpb // wpt
    b, n = 4, 3
    mb = 2 + (c + bs - 1) // bs + 1
    nb = 1 + b * mb
    pk, pv = _pools(gen, cuda, n, nb, wpb)
    tables = (1 + torch.arange(b * mb, device=cuda)).reshape(b, mb)
    lengths = torch.tensor([0, bs - 1, 3, bs], device=cuda)
    counts = torch.tensor([c, min(c, 2), 0, c], device=cuda)
    new_k = _words(gen, (n, b, c, wpt), cuda)
    new_v = _words(gen, (n, b, c, wpt), cuda)
    wc = _words(gen, (nb,), cuda)
    wc[::2] = -1
    key = _words(gen, (8,), cuda)
    lids = torch.tensor([0, 1, -1], dtype=torch.int32, device=cuda)
    nk, nv = (9, 8, 7), (2**32 - 1, 0, 1)
    args = (lids, new_k, new_v, tables, lengths, counts, wc, bs)
    want = [pk.clone(), pv.clone()]
    CC.cache_splice_plain(key, nk, nv, *want, *args)
    before = ops.launch_counts()
    for _ in range(2):
        got = [pk.clone(), pv.clone()]
        CC.cache_splice(key, nk, nv, *got, *args)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _launched(before, "chacha20_cache_splice", 2)
    assert not torch.equal(want[0], pk)             # the write landed


def _sealed_lines(gen, dev, n_lines, scheme):
    """Random line-sealed words: the kernels are XOR involutions, so any
    words, write counters (some at 2^32 - 1) and flags (mixed) will do."""
    if scheme == "coloe":
        payload = _words(gen, (n_lines, 34), dev)
        payload[::3, 32] = -1
        return payload, None
    counters = _words(gen, (n_lines,), dev)
    counters[::3] |= 0x7FFFFFFF
    return _words(gen, (n_lines, 32), dev), counters


@pytest.mark.parametrize("scheme", ["coloe", "counter"])
@pytest.mark.parametrize("orig_len", [32, 1000, 4097])
def test_lines_unseal_kernel_bitwise(cuda, scheme, orig_len):
    gen = torch.Generator(device=cuda).manual_seed(orig_len)
    payload, counters = _sealed_lines(gen, cuda, -(-orig_len // 32), scheme)
    key = _words(gen, (8,), cuda)
    before = ops.launch_counts()
    got = [CC.lines_unseal(key, payload, counters, orig_len, (5, 2**32 - 2))
           for _ in range(2)]
    torch.cuda.synchronize()
    _launched(before, "chacha20_lines_unseal", 2)
    want = CC.lines_unseal_plain(key, payload, counters, orig_len,
                                 (5, 2**32 - 2))
    assert torch.equal(got[0], want) and torch.equal(got[1], want)


@pytest.mark.parametrize("scheme", ["coloe", "counter"])
@pytest.mark.parametrize("d", [2048, 64, 24, 40, 33])
@pytest.mark.parametrize("src,out", [(torch.float32, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)],
                         ids=str)
def test_lines_gather_rows_kernel_bitwise(cuda, scheme, d, src, out):
    """Rows on and off line boundaries (D*itemsize not a multiple of 64),
    the first and last row, repeated rows; the words are real values of
    the source type so the bf16 rounding meets every case it can."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    vocab = 300
    n_words = -(-vocab * d * torch.empty((), dtype=src).element_size() // 4)
    payload, counters = _sealed_lines(gen, cuda, -(-n_words // 32), scheme)
    key = _words(gen, (8,), cuda)
    tokens = torch.tensor([[0, vocab - 1, 7], [7, 150, 299]], device=cuda)
    before = ops.launch_counts()
    got = [CC.lines_gather_rows(key, payload, counters, (3, 4), (vocab, d),
                                src, tokens, out) for _ in range(2)]
    torch.cuda.synchronize()
    _launched(before, "chacha20_lines_gather", 2)
    want = CC.lines_gather_rows_plain(key, payload, counters, (3, 4),
                                      (vocab, d), src, tokens, out)
    assert got[0].shape == (2, 3, d) and got[0].dtype == out
    for g in got:
        assert torch.equal(g.view(torch.int16 if out == torch.bfloat16
                                  else torch.int32),
                           want.view(torch.int16 if out == torch.bfloat16
                                     else torch.int32))


# the copy-on-write and tag kernels also meet a block of a length that is
# not a multiple of 4 words (no 16-byte path for the tags)
COPY_GEOMS = CACHE_GEOMS + [(18, 6)]


@pytest.mark.parametrize("wpb,wpt", COPY_GEOMS)
@pytest.mark.parametrize("shift", [0, 1], ids=["aligned", "misaligned"])
def test_cache_copy_kernel_bitwise(cuda, wpb, wpt, shift):
    """The copy-on-write re-key over every layer, k and v: two pairs and a
    masked one, write counters at 2^32 - 1, rows strided (and, shifted by
    a word, not 16-byte aligned); the pools after two launches (on two
    copies) equal the plain version's, word for word, and the masked pair
    writes nothing."""
    gen = torch.Generator(device=cuda).manual_seed(wpb + shift)
    n, nb = 3, 12
    wide = _words(gen, (2, n, nb, wpb + 8), cuda)
    pk, pv = wide[0, :, :, shift:wpb + shift], wide[1, :, :, shift:wpb + shift]
    wc = _words(gen, (nb,), cuda)
    wc[::2] = -1
    key = _words(gen, (8,), cuda)
    lids = torch.tensor([0, 5, -1], dtype=torch.int32, device=cuda)
    src = torch.tensor([3, 7, 2], device=cuda)
    dst = torch.tensor([9, 10, 11], device=cuda)
    mask = torch.tensor([True, True, False], device=cuda)
    nk, nv = (9, 8, 7), (2**32 - 1, 0, 1)
    args = (lids, src, dst, mask, wc)
    want = [pk.clone(), pv.clone()]
    CC.cache_copy_plain(key, nk, nv, *want, *args)
    before = ops.launch_counts()
    for _ in range(2):
        got = [pk.clone(), pv.clone()]
        CC.cache_copy(key, nk, nv, *got, *args)
        torch.cuda.synchronize()
        # the plain version rewrites the scratch block with its own words
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[0][:, 11], pk[:, 11])      # masked: untouched
    _launched(before, "chacha20_cache_copy", 2)
    assert not torch.equal(want[0][:, 9], pk[:, 9])      # the copy landed


@pytest.mark.parametrize("wpb,wpt", COPY_GEOMS)
@pytest.mark.parametrize("shift", [0, 1], ids=["aligned", "misaligned"])
def test_cache_tags_kernel_bitwise(cuda, wpb, wpt, shift):
    """Tags of a list of blocks (repeats and dead entries) over every layer,
    k and v, with words at 0xFFFFFFFF and bit 31, write counters at
    2^32 - 1 and a layer id of 2^32 - 1: two launches equal the plain
    version's tags bitwise, 0 on dead entries."""
    from repro_torch.core.mac import mac_context
    gen = torch.Generator(device=cuda).manual_seed(3 * wpb + shift)
    n, nb = 3, 12
    wide = _words(gen, (2, n, nb, wpb + 8), cuda)
    wide[0, :, :, ::5] = -1
    wide[1, :, :, 1::3] |= -2**31
    pk, pv = wide[0, :, :, shift:wpb + shift], wide[1, :, :, shift:wpb + shift]
    wc = _words(gen, (nb,), cuda)
    wc[::2] = -1
    ctx = mac_context(bytes(range(32)), "kvcache", cuda)
    lids = torch.tensor([0, 5, -1], dtype=torch.int32, device=cuda)
    blocks = torch.tensor([3, 0, 11, 3, 7], device=cuda)
    live = torch.tensor([True, False, True, True, True], device=cuda)
    args = (ctx.key_words, ctx.hash_keys(wpb), ctx.nonce((9, 8, 7)),
            ctx.nonce((2**32 - 1, 0, 1)), pk, pv, lids, blocks, live, wc)
    want = CC.cache_tags_plain(*args)
    before = ops.launch_counts()
    got = [CC.cache_tags(*args) for _ in range(2)]
    torch.cuda.synchronize()
    _launched(before, "chacha20_cache_tags", 2)
    assert torch.equal(got[0], want) and torch.equal(got[1], want)
    assert not bool(want[:, :, 1].any()) and bool(want[:, :, 0].all())


@pytest.mark.parametrize("wpb,wpt", COPY_GEOMS)
@pytest.mark.parametrize("shift", [0, 1], ids=["aligned", "misaligned"])
def test_cache_verify_kernel_bitwise(cuda, wpb, wpt, shift):
    """A pass's check over every layer, k and v: with the stored tags
    right, then with a flipped word in a resident block of the first and of
    the last layer and one past a slot's length (lengths 0, partial and
    full, a repeated table entry), two launches equal the plain version's
    verdict; each launch counted."""
    from repro_torch.core.mac import mac_context
    gen = torch.Generator(device=cuda).manual_seed(5 * wpb + shift)
    n, nb, b, mb = 3, 12, 4, 3
    bs = wpb // wpt
    wide = _words(gen, (2, n, nb, wpb + 8), cuda)
    wide[0, :, :, ::5] = -1
    wide[1, :, :, 1::3] |= -2**31
    pk, pv = wide[0, :, :, shift:wpb + shift], wide[1, :, :, shift:wpb + shift]
    wc = _words(gen, (nb,), cuda)
    wc[::2] = -1
    ctx = mac_context(bytes(range(32)), "kvcache", cuda)
    lids = torch.tensor([0, 5, -1], dtype=torch.int32, device=cuda)
    tables = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 4]],
                          device=cuda)
    lengths = torch.tensor([0, bs + 1, 3 * bs, 2 * bs], device=cuda)
    nonces = (ctx.nonce((9, 8, 7)), ctx.nonce((2**32 - 1, 0, 1)))
    hk = ctx.hash_keys(wpb)
    blocks = torch.arange(nb, device=cuda)
    tags = CC.cache_tags_plain(ctx.key_words, hk, *nonces, pk, pv, lids,
                               blocks, torch.ones_like(blocks, dtype=torch.bool),
                               wc)
    mac_k, mac_v = tags[:, 0].contiguous(), tags[:, 1].contiguous()
    flips = ((None, [True] * 4), ((0, 0, 5), [True, False, True, True]),
             ((1, n - 1, 9), [True, True, False, True]),
             ((0, n - 1, 6), [True] * 4))         # slot 1, past its length
    for flip, verdict in flips:
        if flip is not None:
            wide[flip[0], flip[1], flip[2], shift + 1] ^= 1 << 7
        args = (ctx.key_words, hk, *nonces, pk, pv, mac_k, mac_v, lids,
                tables, lengths, wc, bs)
        want = CC.cache_verify_plain(*args)
        before = ops.launch_counts()
        got = [CC.cache_verify(*args) for _ in range(2)]
        torch.cuda.synchronize()
        _launched(before, "chacha20_cache_verify", 2)
        assert torch.equal(got[0], want) and torch.equal(got[1], want)
        assert want.tolist() == verdict
        if flip is not None:
            wide[flip[0], flip[1], flip[2], shift + 1] ^= 1 << 7


def _cow_sequence(dev, verify):
    """A donor writes 7 tokens, a sharer copies the donor's tail block and
    writes 6 more into the copy, through ``models/paged.py`` with a sealed
    cache (MACs armed when ``verify``). Returns the pools, counters and
    the sharer's verdict of its layer-0 blocks."""
    from repro_torch.core import sealed_store as SS
    from repro_torch.models import cache as MC
    from repro_torch.models import paged as PG
    cfg = get_reduced("internlm2_1_8b")
    rng = np.random.RandomState(3)
    bs, nb = 4, 9
    seal = SS.cache_seal_config(bytes(range(32)), dev, verify=verify)
    pools = MC.paged_pool_init(cfg, nb, bs, dev)
    wc = torch.zeros((nb,), dtype=torch.int32, device=dev)
    n = cfg.n_superblocks()

    def write(table, length, count, c):
        shape = (n, 1, c, cfg.num_kv_heads, cfg.head_dim)
        ups = ({key: torch.from_numpy(rng.randn(*shape).astype(np.float32))
                .to(torch.bfloat16).to(dev) for key in ("k_new", "v_new")},)
        PG.append_tokens(cfg, seal, pools, ups,
                         torch.tensor([table], device=dev),
                         torch.tensor([length], device=dev),
                         torch.tensor([count], device=dev), wc)

    write([1, 2, 3, 4], 0, 7, 8)
    ok = PG.copy_blocks(cfg, seal, pools, wc, torch.tensor([2, 0], device=dev),
                        torch.tensor([5, 0], device=dev),
                        torch.tensor([True, False], device=dev))
    write([1, 5, 6, 7], 6, 5, 5)
    write([1, 5, 6, 7], 11, 1, 1)
    table = torch.tensor([[1, 5, 6, 7]], device=dev)
    length = torch.tensor([12], device=dev)
    PG._dense_view(cfg, seal, {key: pools[0][key][0] for key in pools[0]},
                   table, length, wc)
    view_ok = None if seal.mac is None else PG._verify(
        seal, {key: pools[0][key][:1] for key in pools[0]}, table, length,
        wc, bs)
    return pools, wc, bool(ok), view_ok


@pytest.mark.parametrize("verify", [False, True])
def test_append_into_cowed_shared_tail_on_the_card(cuda, verify):
    """The shared-tail append through the kernels (copy, splice, tags, view)
    equals the CPU's plain path word for word: the copy finishes in stream
    order before the sharer's first splice into its private block."""
    before = ops.launch_counts()
    got = _cow_sequence(cuda, verify)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    want = _cow_sequence("cpu", verify)
    for key in ("k", "v", "mac_k", "mac_v"):
        assert torch.equal(got[0][0][key].cpu(), want[0][0][key]), key
    assert torch.equal(got[1].cpu(), want[1])
    assert got[2] and want[2]
    assert (got[3] is None) == (not verify)
    if verify:
        assert bool(got[3].all())
    assert after["chacha20_cache_copy"] - before["chacha20_cache_copy"] == 1
    assert after["chacha20_cache_splice"] - before["chacha20_cache_splice"] \
        == 3
    # three writes and the copy's check and tag; the view's verdict is one
    # verify launch
    assert after["chacha20_cache_tags"] - before["chacha20_cache_tags"] == \
        (5 if verify else 0)
    assert after["chacha20_cache_verify"] - before["chacha20_cache_verify"] \
        == (1 if verify else 0)


def test_prefix_sharing_verified_serving_on_the_card_matches_cpu(cuda):
    """Prefix sharing and verification together through the engine: the
    card's streams and stats equal the CPU plain path's (f32), each
    copy-on-write one ``cache_copy`` launch."""
    cfg = get_reduced("internlm2_1_8b").with_(dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(2)
    base = rng.randint(0, cfg.vocab_size, 27)
    prompts = [base, base, np.concatenate([base[:20], rng.randint(
        0, cfg.vocab_size, 9)])]
    runs = []
    for dev in ("cpu", cuda):
        eng = ServeEngine(cfg, map_leaves(lambda t: t.to(dev), params),
                          batch_slots=2, max_len=48, seal_cache=True,
                          prefix_share=True, verify=True, device=dev)
        before = ops.launch_counts()
        hs = [eng.submit(prompts[0], max_tokens=5)]
        for _ in range(3):
            eng.step()
        hs += [eng.submit(p, max_tokens=5) for p in prompts[1:]]
        eng.run()
        after = ops.launch_counts()
        runs.append(([h.out for h in hs], dict(eng.stats), {
            k: after[k] - before[k] for k in after}))
        eng.check_device_mirror()
    (cpu_out, cpu_stats, cpu_n), (gpu_out, gpu_stats, gpu_n) = runs
    assert gpu_out == cpu_out and gpu_stats == cpu_stats
    assert not any(cpu_n.values())
    assert gpu_stats["cow_copies"] >= 1 and gpu_stats["mac_failures"] == 0
    assert gpu_n["chacha20_cache_copy"] == gpu_stats["cow_copies"]


@pytest.mark.parametrize("k,n,bk,bn,lead,shift", [
    (256, 512, 128, 128, (2,), 0), (64, 96, 32, 32, (), 0),
    (40, 24, 8, 8, (3,), 0), (128, 256, 128, 64, (1,), 1),
    (16, 128, 16, 16, (), 3)], ids=str)
def test_tile_tags_kernel_bitwise(cuda, k, n, bk, bn, lead, shift):
    """Weight tile tags, stacked and not, over random SE masks (bypass
    tiles too), write counters at 2^32 - 1, words at 0xFFFFFFFF and bit 31,
    and a payload that starts off a 16-byte boundary (shift words in): two
    launches equal the plain version's tags bitwise."""
    from repro_torch.core.mac import mac_context
    gen = torch.Generator(device=cuda).manual_seed(k * n + shift)
    size = 1
    for d in lead + (k, n):
        size *= d
    flat = _words(gen, (size + 8,), cuda)
    flat[::7] = -1
    flat[1::3] |= -2**31
    ct = flat[shift:shift + size].view(lead + (k, n))
    mask = torch.rand(lead + (k,), generator=gen, device=cuda) < 0.5
    mask[..., :bk] = False
    wc = _words(gen, lead, cuda)
    wc.view(-1)[::2] = -1
    ctx = mac_context(bytes(range(32)), "weights", cuda)
    args = (ctx.key_words, ctx.hash_keys(bk * bn), ctx.nonce((5, 2**32 - 1, 9)),
            ct, mask, wc, bk, bn)
    want = CC.tile_tags_plain(*args)
    before = ops.launch_counts()
    got = [CC.tile_tags(*args) for _ in range(2)]
    torch.cuda.synchronize()
    _launched(before, "chacha20_weight_tile_tags", 2)
    assert torch.equal(got[0], want) and torch.equal(got[1], want)


@pytest.mark.parametrize("scheme", ["coloe", "counter"])
@pytest.mark.parametrize("n_lines,line0", [(1, 0), (127, 3), (1000, 2**32 - 5)])
def test_line_tags_kernel_bitwise(cuda, scheme, n_lines, line0):
    """Weight line tags for ColoE records and the counter layout (its
    counter word read where it lies), partial blocks of lines and line
    addresses that wrap: two launches equal the plain version bitwise."""
    from repro_torch.core.mac import mac_context
    gen = torch.Generator(device=cuda).manual_seed(n_lines)
    width = 34 if scheme == "coloe" else 32
    payload = _words(gen, (n_lines, width), cuda)
    payload[:, ::5] = -1
    counters = None if scheme == "coloe" else _words(gen, (n_lines,), cuda)
    ctx = mac_context(bytes(range(32)), "weights", cuda)
    args = (ctx.key_words, ctx.hash_keys(34 if scheme == "coloe" else 33),
            ctx.nonce((7, 8, 0)), payload, counters, line0)
    want = CC.line_tags_plain(*args)
    before = ops.launch_counts()
    got = [CC.line_tags(*args) for _ in range(2)]
    torch.cuda.synchronize()
    _launched(before, "chacha20_weight_line_tags", 2)
    assert torch.equal(got[0], want) and torch.equal(got[1], want)


@pytest.mark.parametrize("mode", ["coloe", "counter"])
def test_verified_sealed_weights_on_the_card_match_cpu(cuda, mode):
    """Sealing with MACs and the weight sweep on the card: every leaf's
    tags equal the CPU's, ``verify_params`` is True with one tag launch a
    leaf, False after a flipped word; a verified sampled engine's streams
    and stats equal the CPU plain path's (f32)."""
    from repro_torch.core import sealed_store as SS
    cfg = get_reduced("internlm2_1_8b").with_(dtype="float32", num_layers=4)
    params = T.init_params(cfg, seed=0, device="cpu")
    seal = SealConfig(mode=mode, verify=True)
    key = bytes(range(32))
    sp_cpu = SS.seal_params(params, seal, key)
    sp_gpu = SS.seal_params(map_leaves(lambda t: t.to(cuda), params), seal,
                            key)
    for path, st in sp_cpu.tensors.items():
        assert torch.equal(sp_gpu.tensors[path].macs.cpu(), st.macs), path
    before = ops.launch_counts()
    ok = SS.verify_params(sp_gpu, key)
    after = ops.launch_counts()
    tiles = sum(t.meta.layout == "tiles" for t in sp_gpu.tensors.values())
    assert bool(ok) and ok.is_cuda
    assert after["chacha20_weight_tile_tags"] - \
        before["chacha20_weight_tile_tags"] == tiles
    assert after["chacha20_weight_line_tags"] - \
        before["chacha20_weight_line_tags"] == len(sp_gpu.tensors) - tiles
    sp_gpu.tensors["head/w"].payload[3, 4] ^= 1
    assert not bool(SS.verify_params(sp_gpu, key))
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (9, 21, 14)]
    settings = [dict(temperature=0.8), dict(temperature=1.0, top_k=5),
                dict(temperature=0.7, top_p=0.9)]
    runs = []
    for dev in ("cpu", cuda):
        eng = ServeEngine(cfg, map_leaves(lambda t: t.to(dev), params),
                          batch_slots=2, max_len=48, seal=SealConfig(mode=mode),
                          verify=True, sample_seed=3, device=dev)
        hs = [eng.submit(p, max_tokens=6, **kw)
              for p, kw in zip(prompts, settings)]
        eng.run()
        runs.append(([h.out for h in hs], dict(eng.stats)))
    assert runs[1] == runs[0]
    assert runs[0][1]["mac_failures"] == 0 and runs[0][1]["mac_checks"] > 1


def test_sampler_on_the_card_matches_cpu(cuda):
    """The sampler's bits bitwise and its tokens exactly, card against CPU,
    on the same logits and keys at the full vocabulary."""
    from repro_torch import prng
    from repro_torch.serve import sampling as SM
    rng = np.random.RandomState(0)
    logits = torch.from_numpy((rng.randn(6, 92544) * 2).astype(np.float32))
    kd = torch.stack([SM.request_key_data(9, r) for r in range(6)])
    counts = torch.tensor([0, 1, 2, 7, 100, 3])
    temp = torch.tensor([0.0, 0.7, 1.0, 1.3, 0.9, 1.0])
    topk = torch.tensor([0, 0, 50, 0, 5, 0])
    topp = torch.tensor([1.0, 0.9, 1.0, 0.5, 1.0, 0.95])
    out = []
    for dev in ("cpu", cuda):
        keys = SM.fold_token_keys(kd.to(dev), counts.to(dev))
        out.append((keys.cpu(), prng.random_bits(keys, 92544).cpu(),
                    SM.sample_logits(logits.to(dev), keys, temp.to(dev),
                                     topk.to(dev), topp.to(dev),
                                     greedy=False).cpu()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_aes_kernel_fips197_and_blocks_bitwise(cuda):
    """The FIPS-197 C.1 vector both ways, and random runs of blocks against
    the plain rounds (forward and inverse), each launch counted."""
    from repro_torch.core import cipher as C
    from repro_torch.kernels import aes128 as AES
    rk = C.round_keys_tensor(C.aes128_key_schedule(np.arange(16,
                                                             dtype=np.uint8)),
                             cuda)
    pt = torch.tensor(list(bytes.fromhex("00112233445566778899aabbccddeeff")),
                      dtype=torch.uint8, device=cuda)[None]
    ops.reset_launch_counts()
    ct = C.aes128_encrypt_blocks(pt, rk)
    assert ct.cpu().reshape(-1).tolist() == list(
        bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a"))
    assert torch.equal(C.aes128_decrypt_blocks(ct, rk), pt)
    gen = torch.Generator(device=cuda).manual_seed(7)
    for n in (1, 7, 1000, 70001):
        b = torch.randint(0, 256, (n, 16), generator=gen, device=cuda,
                          dtype=torch.uint8)
        assert torch.equal(AES.encrypt_blocks(b, rk),
                           AES.encrypt_blocks_plain(b, rk))
        assert torch.equal(AES.decrypt_blocks(b, rk),
                           AES.decrypt_blocks_plain(b, rk))
    counts = ops.launch_counts()
    assert counts["aes128_lines_encrypt"] == 5
    assert counts["aes128_lines_decrypt"] == 5


@pytest.mark.parametrize("n_words", [1, 5, 32, 33, 1001, 4096 * 32 + 7])
@pytest.mark.parametrize("flags", ["none", "enc", "bypass", "mixed"])
def test_aes_lines_kernel_bitwise(cuda, n_words, flags):
    """Line encrypt and decrypt against their plain versions, twice, at
    lengths off whole lines and blocks, every kind of flag; the round trip
    returns the words."""
    from repro_torch.core import engine as E
    from repro_torch.kernels import aes128 as AES
    gen = torch.Generator(device=cuda).manual_seed(n_words)
    words = _words(gen, (n_words,), cuda)
    lines = -(-n_words // 32)
    fl = {"none": None,
          "enc": torch.ones((lines,), dtype=torch.int32, device=cuda),
          "bypass": torch.zeros((lines,), dtype=torch.int32, device=cuda),
          "mixed": _words(gen, (lines,), cuda)}[flags]
    rk = E.DirectEngine(bytes(range(32)), cuda).round_keys
    want = AES.lines_encrypt_plain(rk, words, fl)
    for _ in range(2):
        ct = AES.lines_encrypt(rk, words, fl)
        assert torch.equal(ct, want)
    for _ in range(2):
        back = AES.lines_decrypt(rk, ct, fl, n_words)
        assert torch.equal(back, AES.lines_decrypt_plain(rk, ct, fl, n_words))
        assert torch.equal(back, words)


def test_direct_serving_on_the_card_matches_cpu(cuda):
    """A reduced Direct engine, verified over a sealed cache, in f32 (in
    bf16 the card's and the CPU's sums round apart, so a near-tied argmax
    may differ): the card's sealed image, tokens and stats equal the CPU's;
    one decrypt launch a leaf a dispatch, one encrypt a leaf at sealing."""
    cfg = get_reduced("internlm2_1_8b").with_(num_layers=4,
                                              dtype="float32")
    params = T.init_params(cfg, seed=5, device="cpu")
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (9, 21, 14)]
    runs = []
    for dev in ("cpu", cuda):
        ops.reset_launch_counts()
        eng = ServeEngine(cfg, map_leaves(lambda t: t.to(dev), params),
                          batch_slots=2, max_len=48,
                          seal=SealConfig(mode="direct"), verify=True,
                          device=dev)
        sealed = ops.launch_counts()["aes128_lines_encrypt"]
        hs = [eng.submit(p, max_tokens=6) for p in prompts]
        ops.reset_launch_counts()
        eng.run()
        st = dict(eng.stats)
        dispatches = st["prefills"] + st["decode_steps"]
        runs.append(([h.out for h in hs], st,
                     {p: (t.payload.cpu(), t.counters.cpu(), t.macs.cpu())
                      for p, t in eng.sealed.tensors.items()}))
        if dev != "cpu":
            n = len(eng.sealed.tensors)
            assert sealed == n
            assert ops.launch_counts()["aes128_lines_decrypt"] == \
                dispatches * n
    assert runs[1][:2] == runs[0][:2]
    for p, (a, b, c) in runs[0][2].items():
        assert all(torch.equal(x, y) for x, y in zip((a, b, c),
                                                     runs[1][2][p])), p


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "dbrx_132b"])
def test_moe_serving_on_the_card_matches_cpu(cuda, arch, monkeypatch):
    """A reduced MoE model, sealed (ColoE) and verified at 8 slots with
    staggered arrivals (chunk dispatches with padding rows), in f32: the
    card's image, tokens and stats equal the CPU's; the image sealed in
    runs of a few lines equals the one-pass image; one ``lines_unseal``
    launch a line leaf but the embedding a dispatch."""
    from repro_torch.core import engine as E
    cfg = get_reduced(arch).with_(dtype="float32", num_layers=3)
    params = T.init_params(cfg, seed=2, device="cpu")
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (9, 40, 14, 23, 5)]
    runs = []
    for dev in ("cpu", cuda, cuda):
        if len(runs) == 2:
            monkeypatch.setattr(E, "SEAL_LINES", 5)
        eng = ServeEngine(cfg, map_leaves(lambda t: t.to(dev), params),
                          batch_slots=8, max_len=64, chunk_tokens=8,
                          seal=SealConfig(), verify=True, device=dev)
        hs = []
        ops.reset_launch_counts()
        for p in prompts:
            hs.append(eng.submit(p, max_tokens=5))
            eng.step()
        eng.run()
        st = dict(eng.stats)
        runs.append(([h.out for h in hs], st,
                     {p: t.payload.cpu() for p, t in eng.sealed.tensors.items()}))
        if dev != "cpu":
            lines = sum(t.meta.layout == "lines"
                        for t in eng.sealed.tensors.values())
            assert ops.launch_counts()["chacha20_lines_unseal"] == \
                (st["prefills"] + st["decode_steps"]) * (lines - 1)
    assert st["prefill_chunks"] < 2 * st["prefills"]      # padded dispatches
    for got in runs[1:]:
        assert got[:2] == runs[0][:2]
        for p, w in runs[0][2].items():
            assert torch.equal(got[2][p], w), p


@pytest.mark.parametrize("arch,engine", [
    ("gemma2_2b", "continuous"), ("recurrentgemma_9b", "group"),
    ("mamba2_130m", "group")])
def test_families_on_the_card_match_cpu(cuda, arch, engine):
    """One family of each kind, sealed (ColoE) and verified on the card in
    f32: gemma2 (window, softcaps, tied head) through the continuous
    engine, RecurrentGemma (RG-LRU and local attention) and Mamba2 (SSD)
    through the group engine; the CPU plaintext engine's tokens."""
    cfg = get_reduced(arch).with_(dtype="float32")
    params = T.init_params(cfg, seed=4, device="cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (9, 40, 14, 23)]
    cls = ServeEngine if engine == "continuous" else GroupServeEngine
    kw = dict(chunk_tokens=8) if engine == "continuous" else {}
    outs = []
    for dev, seal in (("cpu", None), (cuda, SealConfig())):
        eng = cls(cfg, map_leaves(lambda t: t.to(dev), params),
                  batch_slots=2, max_len=64, seal=seal,
                  verify=seal is not None, device=dev, **kw)
        hs = [eng.submit(p, max_tokens=6) for p in prompts]
        eng.run()
        outs.append([h.out for h in hs])
    assert outs[0] == outs[1]


def test_recurrences_on_the_card_match_cpu(cuda):
    """The RG-LRU doubling scan and the SSD chunked pass and step on the
    card against the same functions on the CPU, f32, at 1e-5 of scale."""
    from repro_torch.models import blocks as B
    gen = torch.Generator().manual_seed(3)
    a = torch.rand((2, 300, 64), generator=gen) * 0.5 + 0.5
    b = torch.randn((2, 300, 64), generator=gen)
    xh = torch.randn((2, 256, 3, 8), generator=gen)
    dt = torch.rand((2, 256, 3), generator=gen) * 0.2
    A = -torch.rand((3,), generator=gen) - 0.5
    Bm = torch.randn((2, 256, 16), generator=gen)
    Cm = torch.randn((2, 256, 16), generator=gen)
    st = torch.randn((2, 3, 8, 16), generator=gen)
    cases = [(B.linear_scan, (a, b)),
             (B.ssd_chunked, (xh, dt, A, Bm, Cm, st)),
             (B.ssd_step, (xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], st))]
    for fn, args in cases:
        want = fn(*args)
        got = fn(*[t.to(cuda) for t in args])
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(
                w.abs().max()), fn.__name__


CNN_IDS = ("vgg16", "resnet18", "resnet34")


def _scale_err(got, want):
    want = want.double()
    return float((got.cpu().double() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def test_resolve_device_turns_off_cudnn_tf32(cuda):
    """``resolve_device(None)`` leaves cuDNN's TF32 off, so a VGG-16 conv
    (256 -> 256 channels, 3x3, at 28x28) on the card is the CPU's f32."""
    from repro_torch.device import resolve_device
    from repro_torch.models import cnn as C
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device(None) == torch.device("cuda")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((8, 28, 28, 256), generator=gen)
    w = torch.randn((3, 3, 256, 256), generator=gen) * (2 / 2304) ** 0.5
    for stride in (1, 2):
        want = C.conv2d(x, w, stride)
        got = C.conv2d(x.to(cuda), w.to(cuda), stride)
        assert _scale_err(got, want) <= 1e-5


@pytest.mark.parametrize("cid", CNN_IDS)
def test_cnn_on_the_card_matches_cpu(cuda, cid):
    """Phase 12 (a) at the reduced configs, batch 32 (and an odd 15 x 15
    image): init, logits, loss, gradients and SE masks, card vs CPU."""
    from repro_torch import prng
    from repro_torch.core.criticality import cnn_channel_masks
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.models import cnn as C
    from repro_torch.tree import flatten_with_path
    for cfg in (get_reduced(cid), get_reduced(cid).with_(img_size=15)):
        p_cpu = C.init_cnn(cfg, prng.key(1), device="cpu")
        p_dev = C.init_cnn(cfg, prng.key(1), device=cuda)
        for (_, a), (_, b) in zip(flatten_with_path(p_cpu),
                                  flatten_with_path(p_dev)):
            rel = (b.cpu().double() - a.double()).abs() / \
                a.double().abs().clamp_min(1e-30)
            assert float(rel.max()) <= 1e-6
        x, y = image_dataset(32, img=cfg.img_size, seed=2)
        runs = []
        for dev in ("cpu", cuda):
            params = [{k: v.detach().to(dev).requires_grad_(True)
                       for k, v in p.items()} for p in p_cpu]
            leaves = [t for _, t in flatten_with_path(params)]
            xt = torch.from_numpy(x).to(dev).requires_grad_(True)
            loss = C.cnn_loss(cfg, params, {"x": xt, "y": torch.from_numpy(
                y).to(dev)})[0]
            logits = C.cnn_forward(cfg, params, xt)
            runs.append([logits, loss] + list(torch.autograd.grad(
                loss, leaves + [xt])))
            if dev != "cpu":
                for r in (0.2, 0.5, 0.8):
                    want = cnn_channel_masks(cfg, p_cpu, r)
                    got = cnn_channel_masks(cfg, params, r)
                    assert all(torch.equal(got[i].cpu(), want[i])
                               for i in want)
        for got, want in zip(runs[1], runs[0]):
            assert _scale_err(got.detach(), want.detach()) <= 1e-4


def test_evaluate_on_the_card(cuda):
    """``evaluate(device=None)`` runs on the card; a tiny report within
    0.05 of the CPU's, every rate in [0, 1]."""
    import dataclasses
    from repro_torch.core.security.evaluate import evaluate
    kw = dict(n_train=200, n_test=64, epochs=2, sub_epochs=1, ratios=(0.5,))
    got = dataclasses.asdict(evaluate("resnet18", **kw))
    want = dataclasses.asdict(evaluate("resnet18", device="cpu", **kw))
    for k, v in want.items():
        if isinstance(v, dict):
            assert abs(got[k][0.5] - v[0.5]) <= 0.05, k
            assert 0.0 <= got[k][0.5] <= 1.0
        elif k != "model":
            assert abs(got[k] - v) <= 0.05, k
            assert 0.0 <= got[k] <= 1.0


def test_kernels_refuse_autograd_and_training_reaches_attention(cuda):
    """The flash kernel and the fused matmul's CUDA route have no backward:
    under grad mode an input that requires grad raises, naming the
    differentiable route (without grad mode the kernel still launches).
    Training on the card takes that route: every attention weight of a
    reduced internlm2 gets a nonzero gradient, and the gradients equal the
    CPU's within 1e-4 of each tensor's scale."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.train.step import make_grad_fn
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((1, 64, 4, 64), generator=gen, device=cuda,
                    dtype=torch.bfloat16).requires_grad_(True)
    k, v = (torch.randn((1, 64, 2, 64), generator=gen, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    with pytest.raises(RuntimeError, match="differentiable route"):
        ops.flash_attention(q, k, v, scale=0.125)
    ops.reset_launch_counts()
    with torch.no_grad():
        ops.flash_attention(q, k, v, scale=0.125)
    assert ops.launch_counts()["flash_attention_tc"] == 1
    x = torch.randn((4, 128), generator=gen, device=cuda, requires_grad=True)
    w_ct = _words(gen, (128, 128), cuda)
    row_mask = torch.ones((128,), dtype=torch.bool, device=cuda)
    key, nonce = _words(gen, (8,), cuda), _words(gen, (3,), cuda)
    with pytest.raises(RuntimeError, match="differentiable route"):
        ops.sealed_matmul(x, w_ct, row_mask, key, nonce, bk=128, bn=128)
    cfg = get_reduced("internlm2_1_8b").with_(dtype="float32")
    p_cpu = T.init_params(cfg, seed=0, device="cpu")
    batch = {k_: torch.from_numpy(a) for k_, a in
             lm_batch(cfg, 4, 16, 0).items()}
    ops.reset_launch_counts()
    _, g_dev = make_grad_fn(cfg, "full")(
        map_leaves(lambda t: t.to(cuda), p_cpu),
        {k_: a.to(cuda) for k_, a in batch.items()})
    assert not any(ops.launch_counts().values())
    _, g_cpu = make_grad_fn(cfg, "full")(p_cpu, batch)
    for name in ("wq", "wk", "wv", "wo"):
        got = g_dev["blocks"][0]["attn"][name].cpu()
        want = g_cpu["blocks"][0]["attn"][name]
        assert bool(got.abs().amax(dim=tuple(range(1, got.ndim))).gt(0).all())
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())


def test_sealed_decode_variants_on_the_card_match_cpu(cuda):
    import dataclasses
    from repro_torch.launch import sealed_dryrun as SD
    cpu = SD.decode_state("granite_3_2b", "decode_32k", reduced=True,
                          batch=2, dtype="float32", device="cpu", seed=0)
    card = dataclasses.replace(
        cpu, params=map_leaves(lambda t: t.to(cuda), cpu.params),
        cache=tuple({k: t.to(cuda) for k, t in c.items()}
                    for c in cpu.cache),
        batch={k: t.to(cuda) for k, t in cpu.batch.items()}, logits={})
    for v in SD.VARIANTS:
        SD.sealed_decode_variant("granite_3_2b", "decode_32k", v,
                                 reduced=True, state=cpu, warmup=1, iters=1)
        rec = SD.sealed_decode_variant("granite_3_2b", "decode_32k", v,
                                       reduced=True, state=card, warmup=1,
                                       iters=1)
        got, want = card.logits[v], cpu.logits[v]
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
        if v != "coloe_fused":
            assert torch.equal(got, card.logits["baseline"])
        lines = {"baseline": 0, "coloe_fused": 4}.get(v, 11)
        expect = {"chacha20_lines_unseal": lines} if lines else {}
        if v == "coloe_fused":
            expect["sealed_matmul"] = 7 * 2
        assert rec["launches_per_step"] == expect
        assert rec["plaintext_bytes_written"] == \
            rec["plaintext_bytes_materialized_per_step"]
