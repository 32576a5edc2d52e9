"""The port's flash attention (``kernels/flash_attention.py``) held against
the JAX package on the CPU.

The reference's Pallas kernel does not run on this jax (``pl.load`` is
gone), so the plain version is held to what the reference's own test holds
the kernel to: ``layers._sdpa`` under ``layers._attn_mask`` at positions
``arange``, at that test's tolerances (2e-5 in f32, 2e-2 with bf16 I/O; the
reference's ``_sdpa`` rounds probabilities to bf16 before ``p @ v``, the
flash contract does not). A ragged length is held to
``layers.blockwise_attention``, the reference's other form of the same
function. On the CPU the public wrapper takes the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops


def _qkv(seed, b, s, t, hq, hkv, dh):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((b, s, hq, dh)).astype(np.float32),
            rng.standard_normal((b, t, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, t, hkv, dh)).astype(np.float32))


def _port(arrays, dtype=torch.float32, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    return FA.flash_attention_plain(q, k, v, **kw)


def _sdpa_ref(arrays, win, cap, dtype=jnp.float32):
    q, k, v = (jnp.asarray(a, dtype) for a in arrays)
    q_pos = jnp.arange(q.shape[1], dtype=jnp.int32)
    k_pos = jnp.arange(k.shape[1], dtype=jnp.int32)
    return JL._sdpa(q, k, v, JL._attn_mask(q_pos, k_pos, win), cap,
                    q.shape[-1] ** -0.5)


@pytest.mark.parametrize("b,s,hq,hkv,dh,win,cap", [
    (2, 256, 4, 2, 32, 0, 0.0),      # GQA causal
    (1, 512, 8, 1, 32, 128, 50.0),   # MQA + window + softcap
    (2, 256, 6, 6, 16, 0, 0.0),      # MHA
    (1, 128, 2, 2, 64, 32, 0.0),     # small window
    (1, 256, 4, 2, 256, 100, 50.0),  # gemma2's head dim, window, softcap
])
def test_plain_matches_reference_sdpa(b, s, hq, hkv, dh, win, cap):
    arrays = _qkv(s + dh, b, s, s, hq, hkv, dh)
    got = _port(arrays, scale=dh ** -0.5, softcap=cap, window=win)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_sdpa_ref(arrays, win, cap)),
                               rtol=2e-5, atol=2e-5)


def test_plain_bf16_io():
    arrays = _qkv(1, 1, 128, 128, 4, 2, 32)
    got = _port(arrays, torch.bfloat16, scale=32 ** -0.5)
    assert got.dtype == torch.bfloat16
    want = _sdpa_ref(arrays, 0, 0.0, jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("win,cap", [(0, 0.0), (48, 30.0)])
def test_ragged_length_matches_blockwise(win, cap):
    """s = 200 is no multiple of the 64-row tiles: the reference's
    blockwise form pads and drops the tail; the port masks it."""
    arrays = _qkv(7, 2, 200, 200, 4, 2, 32)
    q, k, v = (jnp.asarray(a) for a in arrays)
    pos = jnp.arange(200, dtype=jnp.int32)
    want = JL.blockwise_attention(q, k, v, pos, pos, win, cap, 32 ** -0.5,
                                  q_block=64, kv_block=64)
    got = _port(arrays, scale=32 ** -0.5, softcap=cap, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("win", [0, 40])
def test_short_queries_are_top_left_causal(win):
    """s < t: query i sees keys 0..i (positions arange(s) and arange(t)),
    not the last s keys."""
    arrays = _qkv(3, 1, 96, 160, 4, 2, 32)
    got = _port(arrays, scale=32 ** -0.5, window=win)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_sdpa_ref(arrays, win, 0.0)),
                               rtol=2e-5, atol=2e-5)
    # keys past the last query position take no weight
    q, k, v = (torch.from_numpy(a) for a in arrays)
    v2 = v.clone()
    v2[:, 96:] = 1e3
    again = FA.flash_attention_plain(q, k, v2, scale=32 ** -0.5, window=win)
    assert torch.equal(got, again)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_kernel(*_a, **_k):
        raise AssertionError("the kernel was launched for CPU tensors")

    monkeypatch.setattr(FA, "flash_attention_cuda", no_kernel)
    monkeypatch.setattr(FA, "flash_attention_tc_cuda", no_kernel)
    monkeypatch.setattr(FA, "flash_attention_tc256_cuda", no_kernel)
    arrays = _qkv(5, 1, 70, 70, 4, 2, 16)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, scale=0.25, softcap=20.0, window=9)
    assert ops.launch_counts()["flash_attention"] == before
    assert torch.equal(got, FA.flash_attention_plain(
        q, k, v, scale=0.25, softcap=20.0, window=9))


@pytest.mark.parametrize("shapes,dtype,err", [
    (((1, 8, 3, 16), (1, 8, 2, 16)), torch.float32, ValueError),   # heads
    (((1, 8, 2, 16), (1, 8, 2, 8)), torch.float32, ValueError),    # dh
    (((1, 8, 2, 16), (1, 8, 2, 16)), torch.float16, TypeError),    # dtype
])
def test_wrapper_refuses_what_the_kernel_does_not_take(shapes, dtype, err):
    q = torch.zeros(shapes[0], dtype=dtype)
    k = torch.zeros(shapes[1], dtype=dtype)
    with pytest.raises(err):
        ops.flash_attention(q, k, k, scale=1.0)


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 128, "flash_attention_tc"),   # internlm2's heads
    (torch.bfloat16, 64, "flash_attention_tc"),
    (torch.bfloat16, 256, "flash_attention_tc"),   # gemma2, RecurrentGemma
    (torch.bfloat16, 32, "flash_attention"),
    (torch.float32, 128, "flash_attention"),       # the exact f32 path
    (torch.float32, 64, "flash_attention"),
    (torch.float32, 256, "flash_attention"),
])
def test_variant_picks_by_dtype_and_head_dim(dtype, dh, want):
    assert FA._variant(dtype, dh) == want


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 256, "flash_attention_tc256"),  # its own source
    (torch.bfloat16, 128, "flash_attention_tc"),
    (torch.bfloat16, 64, "flash_attention_tc"),
    (torch.float32, 256, "flash_attention"),
])
def test_kernel_counts_each_source_apart(dtype, dh, want):
    """Launches are counted by source: the tensor-core variant's head dim
    256 under its own name, which ``ops.launch_counts`` carries."""
    assert FA._kernel(dtype, dh) == want
    assert want in ops.launch_counts()


def _tc_emulation(q, k, v, scale, tiles=None, tile=64, softcap=0.0,
                  window=0):
    """The tensor-core kernels' arithmetic in plain PyTorch: f32 scores of
    bf16 inputs, scaled in f32, tanh softcap, causal (and window) mask with
    dead scores -1e30, online softmax over ``tile``-key tiles with f32 row
    sums, probabilities rounded to bf16 per tile before ``p @ v``, output
    rounded to bf16. ``tiles`` lists the kv tiles visited (the kernels':
    each once, in order)."""
    s, hq, t, hkv = q.shape[1], q.shape[2], k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(hq // hkv, dim=2)
    vf = v.float().repeat_interleave(hq // hkv, dim=2)
    shape = (q.shape[0], hq, s)
    m = torch.full(shape, -np.inf)
    den = torch.zeros(shape)
    acc = torch.zeros(shape + (q.shape[3],))
    q_pos = torch.arange(s)[:, None]
    if tiles is None:
        tiles = range(-(-t // tile))
    for j in tiles:
        lo, hi = j * tile, min(t, (j + 1) * tile)
        sc = torch.einsum("bshd,bthd->bhst", q.float(), kf[:, lo:hi]) * scale
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
        k_pos = torch.arange(lo, hi)[None]
        live = k_pos <= q_pos
        if window:
            live &= q_pos - k_pos < window
        sc = torch.where(live, sc, torch.full((), -1e30))
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        den = den * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhst,bthd->bhsd", p.to(torch.bfloat16).float(), vf[:, lo:hi])
        m = m_new
    out = acc / den.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)


# head dim, window, softcap: the first the dh 64/128 kernels' contract at a
# small head dim, the second the dh-256 kernel's at gemma2's heads
_GATE_SHAPES = {"dh32": (32, 0, 0.0), "dh256": (256, 100, 50.0)}


@pytest.mark.parametrize("tiles,ok,shape", [
    pytest.param(None, True, "dh32", id="None-True"),   # every tile once
    pytest.param([0, 2, 3], False, "dh32", id="tiles1-False"),  # one dropped
    pytest.param([0, 1, 1, 2, 3], False, "dh32",        # one counted twice
                 id="tiles2-False"),
    pytest.param([1, 2, 3], False, "dh32", id="tiles3-False"),  # the first
    pytest.param(None, True, "dh256", id="dh256-None-True"),
    pytest.param([0, 1, 3], False, "dh256", id="dh256-tile2-dropped"),
])
def test_bf16_gate_sees_tile_faults(tiles, ok, shape):
    """``bf16_gate`` accepts a plain emulation of the tensor-core kernels'
    bf16 rounding of P over 64-key tiles, and rejects it with a tile
    dropped or doubled; at head dim 256 with a window and softcap 50 too."""
    dh, win, cap = _GATE_SHAPES[shape]
    arrays = _qkv(11, 1, 256, 256, 4, 2, dh)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    kw = dict(scale=dh ** -0.5, softcap=cap, window=win)
    got = _tc_emulation(q, k, v, kw["scale"], tiles, 64, cap, win)
    passed, share, rms = FA.bf16_gate(q, k, v, got, **kw)
    assert passed == ok, (share, rms)
    if ok:   # inside the gate with room: P's and the output's roundings
        assert share < 0.75 and rms < 0.75 * 2.0 ** -8


@pytest.mark.parametrize("case", ["f32", "dh32", "head_stride", "base"])
def test_tc_check_refuses_what_tma_cannot_describe(case):
    """The tensor-core kernels take bf16, head dim 64, 128 or 256, and
    views whose bases and strides are 16-byte aligned; their wrapper
    refuses the rest before any launch."""
    for dh in (64, 128, 256):                    # the shapes they take
        FA.check_tc(torch.zeros((1, 8, 4, dh), dtype=torch.bfloat16),
                    torch.zeros((1, 8, 2, dh), dtype=torch.bfloat16),
                    torch.zeros((1, 8, 2, dh), dtype=torch.bfloat16), 0)
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    if case == "f32":
        q, k = q.float(), k.float()
    elif case == "dh32":
        q, k = q[..., :32].contiguous(), k[..., :32].contiguous()
    elif case == "head_stride":                  # heads 68 elements apart
        q = torch.zeros((1, 8, 4, 68), dtype=torch.bfloat16)[..., :64]
    else:                                        # base 2 bytes off
        q = torch.zeros((1 * 8 * 4 * 64 + 1,), dtype=torch.bfloat16)[1:]
        q = q.view(1, 8, 4, 64)
    with pytest.raises(ValueError):
        FA.check_tc(q, k, k, 0)
