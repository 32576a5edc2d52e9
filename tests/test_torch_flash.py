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
