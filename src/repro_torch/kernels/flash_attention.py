"""Causal flash attention (forward): the Hopper kernel and its plain PyTorch
version.

Port of ``repro/kernels/flash_attention.py::flash_attention`` (kernel body
``_kernel``). The CUDA source is ``csrc/flash_attention.cu``; its header
comment gives the contract and the design.

Unlike the Pallas kernel, ``s`` and ``t`` need not be tile multiples (a
prefill is as long as its prompt), and the kernel takes the model's
``(b, s, h, dh)`` views with their strides, so nothing is copied when the
head dimension is contiguous.

What bounds it on this card: at the group prefill's shape the causal
arithmetic (4 * b * hq * dh * s(s+1)/2 FLOPs) on the bf16 tensor cores, well
ahead of the q + k + v + out bytes. This first kernel does that arithmetic as
f32 FMAs on the CUDA cores, with the online-softmax state in registers for
the whole kv loop and only the live kv tiles visited.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, *, scale: float, softcap: float = 0.0,
                          window: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 scores of ``q * scale``
    against k, tanh softcap, top-left causal (and window) mask with dead
    scores at -1e30, softmax and ``p @ v`` in f32, output in q's dtype.
    GQA repeats each kv head for its ``hq // hkv`` q heads."""
    s, hq = q.shape[1], q.shape[2]
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kf, vf = k.float(), v.float()
    if g > 1:
        kf = kf.repeat_interleave(g, dim=2)
        vf = vf.repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float() * scale, kf)
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    live = k_pos <= q_pos
    if window:
        live &= (q_pos - k_pos) < window
    scores = torch.where(live, scores,
                         torch.full((), -1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, vf).to(q.dtype)


def check(q, k, v, window: int):
    """Raise unless q, k, v and window fit the kernel's contract."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (b, s, hq, dh) and k, v (b, t, hkv, "
                         f"dh), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"{hq} q heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= dh <= 256:
        raise ValueError(f"head dim {dh} outside 1..256")
    if window and s - k.shape[1] >= window:
        raise ValueError(f"s={s}, t={k.shape[1]}, window={window}: the last "
                         f"rows would have no live key")


def flash_attention_cuda(q, k, v, *, scale: float, softcap: float = 0.0,
                         window: int = 0) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on PyTorch's current stream.
    q (b, s, hq, dh), k and v (b, t, hkv, dh) on one card, f32 or bf16; a
    view whose head dimension is not contiguous is copied first."""
    check(q, k, v, window)
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention operands must share one device")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, hq, dh), dtype=q.dtype, device=dev)
    if out.numel() == 0 or t == 0:
        return out.zero_()
    lib = _build.load("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, t, hq, hkv, dh, *strides, float(scale), float(softcap),
                int(window), int(q.dtype == torch.bfloat16), stream)
    _build.check(rc, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
