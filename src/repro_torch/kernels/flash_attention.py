"""Causal flash attention (forward): the Hopper kernels and their plain
PyTorch version.

Port of ``repro/kernels/flash_attention.py::flash_attention`` (kernel body
``_kernel``), as two variants:

* ``flash_attention`` (``flash_attention_cuda``, ``csrc/flash_attention.cu``):
  f32 FMAs on the CUDA cores; f32 inputs (exact to the f32 contract) at
  every head dim up to 256, and bf16 at head dims other than 64, 128, 256;
* ``flash_attention_tc`` (``flash_attention_tc_cuda``): bf16 ``wgmma`` on
  the tensor cores with a TMA ring of K/V tiles, for bf16 inputs with head
  dim 64 or 128 (``csrc/flash_attention_tc.cu``: 128-key tiles) or 256
  (``flash_attention_tc256_cuda``, ``csrc/flash_attention_tc256.cu``:
  64-key tiles, a producer warpgroup and register hand-over, q heads of one
  kv head paired in a block). Its one change of contract: probabilities
  are rounded to bf16 before ``p @ v``, as the reference's serving
  attention and every tensor-core flash kernel do; ``bf16_gate`` is the
  tolerance that follows from it.

``kernels/ops.py::flash_attention`` picks a variant by ``_variant`` from
dtype and head dim alone. Each source counts its own launches, under the
name ``_kernel`` gives (``flash_attention_tc256`` for the dh-256 source).
The CUDA sources' header comments give the contract and the designs.

Unlike the Pallas kernel, ``s`` and ``t`` need not be tile multiples (a
prefill is as long as its prompt), and the kernel takes the model's
``(b, s, h, dh)`` views with their strides, so nothing is copied when the
head dimension is contiguous.

What bounds it on this card: at the group prefill's shape the causal
arithmetic (4 * b * hq * dh * s(s+1)/2 FLOPs) on the bf16 tensor cores, well
ahead of the q + k + v + out bytes. The CUDA-core kernel does that
arithmetic as f32 FMAs, the tensor-core kernel as bf16 products with f32
sums; both keep
the online-softmax state in registers for the whole kv loop and visit only
the live kv tiles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
TC_HEAD_DIMS = (64, 128, 256)
BF16_ROUNDING = 2.0 ** -8   # twice the largest relative bf16 rounding
F32_TERM = 2e-5             # the f32 contract's share of the output scale


def _variant(dtype: torch.dtype, dh: int) -> str:
    """The kernel a CUDA call runs: ``"flash_attention_tc"`` (tensor cores)
    for bf16 with head dim 64, 128 or 256, else ``"flash_attention"`` (CUDA
    cores). Depends on dtype and head dim only."""
    if dtype == torch.bfloat16 and dh in TC_HEAD_DIMS:
        return "flash_attention_tc"
    return "flash_attention"


def _kernel(dtype: torch.dtype, dh: int) -> str:
    """The launch count (``ops.launch_counts``) a CUDA call adds to:
    ``_variant``'s, with the tensor-core variant's head dim 256, which has a
    source of its own, counted as ``"flash_attention_tc256"``."""
    name = _variant(dtype, dh)
    if name == "flash_attention_tc" and dh == 256:
        return "flash_attention_tc256"
    return name


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


def bf16_gate(q, k, v, got, **kw):
    """Hold a bf16 output of the tensor-core kernel to the plain version's
    f32 result ``want`` on the same inputs. Returns (ok, worst share of the
    per-element tolerance, rms(got - want) / rms(want)).

    Per element: ``|got - want| <= 2^-8 |want| + 2^-8 (P|V|) + 2e-5 scale``,
    where ``P|V|`` is the plain version run with ``|v|`` for ``v`` and scale
    is ``max |want|``. Rounding each probability to bf16 moves it by at most
    2^-9 of itself, so an output element by at most 2^-9 sum p|v| / l and
    the denominator by as much: 2^-8 P|V| is the worst case; 2^-8 |want|
    covers the output's own rounding. On the RMS: ``rms(got - want) <=
    2^-8 rms(want)`` (the random roundings of P and of the output leave
    about 2^-9), so a dropped or doubled kv tile, which moves late rows by
    percents, fails."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    want = flash_attention_plain(q32, k32, v32, **kw)
    pv = flash_attention_plain(q32, k32, v32.abs(), **kw)
    err = got.float() - want
    allowed = (BF16_ROUNDING * (want.abs() + pv)
               + F32_TERM * want.abs().max())
    share = float((err.abs() / allowed).max())
    rms = float(err.square().mean().sqrt() / want.square().mean().sqrt())
    ok = (bool(torch.isfinite(got).all()) and share <= 1.0
          and rms <= BF16_ROUNDING)
    return ok, share, rms


def check_tc(q, k, v, window: int):
    """Raise unless q, k, v fit the tensor-core kernel: ``check``'s
    contract, bf16, head dim 64, 128 or 256, a contiguous head dim, and 16-byte
    aligned bases and strides (what a TMA tensor map can describe)."""
    check(q, k, v, window)
    if q.dtype != torch.bfloat16 or q.shape[-1] not in TC_HEAD_DIMS:
        raise ValueError(f"the tensor-core kernel takes bf16 with head dim "
                         f"{TC_HEAD_DIMS}, got {q.dtype}, {q.shape[-1]}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim is not contiguous")
        if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(f"{name} is not 16-byte aligned in base and "
                             f"strides {tuple(x.stride())}, which TMA needs")


def _launch_tc(lib, q, k, v, scale, softcap, window, *extra):
    """Launch ``csrc/<lib>.cu`` (a tensor-core kernel) on PyTorch's current
    stream and return its output; ``extra`` follows the window in the C
    entry's arguments."""
    check_tc(q, k, v, window)
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention operands must share one device")
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, hq, dh), dtype=q.dtype, device=dev)
    if out.numel() == 0 or t == 0:
        return out.zero_()
    fn = getattr(_build.load(lib), lib)
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, t, hq, hkv, dh, *strides, float(scale), float(softcap),
                int(window), *extra, stream)
    _build.check(rc, lib)
    return out


def flash_attention_tc_cuda(q, k, v, *, scale: float, softcap: float = 0.0,
                            window: int = 0) -> torch.Tensor:
    """Launch the tensor-core variant on PyTorch's current stream:
    ``csrc/flash_attention_tc.cu`` for dh 64 or 128, and for dh 256
    ``flash_attention_tc256_cuda``. q (b, s, hq, dh), k and v (b, t, hkv,
    dh), bf16 on one card, views taken as they are (``check_tc``)."""
    if q.shape[-1] == 256:
        return flash_attention_tc256_cuda(q, k, v, scale=scale,
                                          softcap=softcap, window=window)
    out = _launch_tc("flash_attention_tc", q, k, v, scale, softcap, window)
    flash_attention_tc_cuda.launches += 1
    return out


def flash_attention_tc256_cuda(q, k, v, *, scale: float,
                               softcap: float = 0.0, window: int = 0,
                               warpgroups: int = 0) -> torch.Tensor:
    """Launch ``csrc/flash_attention_tc256.cu`` (bf16, head dim 256) on
    PyTorch's current stream, as ``flash_attention_tc_cuda``. The kernel
    picks its grid unless ``warpgroups`` forces it: 1 (one q head of 64
    rows a block) or 2 (two q heads of one kv head a block, for an even
    ``hq // hkv``)."""
    if q.shape[-1] != 256:
        raise ValueError(f"flash_attention_tc256 takes head dim 256, got "
                         f"{q.shape[-1]}")
    out = _launch_tc("flash_attention_tc256", q, k, v, scale, softcap, window,
                     int(warpgroups))
    flash_attention_tc256_cuda.launches += 1
    return out


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
    fn = _build.load("flash_attention").flash_attention
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
flash_attention_tc_cuda.launches = 0
flash_attention_tc256_cuda.launches = 0


def flash_attention(q, k, v, *, scale: float, softcap: float = 0.0,
                    window: int = 0) -> torch.Tensor:
    """Causal self-attention of q (b, s, hq, dh) over k, v (b, t, hkv, dh),
    positions ``arange(s)`` and ``arange(t)``: optional tanh softcap and
    sliding window, GQA by ``h // (hq // hkv)``; output in q's dtype. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    ``_variant`` names (tensor cores for bf16 with head dim 64, 128 or 256), or
    raises; with grad mode on, a CUDA input that requires grad raises
    (``ops._refuse_autograd``). The reference's tile sizes and
    ``interpret`` are its Pallas grid's and have no counterpart here. The
    model reaches it as ``ops.flash_attention``."""
    if q.is_cuda:
        from repro_torch.kernels.ops import _refuse_autograd
        _refuse_autograd("flash_attention", 'layers.attention_apply(..., '
                         'impl="naive"), the _sdpa of block mode "train"',
                         q, k, v)
        fn = (flash_attention_tc_cuda
              if _variant(q.dtype, q.shape[-1]) == "flash_attention_tc"
              else flash_attention_cuda)
        return fn(q, k, v, scale=scale, softcap=softcap, window=window)
    check(q, k, v, window)
    return flash_attention_plain(q, k, v, scale=scale, softcap=softcap,
                                 window=window)
