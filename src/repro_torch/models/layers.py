"""Layer math: dense contractions (plain or sealed), norms, RoPE, attention
(self-attention through the flash kernel, cache attention through
``_sdpa``), dense MLP. Port of the serving half of ``repro/models/layers.py``.

Conventions as in the reference: params are f32, compute is ``cfg.dtype``
with f32 softmax and norm accumulation; activations (batch, seq, d_model)
with heads as an explicit axis. The reference's sharding constraints are
single-device no-ops and are dropped.

Every weight contraction runs as one (M, K) @ (K, N) product of operands
rounded to the compute dtype and accumulated in f32 — the contract of the
fused sealed kernel — so the plaintext and sealed branches of ``dense``
compute the same function (bit for bit on the CPU, where the sealed branch
takes the kernel's plain version). On the card the plaintext branch is one
cuBLAS GEMM in the compute dtype (f32 sums: ``resolve_device`` turns off
reduced-precision reductions), so it reads each weight once as stored.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.sealed_tensor import SealedTensor
from repro_torch.kernels import ops


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _k_ndim(eq: str) -> int:
    """Contraction axes of an einsum ``x,w->y`` whose weight leads with them."""
    xs, ws = eq.split("->")[0].split(",")
    n = 0
    while n < len(ws) and ws[n] in xs:
        n += 1
    return n


def plain_matmul(x2d: torch.Tensor, w2d: torch.Tensor,
                 dt: torch.dtype) -> torch.Tensor:
    """(M, K) @ (K, N) with both operands rounded to ``dt`` and f32 sums.
    The result is f32 on the CPU and ``dt`` (rounded from the f32 sums) on
    the card, where ``dt`` operands go to the GEMM as they are."""
    if x2d.is_cuda:
        return torch.mm(x2d.to(dt), w2d.to(dt))
    return x2d.to(dt).float() @ w2d.to(dt).float()


def dense(x: torch.Tensor, w, eq: str, dt: torch.dtype) -> torch.Tensor:
    """Weight contraction over a plain tensor or a still-sealed
    ``SealedTensor`` (fused decrypt-in-matmul kernel). ``eq`` names the
    reference's einsum; x's trailing axes contract with w's leading ones."""
    kd = w.meta.k_ndim if isinstance(w, SealedTensor) else _k_ndim(eq)
    lead = tuple(x.shape[:x.ndim - kd])
    k = 1
    for d in x.shape[x.ndim - kd:]:
        k *= d
    x2d = x.reshape(-1, k)
    if isinstance(w, SealedTensor):
        # x goes in the compute dtype: the kernel rounds to it anyway, and a
        # bf16 activation is not widened to f32 on the way
        y = w.matmul(x2d.to(dt), compute_dtype=str(dt).replace("torch.", ""))
        out_shape = w.out_shape
    else:
        y = plain_matmul(x2d, w.reshape(k, -1), dt)
        out_shape = tuple(w.shape[kd:])
    return y.reshape(lead + out_shape).to(dt)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-6):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _attn_mask(q_pos, k_pos, window: int):
    """(..., q, k) bool: causal, optionally sliding-window; 1-D or batched
    positions, leading axes broadcast."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window:
        m &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    return m


def _sdpa(q, k, v, mask, attn_softcap: float, scale: float):
    """q:(b,s,hq,dh) k,v:(b,t,hkv,dh) mask:(s,t) or (b,s,t) -> (b,s,hq,dh).

    GQA repeats k/v to the full head count, as the reference does. Scores
    and softmax in f32, probabilities rounded to q's dtype before the value
    contraction (f32 accumulation)."""
    hq, hkv = q.shape[2], k.shape[2]
    g = hq // hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    if mask.ndim == 2:
        mask = mask[None]
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    scores = softcap(scores, attn_softcap)
    scores = torch.where(mask[:, None], scores,
                         torch.full((), -1e30, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(q.dtype)


def attention_apply(cfg: ModelConfig, p, x, positions, *, window: int,
                    kv_override=None):
    """Attention of x's queries; returns (out, (k, v)).

    Without ``kv_override`` (the one-shot prefill): self-attention over x's
    own k and v at 1-D ``positions`` that must be ``arange(s)``, through the
    flash kernel (``kernels/ops.py::flash_attention``: the Pallas kernel's
    function). The reference's ``impl="naive"`` (``_sdpa``) and
    ``impl="blockwise"`` (above 8192 tokens) compute that same function and
    both route here. With ``kv_override = (k, v, k_positions)`` (the paged
    view with the new keys already in it, or the contiguous cache at decode):
    masked attention into that view through ``_sdpa``, since its query
    positions are per row, not the kernel's ``arange``."""
    dt = cdtype(cfg)
    xb = x.to(dt)
    q = dense(xb, p["wq"], "bsd,dhk->bshk", dt)
    q = apply_rope(q, positions, cfg.rope_theta)
    scale = cfg.head_dim ** -0.5
    if kv_override is None:
        if positions.ndim != 1:
            raise ValueError("self-attention takes 1-D positions arange(s)")
        k, v = project_kv(cfg, p, x, positions)
        out = ops.flash_attention(q, k, v, scale=scale,
                                  softcap=cfg.attn_softcap, window=window)
    else:
        k, v, k_positions = kv_override
        mask = _attn_mask(positions, k_positions, window)
        out = _sdpa(q, k, v, mask, cfg.attn_softcap, scale)
    y = dense(out, p["wo"], "bshk,hkd->bsd", dt)
    return y, (k, v)


def project_kv(cfg: ModelConfig, p, x, positions):
    """k, v projections (+rope on k), written into the cache."""
    dt = cdtype(cfg)
    xb = x.to(dt)
    k = dense(xb, p["wk"], "bsd,dhk->bshk", dt)
    v = dense(xb, p["wv"], "bsd,dhk->bshk", dt)
    k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp_apply(cfg: ModelConfig, p, x):
    if cfg.moe is not None:
        raise NotImplementedError("MoE layers are not ported yet")
    dt = cdtype(cfg)
    xb = x.to(dt)
    a = act_fn(cfg.act)
    h = a(dense(xb, p["wg"], "bsd,df->bsf", dt)) * \
        dense(xb, p["wi"], "bsd,df->bsf", dt)
    return dense(h, p["wo"], "bsf,fd->bsd", dt)
