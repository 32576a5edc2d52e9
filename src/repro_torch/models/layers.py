"""Layer math: dense contractions (plain or sealed), norms, RoPE, attention
(a prefill's self-attention through the flash kernel; cache attention and
training's self-attention through the differentiable ``_sdpa``, with
``blockwise_attention`` as its forward-only online-softmax oracle), the
dense MLP and the MoE layers (router, the dropless decode path, the
capacity dispatch). Port of ``repro/models/layers.py``; its ``init_*``
functions live in ``models/transformer.py::init_params``, and its ``pin``
(an optimization barrier with a gradient rule) has no counterpart, see
``_moe_apply_block``.

Conventions as in the reference: params are f32, compute is ``cfg.dtype``
with f32 softmax and norm accumulation; activations (batch, seq, d_model)
with heads as an explicit axis. The reference's sharding constraints are
``sharding.api.constrain`` calls at the same places: the identity on
plain tensors, a redistribution of a DTensor activation under
``use_mesh``.

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
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.core.sealed_tensor import SealedTensor
from repro_torch.kernels import ops
from repro_torch.sharding.api import (constrain, is_dtensor, local_call,
                                      logical_spec, shard_prefix_sum)


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


def _sdpa(q, k, v, mask, attn_softcap: float, scale: float,
          q_chunk: int = 0, constrain_heads: bool = True):
    """q:(b,s,hq,dh) k,v:(b,t,hkv,dh) mask:(s,t) or (b,s,t) -> (b,s,hq,dh).

    GQA repeats k/v to the full head count, as the reference does. Scores
    and softmax in f32, probabilities rounded to q's dtype before the value
    contraction (f32 accumulation). Differentiable: the training route.

    q_chunk: queries in chunks of this size, each under
    ``torch.utils.checkpoint`` as the reference's are under
    ``jax.checkpoint``, which bounds the live score buffer to (b, h,
    q_chunk, t) in the forward and the backward."""
    hq, hkv = q.shape[2], k.shape[2]
    g = hq // hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
        if constrain_heads:
            # self-attention: shard the repeated heads over `model`; a
            # decode's cache arrives seq-sharded and keeps that layout
            k = constrain(k, "batch", None, "heads", "head_dim")
            v = constrain(v, "batch", None, "heads", "head_dim")
    if mask.ndim == 2:
        mask = mask[None]
    kf, vf = k.float(), v.float()

    def attend(qc, mc):
        scores = torch.einsum("bshd,bthd->bhst", qc.float(), kf) * scale
        if constrain_heads:
            scores = constrain(scores, "batch", "heads", None, None)
        else:
            scores = constrain(scores, "batch", None, None, "cache_seq")
        scores = softcap(scores, attn_softcap)
        scores = torch.where(mc[:, None], scores,
                             torch.full((), -1e30, device=scores.device))
        probs = torch.softmax(scores, dim=-1).to(qc.dtype)
        out = torch.einsum("bhst,bthd->bshd", probs.float(), vf)
        return out.to(qc.dtype)

    s = q.shape[1]
    if q_chunk and s > q_chunk and s % q_chunk == 0:
        return torch.cat([checkpoint(attend, q[:, a:a + q_chunk],
                                     mask[:, a:a + q_chunk],
                                     use_reentrant=False)
                          for a in range(0, s, q_chunk)], dim=1)
    return attend(q, mask)


def blockwise_attention(q, k, v, q_positions, k_positions, window: int,
                        attn_softcap: float, scale: float,
                        q_block: int = 512, kv_block: int = 1024):
    """FlashAttention-style online-softmax attention (forward only), the
    reference's: per q block, only the kv blocks that can be live under the
    causal (+window) mask, the running max, denominator and f32 accumulator
    carried across them. The block bounds are host integers here (the
    reference's ``fori_loop`` bounds are traced). The port's prefills run
    the flash kernel instead; this is the oracle both are held to."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    nq = -(-s // q_block)
    nk = -(-t // kv_block)
    qpad, tpad = nq * q_block - s, nk * kv_block - t
    if qpad:
        q = F.pad(q, (0, 0, 0, 0, 0, qpad))
        q_positions = F.pad(q_positions, (0, qpad), value=-1)
    if tpad:
        k = F.pad(k, (0, 0, 0, 0, 0, tpad))
        v = F.pad(v, (0, 0, 0, 0, 0, tpad))
        k_positions = F.pad(k_positions, (0, tpad), value=2**30)
    q = q.reshape(b, nq, q_block, hkv, g, dh)
    qpos = q_positions.reshape(nq, q_block)
    outs = []
    for qi in range(nq):
        qb, qp = q[:, qi].float(), qpos[qi]
        hi = int(qp.max())
        lo = max(int(qp.min()) - window + 1, 0) if window > 0 else 0
        acc = torch.zeros((b, hkv, g, q_block, dh), dtype=torch.float32,
                          device=q.device)
        m_run = torch.full((b, hkv, g, q_block), float("-inf"),
                           device=q.device)
        d_run = torch.zeros((b, hkv, g, q_block), device=q.device)
        for j in range(lo // kv_block, min(hi // kv_block + 1, nk)):
            blk = slice(j * kv_block, (j + 1) * kv_block)
            vb = v[:, blk]
            sc = torch.einsum("bqkgd,btkd->bkgqt", qb,
                              k[:, blk].float()) * scale
            sc = softcap(sc, attn_softcap)
            msk = _attn_mask(qp, k_positions[blk], window)
            sc = torch.where(msk[None, None, None], sc,
                             torch.full((), -1e30, device=sc.device))
            m_new = torch.maximum(m_run, sc.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(sc - m_new[..., None])
            d_run = d_run * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(vb.dtype).float(),
                              vb.float())
            acc = acc * alpha[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp(d_run, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))                  # (b, hkv, g, Qb, dh)
    out = torch.stack(outs, dim=1).permute(0, 1, 4, 2, 3, 5)
    return out.reshape(b, nq * q_block, hq, dh)[:, :s]


def attention_apply(cfg: ModelConfig, p, x, positions, *, window: int,
                    impl: str = "flash", kv_override=None):
    """Attention of x's queries; returns (out, (k, v)).

    Without ``kv_override``: self-attention over x's own k and v at 1-D
    ``positions`` that must be ``arange(s)``. ``impl="flash"`` (a prefill)
    runs the flash kernel (``kernels/ops.py::flash_attention``: the Pallas
    kernel's function; the reference's ``impl="naive"`` and its
    ``"blockwise"`` above 8192 tokens compute that same function, and both
    route here). ``impl="naive"`` (training) runs the differentiable
    ``_sdpa``, in query chunks of 512 from 4,096 tokens on, the reference's
    rule with the heads unsharded on one card. The kernel has no backward
    and refuses autograd. With ``kv_override = (k, v, k_positions)`` (the
    paged view with the new keys already in it, or the contiguous cache at
    decode): masked attention into that view through ``_sdpa``, since its
    query positions are per row, not the kernel's ``arange``."""
    dt = cdtype(cfg)
    xb = x.to(dt)
    q = dense(xb, p["wq"], "bsd,dhk->bshk", dt)
    q = constrain(q, "batch", None, "heads", "head_dim")
    q = apply_rope(q, positions, cfg.rope_theta)
    scale = cfg.head_dim ** -0.5
    if kv_override is None:
        if positions.ndim != 1:
            raise ValueError("self-attention takes 1-D positions arange(s)")
        if impl == "flash" and is_dtensor(q):
            # the kernel takes plain tensors: a sharded prefill takes the
            # reference's own route, ``_sdpa``
            impl = "naive"
        k, v = project_kv(cfg, p, x, positions)
        k = constrain(k, "batch", None, "kv_heads", "kv_head_dim")
        v = constrain(v, "batch", None, "kv_heads", "kv_head_dim")
        if impl == "flash":
            out = ops.flash_attention(q, k, v, scale=scale,
                                      softcap=cfg.attn_softcap, window=window)
        elif impl == "naive":
            mask = _attn_mask(positions, positions, window)
            # bound score memory when the head axis cannot shard
            hs = logical_spec("heads")
            heads_unsharded = hs is None or hs[0] is None
            qc = 512 if (heads_unsharded and x.shape[1] >= 4096) else 0
            out = _sdpa(q, k, v, mask, cfg.attn_softcap, scale, q_chunk=qc)
        else:
            raise ValueError(f"unknown attention impl {impl!r}")
    else:
        k, v, k_positions = kv_override
        mask = _attn_mask(positions, k_positions, window)
        out = _sdpa(q, k, v, mask, cfg.attn_softcap, scale,
                    constrain_heads=False)
    y = dense(out, p["wo"], "bshk,hkd->bsd", dt)
    y = constrain(y, "batch", None, None)
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
# MLP (dense + MoE)
# --------------------------------------------------------------------------

def mlp_apply(cfg: ModelConfig, p, x):
    dt = cdtype(cfg)
    xb = x.to(dt)
    a = act_fn(cfg.act)
    h = a(dense(xb, p["wg"], "bsd,df->bsf", dt)) * \
        dense(xb, p["wi"], "bsd,df->bsf", dt)
    h = constrain(h, "batch", None, "ff")
    out = dense(h, p["wo"], "bsf,fd->bsd", dt)
    return constrain(out, "batch", None, None)


def _expert_matmul(a: torch.Tensor, b: torch.Tensor,
                   dt: torch.dtype) -> torch.Tensor:
    """``torch.matmul(a, b)`` (batched over the experts) of operands in the
    compute dtype, with f32 sums and the result in ``dt``: one batched GEMM
    in ``dt`` on the card, f32 products of the rounded operands on the CPU
    (``plain_matmul``'s contract). The reference computes the expert
    contractions as jnp einsums, outside any Pallas kernel. Each call keeps
    the experts' weights in their stored (e, d_in, d_out) layout: an einsum
    that put the contracted axis first would copy the weights every call."""
    if a.is_cuda:
        return torch.matmul(a.to(dt), b.to(dt))
    return torch.matmul(a.to(dt).float(), b.to(dt).float()).to(dt)


def moe_router(cfg: ModelConfig, p, x2d):
    """Router: returns (gate_vals (t, k) f32, gate_idx (t, k) int64, aux).

    The top k by a stable descending sort: among equal probabilities the
    lower expert index comes first, as ``lax.top_k`` orders them (bf16
    logits tie often among many experts, and the order of a token's k
    choices feeds the capacity cumsum)."""
    moe = cfg.moe
    logits = dense(x2d, p["router"], "td,de->te", x2d.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :moe.top_k], idx[:, :moe.top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(
        min=1e-9)
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx, moe.num_experts).to(torch.float32).sum(
        dim=1).mean(dim=0)
    aux = moe.aux_loss_weight * moe.num_experts * (me * ce).sum()
    return gate_vals, gate_idx, aux


def moe_apply_dense(cfg: ModelConfig, p, x):
    """Dropless MoE: every expert on every token, the top-k gated combine.
    Exact (no capacity drops), E/k times the FLOPs: the decode path."""
    moe = cfg.moe
    dt = cdtype(cfg)
    b, s, d = x.shape
    t = b * s
    xb = x.reshape(t, d).to(dt)
    gate_vals, gate_idx, aux = moe_router(cfg, p, xb)
    gates = local_call(_dense_gates, gate_idx, gate_vals, moe.num_experts,
                       batch=2)
    a = act_fn(cfg.act)
    # (t, d) against every expert: (e, t, f), then (e, t, d)
    h = a(_expert_matmul(xb, p["wg"], dt)) * _expert_matmul(xb, p["wi"], dt)
    eout = _expert_matmul(h, p["wo"], dt)
    # "ted,te->td": each token's gated sum over the experts
    out = _expert_matmul(eout.permute(1, 2, 0), gates[:, :, None], dt)
    return out.reshape(b, s, d), aux


def _dense_gates(gate_idx, gate_vals, e: int):
    """(t, e) f32: each token's gate values at its chosen experts."""
    gates = torch.zeros((gate_idx.shape[0], e), dtype=torch.float32,
                        device=gate_idx.device)
    return gates.scatter_(1, gate_idx, gate_vals)


MOE_TOKEN_CHUNK = 65_536


def moe_apply(cfg: ModelConfig, p, x, *, capacity_factor=None):
    """Capacity-based MoE over chunks of the sequence: a dispatch of more
    than ``MOE_TOKEN_CHUNK`` tokens runs in sequential chunks, each with its
    own capacity buffer. Returns (out, aux), aux the chunks' mean."""
    b, s, d = x.shape
    t = b * s
    nc = t // MOE_TOKEN_CHUNK if t > MOE_TOKEN_CHUNK else 1
    if nc <= 1 or t % MOE_TOKEN_CHUNK or s % nc:
        return _moe_apply_block(cfg, p, x, capacity_factor=capacity_factor)
    sc = s // nc
    outs, auxs = [], []
    for c in range(nc):
        o, a = _moe_apply_block(cfg, p, x[:, c * sc:(c + 1) * sc],
                                capacity_factor=capacity_factor)
        outs.append(o)
        auxs.append(a)
    return torch.cat(outs, dim=1), torch.stack(auxs).mean()


def capacity_slots(gate_idx, num_experts: int, cap: int):
    """(keep, slot), each (t*k,), of the (token, choice) entries of
    ``gate_idx`` (t, k): an entry's position in its expert's buffer is the
    count of earlier entries (in token, then choice order) routed to that
    expert; it is kept below ``cap``, at slot ``expert * cap + position``
    (``expert * cap`` when dropped). Inside a ``local_call`` region split
    over the batch, the earlier entries include those of the lower shards
    (their counts per expert, all-gathered), so each rank keeps the entries
    of the global order."""
    flat_expert = gate_idx.reshape(-1)
    # the reference's one-hot cumsum, by a stable sort: entries grouped by
    # expert keep their (token, choice) order, and an entry's position is
    # its rank in its group (a cumsum down a (t*k, e) one-hot is a scan of
    # e columns)
    order = torch.argsort(flat_expert, stable=True)
    # the per-expert counts (``bincount``'s, by a scatter-add whose output
    # shape does not depend on the data, as a dry run's meta tensors need)
    counts = torch.zeros(num_experts, dtype=flat_expert.dtype,
                         device=flat_expert.device).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    first = counts.cumsum(dim=0) - counts - shard_prefix_sum(counts)
    ranks = torch.arange(flat_expert.shape[0], device=flat_expert.device)
    pos = torch.empty_like(flat_expert)
    pos[order] = ranks - first[flat_expert[order]]
    keep = pos < cap
    slot = flat_expert * cap + torch.where(keep, pos, torch.zeros_like(pos))
    return keep, slot


def _moe_apply_block(cfg: ModelConfig, p, x, *, capacity_factor=None):
    """Capacity-based top-k MoE (GShard-style dispatch). Each expert takes
    at most C = ceil(T * k / E * capacity_factor) of the (token, choice)
    entries, in (token, choice) order; the rest are dropped. Returns (out,
    aux).

    The dispatch is an indexed write of the kept entries (each has a slot of
    its own; the reference's scatter-add of a dropped entry adds zeros), and
    the combine sums a token's k weighted outputs in choice order in the
    compute dtype, as the reference's scatter-add does (an ``index_add_``
    on the card has no order)."""
    moe = cfg.moe
    dt = cdtype(cfg)
    b, s, d = x.shape
    t = b * s
    e, k = moe.num_experts, moe.top_k
    cf = capacity_factor if capacity_factor is not None \
        else moe.capacity_factor
    cap = int(t * k / e * cf + 0.999)
    cap = max(min(cap, t), 1)

    # the reference pins its bf16 casts here and below (``pin``: an
    # optimization barrier with a gradient rule) so that XLA keeps the
    # scatters and their collectives in the compute dtype; eager PyTorch
    # runs each op in the dtype it is given, so nothing needs pinning
    #
    # Over DTensors the slot bookkeeping, the dispatch and the combine run
    # on each rank's own tokens (``local_call``; the capacity order stays
    # the global one of the reference, ``capacity_slots``), the dispatch
    # into a buffer summed over the ranks that split the tokens, and the
    # expert products sharded.
    xb = constrain(x.reshape(t, d).to(dt), "moe_tokens", None)
    gate_vals, gate_idx, aux = moe_router(cfg, p, xb)
    keep, slot = local_call(capacity_slots, gate_idx, e, cap, batch=1)
    buf = local_call(_moe_dispatch, xb, keep, slot, e, cap, k, batch=3,
                     partial_out=True)
    buf = constrain(buf, "expert", None, None)

    a = act_fn(cfg.act)
    h = a(_expert_matmul(buf, p["wg"], dt)) * _expert_matmul(buf, p["wi"], dt)
    h = constrain(h, "expert", None, "moe_ff")
    eout = constrain(_expert_matmul(h, p["wo"], dt), "expert", None, None)
    out = local_call(_moe_combine, gate_vals, keep, slot,
                     eout.reshape(e * cap, d), k, batch=3)
    return constrain(out.reshape(b, s, d), "batch", None, None), aux


def _moe_dispatch(xb, keep, slot, e: int, cap: int, k: int):
    """The (e, cap, d) expert buffers: each kept entry's token row at its
    slot, zeros elsewhere."""
    t, d = xb.shape
    tok_idx = torch.arange(t, device=xb.device).repeat_interleave(k)
    buf = torch.zeros((e * cap + 1, d), dtype=xb.dtype, device=xb.device)
    buf[torch.where(keep, slot, torch.full_like(slot, e * cap))] = \
        xb[tok_idx]                            # dropped entries: row e*cap
    return buf[:e * cap].reshape(e, cap, d)


def _moe_combine(gate_vals, keep, slot, eout, k: int):
    """Each token's k gated expert outputs summed in choice order."""
    t, d = gate_vals.shape[0], eout.shape[1]
    w = (gate_vals.reshape(-1) * keep).to(eout.dtype)
    weighted = (eout[slot] * w[:, None]).reshape(t, k, d)
    out = torch.zeros((t, d), dtype=eout.dtype, device=eout.device)
    for j in range(k):
        out = out + weighted[:, j]
    return out
