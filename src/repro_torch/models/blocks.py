"""Residual blocks: attention (global / local), RG-LRU (Griffin) and
Mamba2's SSD. Port of ``repro/models/blocks.py`` in four modes:

* ``train``: the differentiable pass over the whole sequence
  (self-attention through ``layers._sdpa``, the recurrences as at
  prefill), with no cache and no update;
* ``prefill``: one-shot pass over the prompt (self-attention through the
  flash kernel, the recurrences over the whole sequence), which returns the
  contiguous layer cache it fills;
* ``decode``: one token against the cache: attention into [cache ++ new
  kv], over the contiguous cache (1-D positions, one for the whole batch)
  or the paged view (per-slot (B, 1) positions); a recurrent layer's
  single step from its state;
* ``chunk``: chunked prefill over the paged view (attention only).

An MoE layer's MLP is ``layers.moe_apply_dense`` at decode and
``layers.moe_apply`` (capacity routing) in the other two modes. The
recurrences are jnp in the reference (``lax.associative_scan``,
``lax.scan``) and plain PyTorch here: the RG-LRU scan a log-depth doubling
scan, SSD's chunked dual form as the reference's einsums in f32; both
are out of place, so autograd differentiates them as they stand.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import cache as MC
from repro_torch.models import layers as L
from repro_torch.sharding.api import constrain, local_call


def attn_block_sub_apply(cfg: ModelConfig, kind: str, p, h, positions, mode,
                         cache):
    """train: self-attention at positions ``arange(s)`` through the
    differentiable ``_sdpa``; returns (out, None). prefill: self-attention
    of the prompt at positions ``arange(s)``; returns (out, new layer
    cache). decode: attend into [cache view ++ new
    kv]; chunk: scatter the chunk's new K/V into the dense view at their
    absolute positions (view index == position), then attend. Both return
    (out, {"k_new", "v_new"})."""
    window = cfg.window if kind == "local_attn" else 0
    if mode == "train":
        out, _ = L.attention_apply(cfg, p, h, positions, window=window,
                                   impl="naive")
        return out, None
    if mode == "prefill":
        return _prefill_sub_apply(cfg, p, h, positions, window, cache)
    k_new, v_new = L.project_kv(cfg, p, h, positions)
    dt = cache["k"].dtype
    k_new, v_new = k_new.to(dt), v_new.to(dt)
    if mode == "decode":
        k_att = torch.cat([cache["k"], k_new], dim=1)
        v_att = torch.cat([cache["v"], v_new], dim=1)
        if positions.ndim == 2:
            # paged: per-slot positions (B, 1), per-slot key positions
            pos_att = torch.cat([cache["pos"], positions], dim=1)
        else:
            # contiguous: one position for the batch, key positions (L,)
            pos_att = torch.cat([cache["pos"], positions[:1].to(
                cache["pos"].dtype)])
    elif mode == "chunk":
        # rows are ragged: row i holds cache["cl"][i] real tokens; padded
        # tokens go to one extra column that is cut off again (the
        # reference's dropped out-of-bounds scatter)
        b, w = cache["k"].shape[:2]
        c = positions.shape[1]
        col = torch.arange(c, device=positions.device)[None, :]
        tgt = torch.where(col < cache["cl"][:, None], positions,
                          torch.full_like(positions, w))
        rows = torch.arange(b, device=positions.device)[:, None]

        def splice(view, new):
            ext = torch.cat([view, view.new_zeros((b, 1) + view.shape[2:])],
                            dim=1)
            ext[rows, tgt] = new
            return ext[:, :w]

        k_att, v_att = splice(cache["k"], k_new), splice(cache["v"], v_new)
        pos_att = cache["pos"]
    else:
        raise NotImplementedError(f"block mode {mode!r} is not ported yet")
    out, _ = L.attention_apply(cfg, p, h, positions, window=window,
                               kv_override=(k_att, v_att, pos_att))
    return out, {"k_new": k_new, "v_new": v_new}


def _prefill_sub_apply(cfg: ModelConfig, p, h, positions, window: int,
                       cache):
    """Self-attention of the prompt, then its K/V written into the layer's
    contiguous cache of ``cache_len`` slots: padded with ``INVALID_POS``
    slots when the prompt is shorter, else its last ``cache_len`` entries
    rolled so that slot == position % cache_len (the ring the decode write
    keeps)."""
    out, (k, v) = L.attention_apply(cfg, p, h, positions, window=window)
    cache_len = cache["k"].shape[1]
    s = k.shape[1]
    if s >= cache_len:
        shift = (s - cache_len) % cache_len
        ks = torch.roll(k[:, -cache_len:], shift, dims=1)
        vs = torch.roll(v[:, -cache_len:], shift, dims=1)
        ps = torch.roll(positions[-cache_len:], shift, dims=0)
    else:
        pad = cache_len - s
        ks = torch.cat([k, k.new_zeros((k.shape[0], pad) + k.shape[2:])], 1)
        vs = torch.cat([v, v.new_zeros((v.shape[0], pad) + v.shape[2:])], 1)
        ps = torch.cat([positions, positions.new_full((pad,),
                                                      MC.INVALID_POS)])
    return out, {"k": ks.to(cache["k"].dtype), "v": vs.to(cache["v"].dtype),
                 "pos": ps.to(torch.int32)}


# --------------------------------------------------------------------------
# causal depthwise conv1d
# --------------------------------------------------------------------------

def _conv_taps(xp, w, s: int):
    """sum_k xp[:, k:k+s] * w[k] in f32, taps in order: xp (B, s+K-1, C)
    f32, w (K, C) f32. Elementwise, so no TF32 convolution on the card."""
    y = xp[:, :s] * w[0]
    for k in range(1, w.shape[0]):
        y = torch.addcmul(y, xp[:, k:k + s], w[k])
    return y


def causal_conv1d(x, w, b):
    """x: (B, S, C); w: (K, C); b: (C,). Depthwise causal conv over the
    input left-padded with K-1 zero rows; weight and bias rounded to x's
    dtype, the taps summed in f32."""
    dt = x.dtype
    xp = F.pad(x.float(), (0, 0, w.shape[0] - 1, 0))
    y = _conv_taps(xp, w.to(dt).float(), x.shape[1])
    return y.to(dt) + b.to(dt)


def causal_conv1d_step(x_new, conv_cache, w, b):
    """x_new: (B, 1, C); conv_cache: (B, K-1, C). Returns (y (B, 1, C),
    cache')."""
    dt = x_new.dtype
    full = torch.cat([conv_cache.to(dt), x_new], dim=1)       # (B, K, C)
    y = _conv_taps(full.float(), w.to(dt).float(), 1)
    return y.to(dt) + b.to(dt), full[:, 1:]


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), without torch's threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# --------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427]
# --------------------------------------------------------------------------

_RGLRU_C = 8.0


def _rglru_coeffs(p, xa):
    """Per-step recurrence coefficients (a, b), each (B, S, W) f32. xa: the
    conv output in the compute dtype."""
    dt = xa.dtype
    r = torch.sigmoid(L.dense(xa, p["w_rg"], "bsw,wv->bsv", dt)
                      + p["b_rg"].to(dt)).float()
    i = torch.sigmoid(L.dense(xa, p["w_ig"], "bsw,wv->bsv", dt)
                      + p["b_ig"].to(dt)).float()
    log_a = -_RGLRU_C * r * _softplus(p["lam"].float())
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * (i * xa.float())


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over axis 1 of (B, S, W): a
    Hillis-Steele doubling scan, ceil(log2 S) rounds of elementwise ops,
    each combining every position with the one ``d`` before it as the
    reference's ``associative_scan`` combine does:
    (a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)."""
    s = a.shape[1]
    for r in range(math.ceil(math.log2(s)) if s > 1 else 0):
        d = 1 << r
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])],
                      dim=1)
        if 2 * d < s:                 # the last round needs no products of a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
    return b


def rglru_scan(p, xa, h0):
    """The recurrence over the sequence: (h (B, S, W) f32, final state)."""
    a, b = _rglru_coeffs(p, xa)
    if h0 is not None:       # fold the initial state into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    return h, h[:, -1]


def rglru_step(p, xa, h_prev):
    """Single decode step. xa: (B, 1, W); h_prev: (B, W) f32."""
    a, b = _rglru_coeffs(p, xa)
    h = a[:, 0] * h_prev + b[:, 0]
    return h[:, None], h


_RGLRU_LEAVES = ("conv_w", "conv_b", "w_rg", "b_rg", "w_ig", "b_ig", "lam")


def _rglru_mix(mode, xa, conv, h, *leaves):
    """The conv and the recurrence of an RG-LRU block: (h (B, S, W) f32,
    its last state, the new conv tail or None)."""
    p = dict(zip(_RGLRU_LEAVES, leaves))
    dt = xa.dtype
    if mode == "decode":
        xa, conv_cache = causal_conv1d_step(xa, conv, p["conv_w"],
                                            p["conv_b"])
        h_seq, h_last = rglru_step(p, xa, h)
        return h_seq, h_last, conv_cache
    if mode not in ("prefill", "train"):
        raise NotImplementedError(f"RG-LRU mode {mode!r} is not ported yet")
    pre_tail = xa[:, -3:]                 # conv width 4: keep 3 rows
    xa = causal_conv1d(xa, p["conv_w"], p["conv_b"])
    h_seq, h_last = rglru_scan(p, xa, None)
    if mode == "train":
        return h_seq, h_last, None
    pad = 3 - pre_tail.shape[1]
    if pad > 0:
        pre_tail = F.pad(pre_tail, (0, 0, pad, 0))
    return h_seq, h_last, pre_tail.to(dt)


def rglru_block_apply(cfg: ModelConfig, p, x, mode, cache):
    dt = L.cdtype(cfg)
    xb = x.to(dt)
    xa = constrain(L.dense(xb, p["w_x"], "bsd,dw->bsw", dt),
                   "batch", None, "rnn_width")
    xg = constrain(L.dense(xb, p["w_gate"], "bsd,dw->bsw", dt),
                   "batch", None, "rnn_width")
    c = cache or {}
    # the conv and the scan on each rank's own rows of the batch
    # (``local_call``) over DTensors, the small weights replicated
    h_seq, h_last, conv = local_call(
        functools.partial(_rglru_mix, mode), xa, c.get("conv"), c.get("h"),
        *(p[k] for k in _RGLRU_LEAVES), batch=3)
    new_cache = None if mode == "train" else {"h": h_last, "conv": conv}
    y = h_seq.to(dt) * F.gelu(xg, approximate="tanh")
    return L.dense(y, p["w_out"], "bsw,wd->bsd", dt), new_cache


# --------------------------------------------------------------------------
# Mamba2 SSD block [arXiv:2405.21060]
# --------------------------------------------------------------------------

def _segsum(x):
    """x: (..., q) log-decays -> (..., q, q) lower-triangular cumulative
    segment sums (-inf above the diagonal)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(xh, dt, A, Bm, Cm, initial_state=None, chunk: int = 128):
    """SSD forward, the chunked dual form.

    xh: (b, s, h, p)  dt: (b, s, h)  A: (h,)  Bm, Cm: (b, s, n) (one group).
    Returns y (b, s, h, p) and the final state (b, h, p, n), f32. Refuses a
    sequence longer than the chunk that is not a multiple of it, as the
    reference does."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise AssertionError(f"seq {s} % chunk {q}")
    nc = s // q

    f32 = torch.float32
    xh, dt, Bm, Cm = (t.to(f32) for t in (xh, dt, Bm, Cm))
    xdt = xh * dt[..., None]                                  # (b,s,h,p)
    dA = dt * A.to(f32)                                       # (b,s,h)

    xdt_c = xdt.reshape(b, nc, q, h, p)
    dA_c = dA.reshape(b, nc, q, h).permute(0, 3, 1, 2)        # (b,h,nc,q)
    B_c, C_c = Bm.reshape(b, nc, q, n), Cm.reshape(b, nc, q, n)
    dA_cs = torch.cumsum(dA_c, dim=-1)                        # (b,h,nc,q)

    # intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(dA_c))                           # (b,h,nc,q,q)
    scores = torch.einsum("bcln,bcsn->bcls", C_c, B_c)        # (b,nc,q,q)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, Lmat, xdt_c)

    # per-chunk contributed states
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)         # (b,h,nc,q)
    states = torch.einsum("bcsn,bhcs,bcshp->bchpn", B_c, decay_states, xdt_c)

    # inter-chunk recurrence: the state at each chunk's start
    chunk_decay = torch.exp(dA_cs[..., -1])                   # (b,h,nc)
    carry = (torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
             if initial_state is None else initial_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[..., c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (b,nc,h,p,n)

    # contribution of the carried state to each step
    state_decay = torch.exp(dA_cs)                            # (b,h,nc,q)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", C_c, prev_states,
                         state_decay)
    return (y_diag + y_off).reshape(b, s, h, p), carry


def ssd_step(xh, dt, A, Bm, Cm, state):
    """Single decode step. xh: (b, h, p), dt: (b, h), Bm/Cm: (b, n), state:
    (b, h, p, n)."""
    f32 = torch.float32
    xh, dt, Bm, Cm, state = (t.to(f32) for t in (xh, dt, Bm, Cm, state))
    decay = torch.exp(dt * A.to(f32))                         # (b,h)
    upd = torch.einsum("bhp,bn->bhpn", xh * dt[..., None], Bm)
    state = state * decay[..., None, None] + upd
    return torch.einsum("bhpn,bn->bhp", state, Cm), state


_SSD_LEAVES = ("conv_w", "conv_b", "dt_bias", "A_log", "D")


def _ssd_mix(cfg: ModelConfig, mode, zxbcdt, conv, state0, *leaves):
    """The conv and the SSD scan of a Mamba2 block: (y (b, s, d_inner) in
    the compute dtype, z, the new state, the new conv tail or None)."""
    p = dict(zip(_SSD_LEAVES, leaves))
    dt_ = zxbcdt.dtype
    b, s = zxbcdt.shape[:2]
    di, n, h, ph = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                    cfg.ssm_head_dim)
    z, xc, Bm, Cm, dtr = torch.split(zxbcdt, [di, di, n, n, h], dim=-1)
    xbc = torch.cat([xc, Bm, Cm], dim=-1)
    new_conv = None
    if mode == "decode":
        xbc, new_conv = causal_conv1d_step(xbc, conv, p["conv_w"],
                                           p["conv_b"])
    elif mode in ("prefill", "train"):
        tail = xbc[:, -(cfg.ssm_conv - 1):]
        xbc = causal_conv1d(xbc, p["conv_w"], p["conv_b"])
        if mode == "prefill":
            pad = (cfg.ssm_conv - 1) - tail.shape[1]
            if pad > 0:
                tail = F.pad(tail, (0, 0, pad, 0))
            new_conv = tail.to(dt_)
    else:
        raise NotImplementedError(f"SSD mode {mode!r} is not ported yet")
    xbc = F.silu(xbc)
    xc, Bm, Cm = torch.split(xbc, [di, n, n], dim=-1)
    xh = xc.reshape(b, s, h, ph)
    dtv = _softplus(dtr.float() + p["dt_bias"])               # (b,s,h)
    A = -torch.exp(p["A_log"])
    if mode == "decode":
        y, state = ssd_step(xh[:, 0], dtv[:, 0], A, Bm[:, 0], Cm[:, 0],
                            state0)
        y = y[:, None]
    else:
        y, state = ssd_chunked(xh, dtv, A, Bm, Cm, None)
    y = y + xh.float() * p["D"][:, None]
    return y.reshape(b, s, di).to(dt_), z, state, new_conv


def ssd_block_apply(cfg: ModelConfig, p, x, mode, cache):
    dt_ = L.cdtype(cfg)
    zxbcdt = L.dense(x.to(dt_), p["w_in"], "bsd,de->bse", dt_)
    c = cache or {}
    # the conv and the SSD scan on each rank's own rows of the batch
    # (``local_call``) over DTensors, the small weights replicated
    y, z, state, new_conv = local_call(
        functools.partial(_ssd_mix, cfg, mode), zxbcdt, c.get("conv"),
        c.get("state"), *(p[k] for k in _SSD_LEAVES), batch=3)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = L.rmsnorm(y * F.silu(z), p["norm_scale"])
    y = constrain(y, "batch", None, "ssm_inner")
    out = L.dense(y, p["w_out"], "bse,ed->bsd", dt_)
    if mode == "train":
        return out, None
    return out, {"state": state, "conv": new_conv}


# --------------------------------------------------------------------------
# unified block apply
# --------------------------------------------------------------------------

def block_apply(cfg: ModelConfig, kind: str, p, x, positions, mode, cache):
    """Returns (x_out, cache update, aux_loss). An MoE layer routes as the
    reference's does: ``decode`` through the dropless dense path,
    ``chunk``, ``prefill`` and ``train`` through the capacity dispatch. A
    recurrent layer's update is its whole new state; an SSD block has no
    MLP."""
    aux = 0.0
    h = L.apply_norm(cfg, p["norm1"], x)
    if kind in ("attn", "local_attn"):
        sub, update = attn_block_sub_apply(cfg, kind, p["attn"], h,
                                           positions, mode, cache)
    elif kind == "rglru":
        sub, update = rglru_block_apply(cfg, p["rec"], h, mode, cache)
    elif kind == "ssd":
        sub, update = ssd_block_apply(cfg, p["ssd"], h, mode, cache)
    else:
        raise ValueError(kind)
    x = x + sub.to(x.dtype)
    if kind != "ssd" and cfg.d_ff:
        h2 = L.apply_norm(cfg, p["norm2"], x)
        if cfg.moe is None:
            m = L.mlp_apply(cfg, p["mlp"], h2)
        elif mode == "decode":
            m, aux = L.moe_apply_dense(cfg, p["mlp"], h2)
        else:
            m, aux = L.moe_apply(cfg, p["mlp"], h2)
        x = x + m.to(x.dtype)
    # sequence-parallel residual stream when the run enables "seq_res"
    x = constrain(x, "batch", "seq_res", None)
    return x, update, aux
