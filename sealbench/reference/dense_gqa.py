"""Plain reference of a dense decoder with grouped-query attention, in f32.

The published block of InternLM2 and Granite-3.0: RMSNorm, attention with
RoPE (rotate-half, ``theta ** (-i / half)``) and grouped K/V heads, a gated
SiLU MLP, residual adds, a final RMSNorm and the unembedding (a head of its
own, or the token embedding tied). The configuration file gives every
constant, Granite's multipliers included, so the same code runs each model
as its file states it.

The weights are made here, from the seed, on the device, one
``torch.randn`` a leaf in the type they are served in (f32). Leaves are
stacked over layers, in the layout the serving engine takes, so the same
tensors go to both sides without a copy. A norm's weight is stored as its
offset from one (the program's convention): this reference multiplies by
``1 + offset``.

Nothing here imports the program. TF32 is turned off by the caller
(``forward`` asserts it), so every f32 product is an f32 product.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

# the std of each norm's offset from one: random, so that the norm weights
# are exercised, and small, as trained RMSNorm weights stay near one
NORM_STD = 0.1
# queries a block of the causal attention, to bound the score buffer
Q_BLOCK = 512


def dims(c: dict) -> Dict[str, int]:
    d = c["hidden_size"]
    hq = c["num_attention_heads"]
    return {"n": c["num_hidden_layers"], "d": d, "hq": hq,
            "hkv": c["num_key_value_heads"],
            "dh": c.get("head_dim") or d // hq,
            "f": c["intermediate_size"], "v": c["vocab_size"]}


def leaves(c: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, std) of every weight, in the order they are drawn."""
    k = dims(c)
    n, d, hq, hkv, dh, f, v = (k[x] for x in ("n", "d", "hq", "hkv", "dh",
                                               "f", "v"))
    # the embedding enters the residual stream at std d ** -0.5 after its
    # multiplier: drawn larger, a tied head's logit of the last token
    # outweighs every other and greedy decoding repeats it
    out = [("embed.w", (v, d), d ** -0.5 / c.get("embedding_multiplier", 1.0)),
           ("final_norm.scale", (d,), NORM_STD)]
    if not c.get("tie_word_embeddings", False):
        out.append(("head.w", (d, v), d ** -0.5))
    out += [("norm1.scale", (n, d), NORM_STD),
            ("attn.wq", (n, d, hq, dh), d ** -0.5),
            ("attn.wk", (n, d, hkv, dh), d ** -0.5),
            ("attn.wv", (n, d, hkv, dh), d ** -0.5),
            ("attn.wo", (n, hq, dh, d), (hq * dh) ** -0.5),
            ("norm2.scale", (n, d), NORM_STD),
            ("mlp.wi", (n, d, f), d ** -0.5),
            ("mlp.wg", (n, d, f), d ** -0.5),
            ("mlp.wo", (n, f, d), f ** -0.5)]
    return out


def make_weights(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight, f32, drawn on ``device`` from ``seed``: the same seed
    and device give the same tensors."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    return {name: torch.randn(shape, generator=gen, device=device,
                              dtype=torch.float32).mul_(std)
            for name, shape, std in leaves(c)}


def _rmsnorm(x, offset, eps):
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + offset)


def _rope(x, positions, theta):
    """x (T, heads, dh) at ``positions`` (T,): rotate-half RoPE."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = positions[:, None].float() * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, scale):
    """Causal attention of q (T, hq, dh) over k, v (T, hkv, dh), each kv
    head shared by hq / hkv query heads; queries in blocks of Q_BLOCK."""
    t, hq, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(t, hkv, g, dh)
    out = torch.empty_like(q)
    for a in range(0, t, Q_BLOCK):
        b = min(t, a + Q_BLOCK)
        s = torch.einsum("qkgd,tkd->kgqt", qg[a:b], k[:b]) * scale
        rows = torch.arange(a, b, device=q.device)[:, None]
        keys = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(keys > rows, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = torch.einsum("kgqt,tkd->qkgd", p, v[:b]).reshape(
            b - a, hq, dh)
    return out


Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def forward(c: dict, w: Dict[str, torch.Tensor], tokens: torch.Tensor,
            at: torch.Tensor, matmul: Optional[Matmul] = None
            ) -> torch.Tensor:
    """Logits (len(at), vocab), f32, of the causal forward pass over
    ``tokens`` (T,) at positions 0..T-1, taken after the positions ``at``:
    row i predicts the token at ``at[i] + 1``. ``matmul`` computes every
    weight contraction (default: f32); attention, norms and RoPE stay f32.
    """
    if tokens.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the reference needs TF32 off")
    mm = matmul or f32_matmul
    k = dims(c)
    n, d, hq, hkv, dh = (k[x] for x in ("n", "d", "hq", "hkv", "dh"))
    eps = c["rms_norm_eps"]
    theta = c["rope_theta"]
    res = c.get("residual_multiplier", 1.0)
    scale = c.get("attention_multiplier") or dh ** -0.5
    t = tokens.shape[0]
    pos = torch.arange(t, device=tokens.device)
    x = w["embed.w"][tokens] * c.get("embedding_multiplier", 1.0)
    for i in range(n):
        h = _rmsnorm(x, w["norm1.scale"][i], eps)
        q = mm(h, w["attn.wq"][i].reshape(d, hq * dh)).reshape(t, hq, dh)
        kk = mm(h, w["attn.wk"][i].reshape(d, hkv * dh)).reshape(t, hkv, dh)
        vv = mm(h, w["attn.wv"][i].reshape(d, hkv * dh)).reshape(t, hkv, dh)
        o = _attend(_rope(q, pos, theta), _rope(kk, pos, theta), vv, scale)
        x = x + res * mm(o.reshape(t, hq * dh),
                         w["attn.wo"][i].reshape(hq * dh, d))
        h = _rmsnorm(x, w["norm2.scale"][i], eps)
        gate = torch.nn.functional.silu(mm(h, w["mlp.wg"][i]))
        x = x + res * mm(gate * mm(h, w["mlp.wi"][i]), w["mlp.wo"][i])
    x = _rmsnorm(x[at], w["final_norm.scale"], eps)
    head = w["embed.w"].T if c.get("tie_word_embeddings", False) \
        else w["head.w"]
    return mm(x, head) / c.get("logits_scaling", 1.0)


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's contraction: both operands rounded to float8 e4m3,
    each row of ``x`` and each column of ``w`` scaled to the format's
    largest value first, then an f32 product of the rounded values: the
    precision one step below the configuration's bf16."""
    top = torch.finfo(torch.float8_e4m3fn).max

    def q(t, dim):
        s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / top
        return (t / s).to(torch.float8_e4m3fn).float() * s

    return q(x, 1) @ q(w, 0)


def describe(c: dict) -> str:
    k = dims(c)
    return (f"{k['n']} layers, d {k['d']}, heads {k['hq']}/{k['hkv']} of "
            f"{k['dh']}, d_ff {k['f']}, vocab {k['v']}, "
            f"{sum(math.prod(s) for _, s, _ in leaves(c)) / 1e9:.3f} B")
