"""VGG-16 / ResNet-18 / ResNet-34 — the paper's evaluation CNNs. Port of
``repro/models/cnn.py``.

Used by (a) the security evaluation (substitute models, Figs 8-9) and
(b) the analytic traffic model (per-layer weight / feature-map byte counts
feeding the IPC figures). Channel-wise LayerNorm replaces BatchNorm, as in
the reference.

The params are the reference's tree: a list with one dict per stage (``{}``
for a pool), conv weights HWIO ``(k, k, c_in, c_out)``, the residual
``proj`` a 1x1 HWIO kernel, FC weights ``(in, out)``; activations are NHWC.
So every SE mask, freeze mask and row index is the reference's axis. A
convolution permutes at its edge: an NHWC tensor seen as NCHW is
``channels_last``, which cuDNN takes as it is, and the weight goes to
OIHW. Padding is lax's "SAME": ``pad_total = max((out - 1) * s + k - in,
0)`` with ``pad_total // 2`` low, so a 3x3 stride-2 conv on an even size
pads 0 low and 1 high, and the 2x2/2 max pool pads odd sizes high with
-inf. Gradients come from autograd.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.config import CNNConfig
from repro_torch.device import resolve_device


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def he_normal(key, shape):
    """He-normal f32 weights of ``shape`` whose fan-in is all but the last
    axis: ``jax.random.normal(key, shape) * jnp.sqrt(2.0 / fan_in)``, the
    quotient rounded to f32 before its square root."""
    fan_in = 1
    for d in shape[:-1]:
        fan_in *= d
    return prng.normal(key, shape) * torch.sqrt(torch.tensor(
        2.0 / fan_in, dtype=torch.float32, device=key.device))


def init_cnn(cfg: CNNConfig, key: torch.Tensor, device=None) -> List[dict]:
    """The reference's ``init_cnn`` under the key data ``key`` (2,)
    (``prng.key(seed)``), on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    key = key.to(dev)
    params: List[dict] = []
    ch = cfg.in_ch
    flat_dim = None
    for i, sp in enumerate(cfg.stages):
        ki = prng.fold_in(key, i)
        if sp.kind == "conv":
            p = {"w": he_normal(ki, (sp.kernel, sp.kernel, ch, sp.out_ch)),
                 "b": torch.zeros(sp.out_ch, device=dev),
                 "ln_s": torch.ones(sp.out_ch, device=dev),
                 "ln_b": torch.zeros(sp.out_ch, device=dev)}
            if sp.residual and (sp.stride != 1 or sp.out_ch != ch):
                p["proj"] = he_normal(prng.fold_in(ki, 1),
                                      (1, 1, ch, sp.out_ch))
            params.append(p)
            ch = sp.out_ch
        elif sp.kind == "pool":
            params.append({})
        else:  # fc
            if flat_dim is None:
                flat_dim = ch  # global average pool -> (B, ch)
            params.append({"w": he_normal(ki, (flat_dim, sp.out_ch)),
                           "b": torch.zeros(sp.out_ch, device=dev)})
            flat_dim = sp.out_ch
    return params


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def same_pads(size: int, k: int, s: int):
    """(low, high) padding of lax's "SAME" along one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x):
    """An NHWC tensor as an NCHW (channels_last) one, and back."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv2d(x, w, stride: int):
    """x (B, H, W, C_in) NHWC, w (k, k, C_in, C_out) HWIO -> NHWC, "SAME"."""
    k = w.shape[0]
    (hl, hh), (wl, wh) = (same_pads(x.shape[1], k, stride),
                          same_pads(x.shape[2], k, stride))
    xc = _nchw(x).contiguous(memory_format=torch.channels_last)
    if hl == hh == wl == wh:
        pad = hl
    else:
        xc = F.pad(xc, (wl, wh, hl, hh)).contiguous(
            memory_format=torch.channels_last)
        pad = 0
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return _nhwc(F.conv2d(xc, wc, stride=stride, padding=pad))


def max_pool(x):
    """``reduce_window`` max 2x2/2 "SAME" with -inf padding, NHWC."""
    (hl, hh), (wl, wh) = same_pads(x.shape[1], 2, 2), same_pads(x.shape[2],
                                                                 2, 2)
    xc = _nchw(x)
    if hh or wh:
        xc = F.pad(xc, (wl, wh, hl, hh), value=float("-inf"))
    return _nhwc(F.max_pool2d(xc, 2, 2))


def chan_ln(x, s, b, eps: float = 1e-5):
    """LayerNorm over the channel axis with the population variance."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * s + b


def cnn_forward(cfg: CNNConfig, params, x):
    """x: (B, H, W, C) -> logits (B, num_classes)."""
    i = 0
    stages = cfg.stages
    n = len(stages)
    flat = None
    while i < n:
        sp = stages[i]
        p = params[i]
        if sp.kind == "conv" and sp.residual:
            # residual pair (ResNets): conv-ln-relu-conv-ln + skip
            sp2, p2 = stages[i + 1], params[i + 1]
            h = conv2d(x, p["w"], sp.stride) + p["b"]
            h = torch.relu(chan_ln(h, p["ln_s"], p["ln_b"]))
            h = conv2d(h, p2["w"], sp2.stride) + p2["b"]
            h = chan_ln(h, p2["ln_s"], p2["ln_b"])
            skip = x if "proj" not in p else conv2d(x, p["proj"], sp.stride)
            x = torch.relu(h + skip)
            i += 2
        elif sp.kind == "conv":
            h = conv2d(x, p["w"], sp.stride) + p["b"]
            x = torch.relu(chan_ln(h, p["ln_s"], p["ln_b"]))
            i += 1
        elif sp.kind == "pool":
            x = max_pool(x)
            i += 1
        else:  # fc
            if flat is None:
                flat = x.mean(dim=(1, 2))       # global average pool
            flat = flat @ p["w"] + p["b"]
            if i < n - 1:
                flat = torch.relu(flat)
            i += 1
    return flat


def cnn_loss(cfg: CNNConfig, params, batch):
    """(mean cross-entropy, accuracy) of ``batch`` {"x": NHWC, "y": labels}."""
    logits = cnn_forward(cfg, params, batch["x"])
    labels = batch["y"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    loss = (logz - gold).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


# --------------------------------------------------------------------------
# traffic accounting for the analytic perf model (paper Figs 10-15)
# --------------------------------------------------------------------------

def layer_traffic(cfg: CNNConfig, dtype_bytes: int = 4) -> List[dict]:
    """Per-layer byte counts: weights, input FM, output FM.

    Mirrors the paper's Figure-4 accounting: a CONV layer reads its input
    feature maps + weights and writes output feature maps; POOL reads/writes
    FMs with no weights; FC reads a vector + weight matrix.
    """
    out: List[dict] = []
    ch, size = cfg.in_ch, cfg.img_size
    flat_dim = None
    for sp in cfg.stages:
        if sp.kind == "conv":
            in_fm = size * size * ch
            size2 = -(-size // sp.stride)
            out_fm = size2 * size2 * sp.out_ch
            w = sp.kernel * sp.kernel * ch * sp.out_ch
            # MACs: out positions x kernel volume
            macs = out_fm * sp.kernel * sp.kernel * ch
            out.append(dict(kind="conv", in_ch=ch, out_ch=sp.out_ch,
                            weight_bytes=w * dtype_bytes,
                            in_fm_bytes=in_fm * dtype_bytes,
                            out_fm_bytes=out_fm * dtype_bytes, macs=macs))
            ch, size = sp.out_ch, size2
        elif sp.kind == "pool":
            in_fm = size * size * ch
            size = -(-size // sp.stride)
            out_fm = size * size * ch
            out.append(dict(kind="pool", in_ch=ch, out_ch=ch,
                            weight_bytes=0,
                            in_fm_bytes=in_fm * dtype_bytes,
                            out_fm_bytes=out_fm * dtype_bytes,
                            macs=out_fm * 4))
        else:
            if flat_dim is None:
                flat_dim = ch
            w = flat_dim * sp.out_ch
            out.append(dict(kind="fc", in_ch=flat_dim, out_ch=sp.out_ch,
                            weight_bytes=w * dtype_bytes,
                            in_fm_bytes=flat_dim * dtype_bytes,
                            out_fm_bytes=sp.out_ch * dtype_bytes, macs=w))
            flat_dim = sp.out_ch
    return out
