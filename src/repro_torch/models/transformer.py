"""Top-level LM pieces the serving path uses. Port of ``_embed``,
``_unembed`` and ``init_params`` from ``repro/models/transformer.py``.

``init_params`` builds the reference's tree (same paths, shapes and scales)
from a ``torch.Generator``; its numbers differ from ``jax.random``'s, so the
tests feed both packages converted JAX weights instead
(``repro_torch.convert``). The layer loop over super-blocks lives in
``models/paged.py`` as a Python loop (the reference scans).
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random f32 params, shaped like the reference's ``init_params``."""
    if cfg.moe is not None or any(k not in ("attn", "local_attn")
                                  for k in cfg.pattern):
        raise NotImplementedError("only dense attention models are ported")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = cfg.n_superblocks()
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, dh = cfg.heads_eff, cfg.num_kv_heads, cfg.head_dim

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(scale)

    def norm():
        p = {"scale": torch.zeros((n, d), device=dev)}
        if cfg.norm == "layernorm":
            p = {"scale": torch.ones((n, d), device=dev),
                 "bias": torch.zeros((n, d), device=dev)}
        return p

    params = {
        "embed": {"w": normal((v, d), d ** -0.5)},
        "final_norm": {k: t[0] for k, t in norm().items()},
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": normal((d, v), d ** -0.5)}
    blocks = []
    for _ in cfg.pattern:
        blocks.append({
            "norm1": norm(),
            "attn": {"wq": normal((n, d, hq, dh), d ** -0.5),
                     "wk": normal((n, d, hkv, dh), d ** -0.5),
                     "wv": normal((n, d, hkv, dh), d ** -0.5),
                     "wo": normal((n, hq, dh, d), (hq * dh) ** -0.5)},
            "norm2": norm(),
            "mlp": {"wi": normal((n, d, f), d ** -0.5),
                    "wg": normal((n, d, f), d ** -0.5),
                    "wo": normal((n, f, d), f ** -0.5)},
        })
    params["blocks"] = tuple(blocks)
    return params


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["w"][tokens].to(L.cdtype(cfg))


def _unembed(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    dt = L.cdtype(cfg)
    if cfg.tie_embeddings:
        w = params["embed"]["w"]
        logits = L.plain_matmul(x.reshape(-1, x.shape[-1]), w.T, dt)
        logits = logits.reshape(tuple(x.shape[:-1]) + (w.shape[0],)).to(dt)
    else:
        # the head may arrive still sealed (tile layout) on the serving path
        logits = L.dense(x.to(dt), params["head"]["w"], "bsd,dv->bsv", dt)
    return L.softcap(logits.float(), cfg.logit_softcap)
