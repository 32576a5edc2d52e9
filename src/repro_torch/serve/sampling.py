"""Per-request token sampling: temperature / top-k / top-p, batched. Port
of ``repro/serve/sampling.py``.

Every request carries its own PRNG stream: its base key is
``fold_in(key(sample_seed), rid)`` and its n-th generated token draws under
``fold_in(base_key, n)``, so a stream depends on (seed, rid, n) only, not
on slot placement or batch composition. The generator is the reference's
own threefry2x32 (``repro_torch.prng``), so the streams are the reference's
bit for bit, where the logits are.

Every filter works per row, so one batched call serves slots with mixed
settings; ``temperature == 0`` selects the exact argmax.
"""
from __future__ import annotations

import torch

from repro_torch import prng


def request_key_data(sample_seed: int, rid: int) -> torch.Tensor:
    """(2,) int32 key data of a request's base PRNG key (host side)."""
    return prng.key_data(prng.fold_in(prng.key(sample_seed), rid))


def fold_token_keys(key_data: torch.Tensor,
                    counts: torch.Tensor) -> torch.Tensor:
    """key_data (B, 2) int32 per-request base keys; counts (B,) index of
    the token each row samples. Returns (B, 2) int32 keys."""
    return prng.fold_in(key_data, counts)


def sample_logits(logits: torch.Tensor, keys=None, temperature=None,
                  top_k=None, top_p=None, *, greedy: bool = True
                  ) -> torch.Tensor:
    """logits (B, V) f32 -> (B,) int64 tokens.

    ``greedy`` is the host's knowledge that every row's temperature is
    <= 0: the call is then the argmax alone (the first maximal index, as
    ``jnp.argmax``) and launches nothing else, which is the reference's
    all-greedy short-circuit without a device-to-host read. Otherwise
    ``keys`` (B, 2) from ``fold_token_keys`` and the per-row settings
    ``temperature``/``top_k``/``top_p`` (B,) (``top_k <= 0``: no cut) go to
    ``_sample_full``."""
    greedy_tok = torch.argmax(logits, dim=-1)
    if greedy:
        return greedy_tok
    return _sample_full(logits, keys, temperature, top_k, top_p, greedy_tok)


def _sample_full(logits, keys, temperature, top_k, top_p, greedy):
    """Rows sorted by logit, descending (stable: ties by index, as
    ``jnp.argsort``); the top-k rank cut and the top-p nucleus cut (an entry
    stays while the mass before it is below top_p, so the argmax always
    survives); the survivors sampled at ``logits / temperature``."""
    v = logits.shape[1]
    t = torch.clamp(temperature, min=1e-6)[:, None]
    sort_idx = torch.sort(-logits, dim=-1, stable=True).indices
    sorted_scaled = torch.gather(logits / t, 1, sort_idx)
    probs = torch.softmax(sorted_scaled, dim=-1)
    ranks = torch.arange(v, device=logits.device)[None, :]
    keep = ranks < torch.where(top_k > 0, top_k, v)[:, None]
    cum = torch.cumsum(probs, dim=-1)
    keep &= (cum - probs) < top_p[:, None]
    filt = torch.where(keep, sorted_scaled,
                       torch.full_like(sorted_scaled, float("-inf")))
    picked = prng.categorical(keys, filt)
    sampled = torch.gather(sort_idx, 1, picked[:, None])[:, 0]
    return torch.where(temperature > 0, sampled, greedy)
