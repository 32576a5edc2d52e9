"""Token sampling, greedy path. Port of the ``temperature == 0`` branch of
``repro/serve/sampling.py``.

The reference samples rows with temperature > 0 from jax's threefry stream
(``fold_in`` + ``categorical``), which PyTorch cannot reproduce bit for bit;
that path comes with the sampling slice of the port (temperature / top-k /
top-p), where the choice between a threefry port and distribution tests is
made.
"""
from __future__ import annotations

import torch

SAMPLING_SLICE = ("temperature / top-k / top-p sampling is not ported yet: "
                  "it comes with the sampling slice of the port")


def check_greedy(temperature: float, top_k: int, top_p: float) -> None:
    """Raise unless the settings ask for plain greedy decoding."""
    if temperature > 0 or top_k > 0 or top_p < 1.0:
        raise NotImplementedError(SAMPLING_SLICE)


def sample_logits(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) f32 -> (B,) int64 argmax (first maximal index, as jnp)."""
    return torch.argmax(logits, dim=-1)
