"""Warmup + cosine decay LR schedule. Port of ``repro/optim/schedule.py``,
computed in f32 as jnp computes it (python constants rounded to f32)."""
from __future__ import annotations

import math

import torch

from repro_torch.config import TrainConfig


def lr_at(step, tc: TrainConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor or a python int), a 0-d
    f32 tensor on the step's device."""
    step = (step.float() if torch.is_tensor(step)
            else torch.tensor(float(step), dtype=torch.float32))
    warm = torch.clamp((step + 1) / max(tc.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - tc.warmup_steps) /
                    max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    floor = 0.1
    return tc.learning_rate * warm * (floor + (1 - floor) * cos)
