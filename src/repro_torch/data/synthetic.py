"""Deterministic synthetic data. Port of ``image_dataset`` from
``repro/data/synthetic.py``: the 10-class image set of the paper's CNN
security evaluation. It is numpy, so the port's images and labels are the
reference's bit for bit."""
from __future__ import annotations

import numpy as np


def image_dataset(n: int, img: int = 16, classes: int = 10, seed: int = 0,
                  noise: float = 0.35):
    """10-class images (n, img, img, 3) f32 and labels (n,) int32: smooth
    class templates + jitter + noise. Learnable by small CNNs to high
    accuracy, hard enough that weight knowledge matters (the property Figs
    8-9 rely on)."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:img, 0:img].astype(np.float32) / img
    templates = []
    for c in range(classes):
        rc = np.random.RandomState(1000 + c)
        t = np.zeros((img, img, 3), np.float32)
        for _ in range(4):
            fx, fy = rc.uniform(1, 4, 2)
            ph = rc.uniform(0, 2 * np.pi, 3)
            for ch in range(3):
                t[:, :, ch] += np.sin(2 * np.pi * (fx * xx + fy * yy) + ph[ch])
        templates.append(t / 4.0)
    templates = np.stack(templates)
    y = r.randint(0, classes, size=n)
    shift = r.randint(-2, 3, size=(n, 2))
    x = templates[y]
    x = np.stack([np.roll(np.roll(xi, sx, 0), sy, 1)
                  for xi, (sx, sy) in zip(x, shift)])
    x = x + noise * r.standard_normal(x.shape).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32)
