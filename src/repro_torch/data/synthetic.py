"""Deterministic synthetic data: token streams for LM training and a
10-class image set for the paper's CNN security evaluation. Port of
``repro/data/synthetic.py`` (``TokenStream``, ``lm_batch``,
``image_dataset``). It is numpy, so the port's batches, images and labels
are the reference's bit for bit.

Both are pure functions of (seed, index), so any worker can regenerate any
shard independently: the loader's state is just an integer step, which is
what makes a resumed run see the straight run's data.
"""
from __future__ import annotations

import numpy as np

from repro_torch.config import ModelConfig


class TokenStream:
    """Markov-ish synthetic LM data with learnable structure (n-gram
    transitions + copy motifs), deterministic in (seed, step, shard)."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0, n_shards: int = 1, shard: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch
        self.seed = seed
        self.n_shards = n_shards
        self.shard = shard
        assert batch % n_shards == 0
        r = np.random.RandomState(seed)
        k = min(vocab_size, 512)
        self._k = k
        # sparse transition table: each symbol prefers 8 successors
        self._succ = r.randint(0, k, size=(k, 8))

    def batch_at(self, step: int):
        """(tokens, targets) for this shard at a given global step."""
        b = self.batch // self.n_shards
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 131 + self.shard) % (2**31 - 1))
        toks = np.empty((b, self.seq + 1), np.int32)
        toks[:, 0] = rng.randint(0, self._k, size=b)
        noise = rng.random((b, self.seq))
        succ_pick = rng.randint(0, 8, size=(b, self.seq))
        rand_tok = rng.randint(0, self._k, size=(b, self.seq))
        for t in range(self.seq):
            nxt = self._succ[toks[:, t], succ_pick[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.85, nxt, rand_tok[:, t])
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def lm_batch(cfg: ModelConfig, batch: int, seq: int, step: int, seed: int = 0):
    """One training batch of numpy arrays: ``tokens`` and ``targets`` from a
    ``TokenStream``, or for a frontend-stub config the frontend's stand-in,
    ``embeds`` (B, S, d_model) f32, with random ``targets``."""
    if cfg.frontend is not None:
        rng = np.random.RandomState(seed * 7919 + step)
        return {
            "embeds": rng.standard_normal((batch, seq, cfg.d_model)
                                          ).astype(np.float32) * 0.02,
            "targets": rng.randint(0, cfg.vocab_size,
                                   size=(batch, seq)).astype(np.int32),
        }
    ts = TokenStream(cfg.vocab_size, seq, batch, seed=seed)
    return ts.batch_at(step)


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
