"""The one traffic generator: it reads a mix file (``traffic/<mix>.json``)
and makes the requests of a closed loop from the seed.

Lengths come from a fixed pool: ``pool`` pairs of (prompt, output) lengths
at the quantiles of a two-dimensional low-discrepancy sequence (Roberts'
R2: pair j takes quantiles frac(0.5 + j / g) and frac(0.5 + j / g ** 2),
g the plastic number), so that every run of consecutive pairs covers both
distributions evenly. A length is log-normal about the median the mix
states, clamped to its ``min`` and ``max`` (a slot holds ``max_len``).
Every seed walks the same pool from a starting point
of its own, round and round: seeds change which requests meet in a batch,
not how much work a window holds.
Prompt token ids are uniform over the vocabulary. A client's first request
takes the residual life of its length as its output budget, a share in
(0, 1] of it, so that completions are staggered from the start; the
clients' shares are stratified, (i + 0.5) / clients in an order drawn
from the seed, so that every seed starts with the same work in flight.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np

# the plastic number, root of x ** 3 = x + 1
PLASTIC = 1.324717957244746


def quantile(dist: dict, u: float) -> int:
    """The length at quantile ``u`` of a length distribution of the mix:
    ``median * exp(sigma * z)``, z the standard normal's quantile ``u``,
    clamped to [min, max]."""
    if dist["dist"] != "log_normal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    x = dist["median"] * math.exp(dist["sigma"] * NormalDist().inv_cdf(u))
    return int(min(dist["max"], max(dist["min"], round(x))))


def length_pool(mix: dict) -> List[Tuple[int, int]]:
    """The mix's (prompt, output) length pairs, the same for every seed."""
    return [(quantile(mix["prompt_tokens"], (0.5 + j / PLASTIC) % 1.0),
             quantile(mix["output_tokens"], (0.5 + j / PLASTIC ** 2) % 1.0))
            for j in range(mix["pool"])]


class Traffic:
    """The requests of one run, in the order the clients ask for them."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.vocab = vocab
        self.rng = np.random.default_rng([seed % 2 ** 63, 0])
        self.pool = length_pool(mix)
        self._next = int(self.rng.integers(len(self.pool)))

    def lengths(self) -> Tuple[int, int]:
        pair = self.pool[self._next]
        self._next = (self._next + 1) % len(self.pool)
        return pair

    def prompt(self, n: int) -> np.ndarray:
        return self.rng.integers(0, self.vocab, size=n, dtype=np.int64
                                 ).astype(np.int32)

    def residuals(self, n: int) -> List[float]:
        """The residual-life shares of ``n`` clients' first requests."""
        return [(i + 0.5) / n for i in self.rng.permutation(n)]

    def next_request(self, residual: float = 1.0) -> Tuple[np.ndarray, int]:
        """(prompt ids, output budget): ``residual`` of the output length,
        rounded up (a first request's residual life)."""
        p, o = self.lengths()
        return self.prompt(p), max(1, math.ceil(residual * o))


def warmup_prompts(mix: dict, seed: int, vocab: int) -> List[List[np.ndarray]]:
    """Rounds of warm-up prompts: round r holds ``admit width - r`` prompts
    of one chunk each, so the chunked prefill runs at every row count from
    the admit width down to one (largest first) and the decode tick runs
    too. The ids come from a stream of their own."""
    rng = np.random.default_rng([seed % 2 ** 63, 1])
    width = mix["admit_batch"]
    return [[rng.integers(0, vocab, size=mix["chunk_tokens"], dtype=np.int64
                          ).astype(np.int32) for _ in range(width - r)]
            for r in range(width)]

