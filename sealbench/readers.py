"""Arithmetic that several per-layer readers share: the traced stretch's
launches attributed to kernels, and their bounds from the frozen
yardstick."""
from __future__ import annotations

from typing import Dict, Optional

from sealbench import roofline_work as W

FUSED = ("sealed_matmul_dec", "sealed_matmul_tc", "sealed_matmul")


def _delta(d: dict, name: str) -> int:
    return d["after"].get(name, 0) - d["before"].get(name, 0)


def matmul_bound_ms(run) -> Optional[Dict[str, tuple]]:
    """kernel -> (summed bound in ms, launches counted) of the fused
    matmuls of every traced dispatch. A dispatch's launches are given to
    the kernels by the program's counters: the decode kernel takes the
    smallest M, the prefill kernel the rest. None if a dispatch's counters
    do not add up to its launches."""
    out = {"sealed_matmul_dec": [0.0, 0], "sealed_matmul_tc": [0.0, 0]}
    for d in run.dispatches:
        launches = sorted(W.matmul_launches(run.config, d["shape"]))
        n_dec, n_tc = (_delta(d, k) for k in FUSED[:2])
        if _delta(d, "sealed_matmul") or n_dec + n_tc != len(launches):
            return None
        for i, (m, k, n, rows) in enumerate(launches):
            acc = out["sealed_matmul_dec" if i < n_dec else "sealed_matmul_tc"]
            acc[0] += W.sealed_bound(m, k, n, rows, 2)[0]
            acc[1] += 1
    return {k: (v[0], v[1]) for k, v in out.items()}


def share(bound_ms: float, counted: int, stretch, kernel: str
          ) -> Optional[float]:
    """A kernel's share of its roofline, in %: the mean bound of its counted
    launches over the mean device time of its traced ones (the profiler
    may drop a record; the two counts agree when it drops none). None when
    nothing was counted or traced."""
    seconds, traced = stretch.time_of(kernel)
    if not counted or not traced or seconds <= 0:
        return None
    return 100.0 * (bound_ms / counted) / (1e3 * seconds / traced)
