"""The device trace of a stretch of steps: ``torch.profiler`` (CUPTI) over
the stretch, kept in memory, reduced to what the per-layer readers need.

``Stretch`` holds the device operations (kernels, copies, sets) that ran
between the first and the last traced ``engine.step`` span, the host
spans (the benchmark's own ``record_function`` annotations), the union of
the device intervals (``busy_s``) and the stretch's length (``window_s``).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple


def events_of(prof) -> List[Tuple[str, bool, float, float]]:
    """(name, on the device, start s, end s) of every recorded event. The
    profiler's raw results, read as they are: parsing them into
    ``prof.events()`` takes minutes for a stretch of steps. That parse is
    the way only where the raw results lack these fields."""
    try:
        return [(e.name(), str(e.device_type()).endswith("CUDA"),
                 e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
                for e in prof.profiler.kineto_results.events()]
    except (AttributeError, TypeError):
        return [(e.name, str(e.device_type).endswith("CUDA"),
                 e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                for e in prof.events()]


class Stretch:
    def __init__(self, events, span_names, step_name: str = "engine.step"):
        """``events``: ``events_of``'s tuples; ``span_names``: the names
        of the benchmark's spans, which are host annotations and not device
        operations (their device-side mirrors, GPU user annotations, are
        dropped)."""
        host, device = [], []
        for name, on_device, a, b in events:
            if name in span_names:
                if not on_device:
                    host.append((name, a, b))
                continue
            if on_device:
                device.append((name, a, b))
        steps = [h for h in host if h[0] == step_name]
        if not steps:
            raise RuntimeError("the trace holds no engine step")
        self.t0 = min(h[1] for h in steps)
        self.t1 = max(h[2] for h in steps)
        self.steps = len(steps)
        self.host = host
        self.ops = [(n, max(a, self.t0), min(b, self.t1))
                    for n, a, b in device if b > self.t0 and a < self.t1]
        self.window_s = self.t1 - self.t0
        self.busy = _union([(a, b) for _, a, b in self.ops])
        self.busy_s = sum(b - a for a, b in self.busy)

    def time_of(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        ``pattern`` as a whole word."""
        rx = re.compile(rf"\b{re.escape(pattern)}\b")
        hits = [(a, b) for n, a, b in self.ops if rx.search(n)]
        return sum(b - a for a, b in hits), len(hits)

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, a, b in self.ops:
            out[n] = out.get(n, 0.0) + (b - a)
        return out

    def idle_by_span(self) -> Dict[str, float]:
        """Idle device time in the stretch, by the innermost benchmark span
        open on the host at the middle of each gap ("harness" where none
        is: the benchmark's own loop)."""
        out: Dict[str, float] = {}
        edge = self.t0
        gaps = []
        for a, b in self.busy:
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        if self.t1 > edge:
            gaps.append((edge, self.t1))
        for a, b in gaps:
            mid = 0.5 * (a + b)
            open_ = [h for h in self.host if h[1] <= mid < h[2]]
            name = max(open_, key=lambda h: h[1])[0] if open_ else "harness"
            out[name] = out.get(name, 0.0) + (b - a)
        return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def short_name(name: str, width: int = 80) -> str:
    """A kernel's name without its return type, anonymous namespaces,
    template arguments and parameters, cut to ``width``."""
    s = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    depth, out = 0, []
    for ch in s:
        if ch == "(" and depth == 0:
            break
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or s)[:width]


def breakdown(stretch: Stretch, top: int = 10) -> Dict[str, list]:
    ops: Dict[str, float] = {}
    for n, sec in stretch.by_name().items():
        key = short_name(n)
        ops[key] = ops.get(key, 0.0) + sec
    gaps = stretch.idle_by_span()
    return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:top]}


def profile_steps(loop, spans, steps: int, need) -> Optional[Stretch]:
    """Step the loop under the profiler: two steps to let the profiler
    settle, then at least ``steps`` traced steps, more until ``need()``
    holds (at most four times as many). Returns the traced stretch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for _ in range(2):
            loop.step()
        first = len(spans.spans)
        spans.mark = len(spans.dispatches)
        spans.profiling = True
        n = 0
        while n < steps or (not need() and n < 4 * steps):
            loop.step()
            n += 1
        spans.profiling = False
        torch.cuda.synchronize()
    names = {s[0] for s in spans.spans[first:]}
    return Stretch(events_of(prof), names)
