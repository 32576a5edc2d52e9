"""Spans and dispatch records, taken from the benchmark's own files.

``Spans.install`` wraps each call named by ``port.span_targets`` at run
time (an instance attribute over the engine's method, a module attribute
over a step function) and edits no file of the program. Each call records
(name, start, end) on the host clock, and, while a profiler runs, opens a
``torch.profiler.record_function`` of the same name, so that the device
trace can name what the host was doing. A dispatch (``engine.chunk_tick``,
``engine.decode_tick``) also records its shape from the engine's host
mirrors and the program's launch counters before and after it.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

DISPATCHES = {"engine.chunk_tick": "chunk_shape",
              "engine.decode_tick": "decode_shape"}


class Spans:
    def __init__(self, port, clock: Callable[[], float] = time.perf_counter):
        self.port = port
        self.clock = clock
        self.spans: List[tuple] = []          # (name, t0, t1)
        self.dispatches: List[dict] = []
        self.profiling = False
        self.mark = 0                          # first traced dispatch
        self._undo: List[tuple] = []

    def install(self, eng) -> None:
        for obj, attr, name in self.port.span_targets(eng):
            orig = getattr(obj, attr)
            had = attr in vars(obj)
            setattr(obj, attr, self._wrap(eng, orig, name))
            self._undo.append((obj, attr, orig, had))

    def remove(self) -> None:
        for obj, attr, orig, had in reversed(self._undo):
            if had:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        self._undo.clear()

    def _wrap(self, eng, fn, name: str):
        shape_of = getattr(self.port, DISPATCHES[name]) \
            if name in DISPATCHES else None

        def wrapped(*args, **kw):
            rec: Optional[Dict] = None
            if shape_of is not None:
                rec = {"shape": shape_of(eng),
                       "before": self.port.launch_counts()}
            ctx = self._annotation(name) if self.profiling \
                else contextlib.nullcontext()
            with ctx:
                t0 = self.clock()
                out = fn(*args, **kw)
                t1 = self.clock()
            self.spans.append((name, t0, t1))
            if rec is not None:
                rec["after"] = self.port.launch_counts()
                rec["t0"], rec["t1"] = t0, t1
                self.dispatches.append(rec)
            return out
        return wrapped

    @staticmethod
    def _annotation(name: str):
        import torch

        return torch.profiler.record_function(name)

    def totals(self, t_open: float, t_close: float) -> Dict[str, tuple]:
        """name -> (seconds, count) of the spans that lie in the window."""
        out: Dict[str, list] = {}
        for name, t0, t1 in self.spans:
            if t_open <= t0 and t1 <= t_close:
                acc = out.setdefault(name, [0.0, 0])
                acc[0] += t1 - t0
                acc[1] += 1
        return {k: (v[0], v[1]) for k, v in out.items()}
