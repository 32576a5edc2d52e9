"""Minimal structured metrics logger (JSONL + console). Port of
``repro/runtime/metrics.py``: the same records and the same stderr line."""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, quiet: bool = False):
        self.path = path
        self.quiet = quiet
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, step: int, **kv):
        rec = {"step": step, "time": time.time(), **{
            k: (float(v) if hasattr(v, "item") else v) for k, v in kv.items()}}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if not self.quiet:
            msg = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in rec.items() if k != "time")
            print(msg, file=sys.stderr)

    def close(self):
        if self._f:
            self._f.close()
