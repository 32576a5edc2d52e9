"""Fault-tolerance machinery. Port of ``repro/runtime/fault.py`` (pure
Python, framework-agnostic; the port keeps its own copy).

* ``Heartbeat``     -- per-host liveness file and stale-peer detection.
* ``StepWatchdog``  -- straggler mitigation: a wall-clock deadline per step
  from a running P99; a blown deadline raises ``StragglerTimeout``.
* ``retry``         -- bounded-retry decorator with exponential backoff for
  transient errors.
* ``PreemptionGuard`` -- SIGTERM handler: flips a flag a loop polls to
  checkpoint and exit inside the grace period.
* ``FaultInjectionHook`` -- interface of deterministic fault injectors the
  serve engine calls once per scheduler step (``core.security.tamper``
  implements the memory-tampering faults).
"""
from __future__ import annotations

import functools
import json
import os
import random
import signal
import threading
import time
from typing import Callable, Dict, Optional


class StragglerTimeout(RuntimeError):
    """A step, or a serve drain, ran past its deadline or step budget."""


class HostFailure(RuntimeError):
    pass


class Heartbeat:
    def __init__(self, directory: str, host_id: str, interval: float = 5.0,
                 timeout: float = 30.0):
        self.dir = directory
        self.host_id = host_id
        self.interval = interval
        self.timeout = timeout
        os.makedirs(directory, exist_ok=True)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _path(self, host: str) -> str:
        return os.path.join(self.dir, f"hb_{host}.json")

    def beat(self, step: int = -1):
        tmp = self._path(self.host_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": self.host_id, "time": time.time(),
                       "step": step}, f)
        os.replace(tmp, self._path(self.host_id))

    def start(self):
        def loop():
            while not self._stop.is_set():
                self.beat()
                self._stop.wait(self.interval)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def _scan(self):
        """Yield (host, record, age) for every parseable heartbeat file.
        A record without a ``time`` field (torn write from a pre-atomic
        writer) counts as infinitely stale rather than crashing the scan;
        the host name falls back to the filename."""
        now = time.time()
        for f in os.listdir(self.dir):
            if not f.startswith("hb_") or f.endswith(".tmp"):
                continue
            try:
                with open(os.path.join(self.dir, f)) as fh:
                    rec = json.load(fh)
            except (json.JSONDecodeError, OSError):
                continue
            host = rec.get("host") or f[3:-5]
            age = (now - rec["time"]) if "time" in rec else float("inf")
            yield host, rec, age

    def alive_hosts(self) -> Dict[str, dict]:
        return {h: rec for h, rec, age in self._scan()
                if age <= self.timeout}

    def dead_hosts(self) -> Dict[str, dict]:
        return {h: rec for h, rec, age in self._scan()
                if age > self.timeout}


class StepWatchdog:
    """Raise StragglerTimeout when a step exceeds margin x running-P99."""

    def __init__(self, margin: float = 3.0, warmup_steps: int = 5,
                 hard_limit_s: float = 0.0):
        self.margin = margin
        self.warmup = warmup_steps
        self.hard = hard_limit_s
        self._durations = []

    def deadline(self) -> float:
        if len(self._durations) < self.warmup:
            return self.hard or float("inf")
        d = sorted(self._durations)
        p99 = d[min(len(d) - 1, int(0.99 * len(d)))]
        dl = self.margin * p99
        return min(dl, self.hard) if self.hard else dl

    def observe(self, duration: float):
        self._durations.append(duration)
        if len(self._durations) > 512:
            self._durations = self._durations[-256:]

    def check(self, duration: float):
        dl = self.deadline()
        self.observe(duration)
        if duration > dl:
            raise StragglerTimeout(
                f"step took {duration:.2f}s > deadline {dl:.2f}s")


def retry(n: int = 3, backoff: float = 0.5,
          exceptions=(IOError, OSError), jitter: float = 0.0) -> Callable:
    """Bounded-retry decorator: up to ``n`` attempts with exponential
    backoff (optionally jittered by up to ``jitter`` fraction of the delay,
    de-synchronizing retry storms across hosts). ``n <= 0`` is rejected at
    decoration time rather than returning None without ever calling the
    function."""
    if n <= 0:
        raise ValueError(f"retry needs at least one attempt, got n={n}")
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            delay = backoff
            for i in range(n):
                try:
                    return fn(*a, **kw)
                except exceptions:
                    if i == n - 1:
                        raise
                    time.sleep(delay * (1.0 + jitter * random.random()))
                    delay *= 2
        return wrapped
    return deco


class FaultInjectionHook:
    """Interface for deterministic fault injectors: the serve engine calls
    ``on_step(engine)`` at the top of every scheduler step, before any
    dispatch. The hook may mutate pools, device state or counters to model
    an adversary with physical access to the card's memory
    (``core.security.tamper.TamperInjector``)."""

    def on_step(self, engine) -> None:      # pragma: no cover - interface
        raise NotImplementedError


class PreemptionGuard:
    """SIGTERM -> requested flag; the loop checkpoints and exits cleanly."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = None
        self._installed = False
        if install:
            try:
                self._prev = signal.signal(signal.SIGTERM, self._handler)
                self._installed = True
            except ValueError:          # not in main thread (tests)
                pass

    def close(self):
        """Put back the SIGTERM handler this guard replaced (the reference's
        guard stays installed for the life of the process, so a SIGTERM
        after its loop ended would only set a flag nobody reads)."""
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
            self._installed = False

    def _handler(self, signum, frame):
        self.requested = True

    def trigger(self):                  # for tests
        self.requested = True
