"""Host loader with background prefetch. Port of ``repro/data/loader.py``.

A worker thread makes each step's numpy batch (``batch_fn(step)``) and
hands it over, one to ``depth`` steps ahead of the consumer, so making the
data overlaps the device's step. The reference's ``sharding`` (a
``device_put`` to the batch sharding) is ``device`` here, and with
``sharding=(mesh, specs)`` (``rules.batch_pspecs``) each array is placed
on the mesh as a DTensor laid out by its spec, every rank keeping its
slice of the global batch: with a device the worker hands over torch
tensors already there; without one, the numpy batch as ``batch_fn`` made
it. The order and the ``start_step`` semantics are the reference's.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import torch


class PrefetchLoader:
    def __init__(self, batch_fn: Callable[[int], dict], start_step: int = 0,
                 device: Optional[torch.device] = None, depth: int = 2,
                 sharding=None):
        self.batch_fn = batch_fn
        self.step = start_step
        self.device = device
        self.sharding = sharding
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            batch = self.batch_fn(s)
            if self.device is not None:
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in batch.items()}
            if self.sharding is not None:
                from repro_torch.sharding.rules import distribute_tree
                batch = distribute_tree(batch, *self.sharding)
            try:
                self._q.put((s, batch), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            try:
                s, batch = self._q.get(timeout=1.0)
                return s, batch
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
