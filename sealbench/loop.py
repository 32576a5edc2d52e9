"""The closed loop of N clients over the serving engine.

The loop of ``repro_torch/launch/serve.py::drive``, rewritten for clients:
each client submits its next request as soon as its previous one completes,
and the engine steps in between. After every ``step()`` (which ends in the
tick's one device-to-host copy) the host clock stamps each token that has
newly arrived in a request's ``out``: the stamps are when a client would
see its tokens.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Record:
    """One request as its client saw it."""
    client: int
    req: object                   # the engine's Request
    prompt: np.ndarray
    budget: int
    t_submit: float
    stamps: List[float] = dataclasses.field(default_factory=list)
    t_done: Optional[float] = None

    @property
    def error(self) -> Optional[str]:
        return getattr(self.req, "error", None)


class ClosedLoop:
    def __init__(self, eng, traffic, clients: int,
                 clock: Callable[[], float] = time.perf_counter):
        self.eng = eng
        self.traffic = traffic
        self.clients = clients
        self.clock = clock
        self.records: List[Record] = []
        self.inflight: Dict[int, Record] = {}     # by the engine's rid
        self.steps = 0

    def _submit(self, client: int, residual: float = 1.0) -> Record:
        prompt, budget = self.traffic.next_request(residual)
        t = self.clock()
        req = self.eng.submit(prompt, max_tokens=budget)
        rec = Record(client, req, prompt, budget, t)
        self.records.append(rec)
        self.inflight[req.rid] = rec
        return rec

    def open(self) -> None:
        """Every client submits its first request, with the residual life
        of its length as its budget."""
        for c, share in enumerate(self.traffic.residuals(self.clients)):
            self._submit(c, share)

    def step(self) -> None:
        done = self.eng.step()
        now = self.clock()
        self.steps += 1
        for rec in self.inflight.values():
            n = len(rec.req.out)
            if n > len(rec.stamps):
                rec.stamps.extend([now] * (n - len(rec.stamps)))
        for req in done:
            rec = self.inflight.pop(req.rid)
            rec.t_done = now
            self._submit(rec.client)

    def ramped(self) -> bool:
        """Every client's first request has its first token (or is done)."""
        firsts = self.records[:self.clients]
        return all(r.stamps or r.t_done is not None for r in firsts)


def drain(eng, prompts, max_tokens: int) -> None:
    """Submit ``prompts`` and step the engine until they are all done (the
    warm-up's rounds)."""
    reqs = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
    while not all(r.done for r in reqs):
        eng.step()
