"""Deterministic memory-tamper fault injection against the sealed KV cache.
Port of ``repro/core/security/tamper.py``.

The threat model gives the adversary physical access to the card's memory:
they can flip ciphertext bits, replay stale images, roll back write
counters (forcing pad reuse at the next re-seal) and relocate blocks.
Encryption alone detects none of these; the co-located Carter–Wegman MACs
(``core.mac``) must catch all four. A ``TamperInjector`` is a
``runtime.fault.FaultInjectionHook`` the ``ServeEngine`` calls at the top of
every scheduler step; it changes the engine's device tensors (pools, write
counters) in place, between dispatches, never through the sealed write
path.

Fault classes (``FAULT_KINDS``):

* ``bitflip``  -- flip one ciphertext bit in a resident cache block.
* ``replay``   -- snapshot a tail block (ciphertext and tags: a coherent
  stale image), let the engine write it again, then restore the snapshot.
* ``rollback`` -- decrement the device's write counter of a block, leaving
  the host mirror (the trust boundary) as it is.
* ``relocate`` -- swap two resident blocks together with their tags and
  counters: only the pad's address binding can catch the move.

Every injector fires at a fixed scheduler step (deferred until the victim
slot has resident data), records a ``TamperEvent``, and consults no clock
or RNG. Words are int32 bit patterns of u32: bit 31 and a counter of 0 wrap
as u32 (``repro_torch.u32``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch import u32
from repro_torch.runtime.fault import FaultInjectionHook

FAULT_KINDS = ("bitflip", "replay", "rollback", "relocate")

_IMAGE = ("k", "v", "mac_k", "mac_v")       # what a block's image holds


@dataclasses.dataclass
class TamperEvent:
    """One recorded change of the sealed memory image."""
    kind: str
    step: int                      # scheduler step the change landed on
    slot: int                      # victim serve slot
    block: int                     # pool block changed (src block for swaps)
    layer: int = 0                 # super-block row inside the pool
    word: int = 0                  # word index (bitflip)
    bit: int = 0                   # bit index (bitflip)
    detail: str = ""


class TamperInjector(FaultInjectionHook):
    """Inject ONE fault of ``kind`` into a serve engine's sealed cache.

    The injector waits until ``start_step`` and until the victim slot is
    decoding with resident data (deferring otherwise), then changes the
    pool and state tensors in place. ``events`` records what fired;
    ``fired`` is the one-shot latch. A ``replay`` snapshots at fire time and
    restores the stale image ``replay_delay`` steps later; it defers until
    the victim's tail block will absorb that many appends.
    """

    def __init__(self, kind: str, *, slot: int = 0, start_step: int = 3,
                 layer: int = 0, word: int = 7, bit: int = 3,
                 replay_delay: int = 2):
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        self.kind = kind
        self.slot = slot
        self.start_step = start_step
        self.layer = layer
        self.word = word
        self.bit = bit
        self.replay_delay = replay_delay
        self.fired = False
        self.events: List[TamperEvent] = []
        self._step = 0
        self._snap: Optional[tuple] = None      # (restore_step, block, blobs)

    def _victim(self, engine):
        """(tail block index, length) once the victim slot is decoding with
        at least one resident block; None while deferring."""
        if engine._active[self.slot] is None:
            return None
        if engine._pending[self.slot] is not None:
            return None                      # still prefilling
        length = int(engine._lengths[self.slot])
        if length <= 0:
            return None
        return (length - 1) // engine.block_size, length

    # -------------------------------------------------- hook

    def on_step(self, engine) -> None:
        self._step += 1
        if self._snap is not None:
            self._restore(engine)
            return
        if self.fired or self._step < self.start_step:
            return
        tgt = self._victim(engine)
        if tgt is None:
            return
        bi, length = tgt
        getattr(self, f"_{self.kind}")(engine, bi, length)

    def _record(self, engine, block: int, **kw) -> TamperEvent:
        ev = TamperEvent(self.kind, self._step, self.slot, block, **kw)
        self.events.append(ev)
        self.fired = True
        return ev

    # -------------------------------------------------- fault classes

    def _bitflip(self, engine, bi: int, length: int) -> None:
        block = int(engine._tables[self.slot, bi])
        engine._pools[0]["k"][self.layer, block, self.word] ^= u32.const(
            1 << self.bit)
        self._record(engine, block, layer=self.layer, word=self.word,
                     bit=self.bit,
                     detail=f"ciphertext bit {self.bit} of word {self.word}")

    def _rollback(self, engine, bi: int, length: int) -> None:
        block = int(engine._tables[self.slot, bi])
        if int(engine._wc[block]) == 0:
            return                           # not yet written; defer
        wc = engine._state.wc
        wc[block] = u32.from_i64(u32.to_i64(wc[block]) - 1)
        self._record(engine, block,
                     detail="device write counter decremented; host mirror "
                            "(trust boundary) untouched")

    def _replay(self, engine, bi: int, length: int) -> None:
        # the tail block absorbing the NEXT appends: it must stay the tail
        # for replay_delay more tokens so the snapshot goes stale
        bs = engine.block_size
        if length % bs + self.replay_delay > bs:
            return                           # would cross a block; defer
        r = engine._active[self.slot]
        if engine._mt_eff(r) - len(r.out) <= self.replay_delay + 1:
            return      # the victim would finish before reading the stale
                        # image: the replay would land on a freed block
        block = int(engine._tables[self.slot, length // bs])
        blobs = {key: engine._pools[0][key][:, block].clone()
                 for key in _IMAGE}
        self._snap = (self._step + self.replay_delay, block, blobs)
        self._record(engine, block,
                     detail=f"stale image snapshotted; restore in "
                            f"{self.replay_delay} steps")

    def _restore(self, engine) -> None:
        restore_step, block, blobs = self._snap
        if self._step < restore_step:
            return
        for key in _IMAGE:
            engine._pools[0][key][:, block] = blobs[key]
        self._snap = None
        self.events.append(TamperEvent(
            "replay", self._step, self.slot, block,
            detail="stale (ciphertext, tag) image restored"))

    def _relocate(self, engine, bi: int, length: int) -> None:
        if bi < 1:
            return                           # need two resident blocks
        b0 = int(engine._tables[self.slot, 0])
        b1 = int(engine._tables[self.slot, 1])
        for key in _IMAGE:
            t = engine._pools[0][key]
            t[:, [b0, b1]] = t[:, [b1, b0]]
        # the counters too: a careful adversary keeps every co-located
        # metadata word consistent, so only the pad's address binding can
        # catch the move
        wc = engine._state.wc
        wc[[b0, b1]] = wc[[b1, b0]]
        engine._wc[b0], engine._wc[b1] = engine._wc[b1], engine._wc[b0]
        self._record(engine, b0,
                     detail=f"blocks {b0} <-> {b1} swapped with tags "
                            f"and counters")


def make_injectors(kinds, **kw) -> List[TamperInjector]:
    """One injector per named kind (comma-separated string or iterable)."""
    if isinstance(kinds, str):
        kinds = [k.strip() for k in kinds.split(",") if k.strip()]
    return [TamperInjector(k, **kw) for k in kinds]
