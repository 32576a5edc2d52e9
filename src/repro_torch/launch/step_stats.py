"""One step's work per device, counted as the step runs. The counterpart of
``repro/launch/hlo_stats.py``, which parses the compiled HLO text: an
eager step has no HLO, so ``StepStats`` is a ``TorchDispatchMode`` that
sees each ATen op the step dispatches.

  * FLOPs: the products (``torch.utils.flop_counter``'s formulas) of the
    LOCAL ops only. An op on DTensors is handed back to DTensor's own
    dispatch (the mode returns ``NotImplemented`` for it), which runs the
    op on the local shards and issues the collectives it needs; those come
    back through the mode and count, each product once at the device's
    share (``FlopCounterMode`` counts the global-shape op instead).
  * bytes: each local op's tensor inputs read once and its outputs written
    once. This is the UNFUSED count, what an eager step moves; a fused
    kernel (or the reference's XLA fusions) moves less. Views and in-place
    results alias their inputs and count as inputs only.
  * collective bytes by the reference's kinds (``COLLECTIVE_KINDS``): the
    result bytes of each c10d functional op that DTensor's redistributions
    issue (the reference counts the result shape of each HLO collective);
    and the same bytes by source (``collective_sources``: the kind and the
    innermost frame of the port's code that issued it, ``file:line
    function``; a backward's collectives land on the autograd call).
  * ``peak_bytes``: the most bytes of op results alive at once, tracked by
    weak references (the arguments that existed before the step are not
    in it); on ``meta`` tensors too, so a dry run's step gets it.
"""
from __future__ import annotations

import os
import sys
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# the collectives DTensor's redistributions issue, by the reference's kinds
_KIND = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COMM_NAMESPACES = ("_c10d_functional", "_dtensor")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _source() -> str:
    """``file:line function`` of the innermost frame of the port's code
    (outside this module) on the stack."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename
        if "repro_torch" in path and not path.endswith("step_stats.py"):
            where = "/".join(path.split(os.sep)[-2:])
            return f"{where}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return "-"


class StepStats(TorchDispatchMode):
    """``with StepStats() as st: step(...)`` then ``st.totals()``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = defaultdict(float)
        self.sources = defaultdict(float)
        self.live = 0
        self.peak = 0

    def _track(self, t) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            # DTensor's own dispatch runs the op, and its local ops and
            # collectives come back through this mode, where they count
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat_in, _ = tree_flatten((args, kwargs))
        name = func._overloadpacket.__name__
        flat_out, _ = tree_flatten(out)
        t_in = [a for a in flat_in if isinstance(a, torch.Tensor)]
        t_out = [o for o in flat_out if isinstance(o, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in t_in + t_out):
            # DTensor's sharding propagation runs the op at its global
            # shape on fake tensors to learn the output's shape
            return out
        if func.namespace in _COMM_NAMESPACES:
            if name in _KIND:
                n = sum(_nbytes(o) for o in t_out)
                self.collectives[_KIND[name]] += n
                self.sources[f"{_KIND[name]} {_source()}"] += n
            return out
        packet = func._overloadpacket
        if packet in self._flops_of:
            self.flops += self._flops_of[packet](*args, **kwargs,
                                                 out_val=out)
        if not func.is_view:
            ids = {id(a) for a in t_in}
            fresh = [o for o in t_out if id(o) not in ids]
            self.bytes += sum(_nbytes(a) for a in t_in) + \
                sum(_nbytes(o) for o in fresh)
            for o in fresh:
                self._track(o)
        return out

    def totals(self) -> dict:
        coll = {k: v for k, v in self.collectives.items() if v}
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collectives": coll,
                "collective_sources": dict(sorted(
                    self.sources.items(), key=lambda kv: -kv[1])),
                "collective_bytes": float(sum(coll.values())),
                "peak_bytes": int(self.peak)}
