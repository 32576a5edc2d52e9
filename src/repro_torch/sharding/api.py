"""Logical-axis activation sharding on DTensor. Port of
``repro/sharding/api.py``.

Model code calls ``constrain(x, "batch", None, "heads", None)``; when a
distribution context is active (set by ``use_mesh`` in the training loop
and the dry run), logical names resolve to mesh axes and a DTensor
activation is redistributed to that layout, the counterpart of the
reference's ``with_sharding_constraint``. With no context, or on a plain
tensor, it is the identity, so single-device runs never touch a process
group.

``P`` is the port's ``PartitionSpec``: one entry a tensor dim, each a mesh
axis name, ``None`` (replicated) or a tuple of names (the dim split over
several axes, the first name the major one). ``placements`` turns a spec
into DTensor placements, one a mesh dim. A dim split over two axes in the
order opposite to the mesh's (``("model", "data")`` on a ("data", "model")
mesh) takes a ``_StridedShard`` on the mesh's first axis, so that each
device holds the slice the reference's ``NamedSharding`` gives it.

One difference from the reference: ``constrain`` leaves a dim replicated
when the mesh axes do not divide it, where GSPMD pads. It moves no value.

``relax_views`` lets ``aten.view`` and ``aten._unsafe_view`` (the reshapes
of ``layers.dense`` and inside ``einsum``) redistribute their input where
a sharded dim that is not the first is flattened, or an unflattened dim
does not divide its mesh axes: torch releases differ there (some refuse
the flatten, some rewrite it), and replicating the dim first gives the
same values on every release. The port applies no in-place op to a view
of a DTensor, so the copy a redistribution makes aliases nothing that
matters (``tests/test_torch_sharded_train.py`` holds every sharded step
to that). Both ``relax_views`` and ``dtensor_scope`` reach into private
parts of torch's DTensor; each checks that they are there and raises,
naming the torch release, when they are not.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, NamedTuple, Optional, Tuple

_state = threading.local()

# logical name -> mesh axis (or tuple of axes)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,          # used instead of heads when H % model != 0
    "kv_head_dim": None,
    "ff": "model",
    "expert": "model",
    "moe_ff": "data",
    "moe_tokens": "data",
    "vocab": "model",
    "embed": None,
    "seq": None,
    "seq_res": None,          # residual-stream seq sharding (train opt-in)
    "cache_seq": "model",     # context-parallel decode caches
    "rnn_width": "model",
    "ssm_inner": "model",
}


class P(tuple):
    """PartitionSpec: ``P("data", None, ("model", "data"))``. A one-name
    tuple entry is stored as the name and an empty one as ``None``, as
    JAX's ``PartitionSpec`` stores them."""

    def __new__(cls, *parts):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in parts))

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


class MeshShape(NamedTuple):
    """The two things the spec tables read of a mesh (the reference's
    ``mesh.axis_names`` and ``mesh.devices.shape``), for a mesh that need
    not exist: the tables of a 16x16 mesh on one process."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, sizes) of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return tuple(mesh.axis_names), tuple(mesh.shape)
    return tuple(mesh.mesh_dim_names), tuple(mesh.shape)


def mesh_sizes(mesh) -> Dict[str, int]:
    names, shape = mesh_axes(mesh)
    return dict(zip(names, shape))


_RELAXED = False


def relax_views() -> None:
    """Register the DTensor strategies of ``aten.view`` and
    ``aten._unsafe_view`` as a reshape's (a redistribution where a view
    would need one) once per process; called
    before the first DTensor is laid out (``rules.distribute_tree``,
    ``use_mesh``)."""
    global _RELAXED
    if _RELAXED:
        return
    import inspect

    import torch
    try:
        from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
        from torch.distributed.tensor._ops import _view_ops
        ok = "strict_view" in inspect.signature(
            _view_ops.register_op_strategy_map).parameters
    except (ImportError, AttributeError):
        ok = False
    if not ok:
        raise RuntimeError(
            f"torch {torch.__version__}: DTensor's view strategies "
            f"(torch.distributed.tensor._ops._view_ops."
            f"register_op_strategy_map with strict_view) are not where "
            f"relax_views expects them")
    for op in (torch.ops.aten._unsafe_view.default,
               torch.ops.aten.view.default):
        _view_ops.register_op_strategy_map(
            op, torch.Tensor.view, schema_info=RuntimeSchemaInfo(1),
            strict_view=False)
    _RELAXED = True


def _active():
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict] = None):
    if not isinstance(mesh, MeshShape):
        relax_views()
    rules = dict(DEFAULT_RULES, **(rules or {}))
    # drop axes the mesh does not have (e.g. "pod" on a single-pod mesh)
    names = set(mesh_axes(mesh)[0])

    def resolve(v):
        if v is None:
            return None
        if isinstance(v, (tuple, list)):
            kept = tuple(a for a in v if a in names)
            return kept if kept else None
        return v if v in names else None

    resolved = {k: resolve(v) for k, v in rules.items()}
    prev = _active()
    _state.ctx = (mesh, resolved)
    try:
        yield
    finally:
        _state.ctx = prev


def logical_spec(*logical_axes) -> Optional[P]:
    ctx = _active()
    if ctx is None:
        return None
    _, rules = ctx
    return P(*[rules.get(a) if a is not None else None for a in logical_axes])


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(mesh, spec, ndim: int):
    """DTensor placements (one a mesh dim) of a tensor of ``ndim`` dims laid
    out by ``spec``. A mesh axis the spec does not name is ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    names, shape = mesh_axes(mesh)
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if len(spec) != ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _names(entry)
        order = [names.index(a) for a in axes]
        if order == sorted(order):
            for m in order:
                out[m] = Shard(dim)
        elif len(order) == 2:
            # right-to-left: the minor axis comes first in the mesh; shard
            # on it with the major axis's count as its split factor
            major, minor = order
            out[minor] = _StridedShard(dim, split_factor=shape[major])
            out[major] = Shard(dim)
        else:
            raise NotImplementedError(f"spec entry {entry} on mesh {names}")
    return out


def _divisible(mesh, spec, shape) -> P:
    sizes = mesh_sizes(mesh)
    kept = []
    for entry, n in zip(spec, shape):
        k = 1
        for a in _names(entry):
            k *= sizes[a]
        kept.append(entry if n % k == 0 else None)
    return P(*kept)


def constrain(x, *logical_axes):
    from torch.distributed.tensor import DTensor

    ctx = _active()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh = ctx[0]
    spec = _divisible(mesh, logical_spec(*logical_axes), x.shape)
    target = placements(mesh, spec, x.ndim)
    if list(x.placements) == target:
        return x
    return _relayout(x, target)


def _relayout(x, target):
    """DTensor ``x`` redistributed to the placements ``target``, the
    target's splits of the mesh dims ``x`` replicates first: a local chunk,
    so that a reduction after it (a ``Partial`` dim) moves the kept block
    alone (DTensor would reduce the whole tensor, then chunk it)."""
    from torch.distributed.tensor import Replicate, Shard
    first = [t if isinstance(c, Replicate) and type(t) is Shard else c
             for c, t in zip(x.placements, target)]
    if first != list(x.placements) and first != list(target):
        x = x.redistribute(x.device_mesh, first)
    return x.redistribute(x.device_mesh, target)


def dp_axes(mesh) -> Tuple[str, ...]:
    names = mesh_axes(mesh)[0]
    return tuple(a for a in ("pod", "data") if a in names)


def is_dtensor(x) -> bool:
    if type(x).__name__ != "DTensor":
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def dtensor_scope(x):
    """Inside the returned context, a plain tensor meeting a DTensor is taken
    as replicated on its mesh (positions, RoPE tables, masks, zeros that the
    forward makes itself); the identity context when ``x`` is plain."""
    if not is_dtensor(x):
        return contextlib.nullcontext()
    return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    """torch's ``implicit_replication``, nestable: torch's sets its global
    flag back to False on exit, which would end an enclosing scope (the
    forward's, when a layer's own scope closes). The flag is the process's,
    as torch's own is, not the thread's: while the step's thread holds it,
    the loader's thread lays out whole batches (``distribute_tree``), which
    mixes no plain tensor with a DTensor, so the flag changes nothing
    there."""
    import torch
    from torch.distributed.tensor import DTensor

    disp = getattr(DTensor, "_op_dispatcher", None)
    if not hasattr(disp, "_allow_implicit_replication"):
        raise RuntimeError(
            f"torch {torch.__version__}: DTensor._op_dispatcher."
            f"_allow_implicit_replication, which implicit replication sets, "
            f"is not there")
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def _split_placements(mesh, split, inside):
    """Placements: ``inside`` on the mesh dims in ``split``, ``Replicate``
    on the others."""
    from torch.distributed.tensor import Replicate
    return [inside if i in split else Replicate() for i in range(mesh.ndim)]


@functools.cache
def _whole_fn():
    """The autograd function that hands a region a replicated argument,
    made on first use (this module imports no torch at its top)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    class Whole(torch.autograd.Function):
        """DTensor ``a`` replicated whole, as a plain tensor; in the
        backward the rank's gradient, a sum over the split axes
        (``summed``), goes back onto ``a``'s layout by ``_relayout``."""

        @staticmethod
        def forward(ctx, a, summed):
            ctx.mesh, ctx.pls, ctx.summed = a.device_mesh, a.placements, \
                summed
            return a.redistribute(
                a.device_mesh, [Replicate()] * a.device_mesh.ndim).to_local()

        @staticmethod
        def backward(ctx, g):
            g = DTensor.from_local(g, ctx.mesh, ctx.summed, run_check=False)
            return _relayout(g, ctx.pls), None
    return Whole


def local_call(fn, *args, batch: int = 0, partial_out: bool = False):
    """``fn(*args)`` as a region over each rank's own shard of the batch,
    in the manner of ``shard_map``: the first ``batch`` arguments are split
    on their dim 0 over the mesh's ``pod`` and ``data`` axes (each rank
    holds its block of the batch, in the batch's order), every other
    DTensor argument is replicated whole, and ``fn`` runs on the local
    tensors. Each tensor ``fn`` returns becomes a DTensor split the same way
    on its dim 0, or, with ``partial_out``, the sum over those axes of the
    ranks' tensors (``Partial``: a buffer each rank fills with its own
    entries). Differentiable: a replicated argument's gradient is summed
    over the split axes. A batch whose size those axes do not divide runs
    whole on every rank. The region of a computation that DTensor has no
    sharding rule for (sorts, scans, indexed writes); inside it
    ``shard_prefix_sum`` reads the lower shards. With no DTensor argument,
    ``fn(*args)``."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Shard

    names, sizes = mesh_axes(mesh)
    dp = tuple(names.index(a) for a in dp_axes(mesh))
    n = 1
    for i in dp:
        n *= sizes[i]
    split = dp if batch and args[0].shape[0] % n == 0 else ()
    shard = _split_placements(mesh, split, Shard(0))
    summed = _split_placements(mesh, split, Partial())

    def local(i, a):
        if not is_dtensor(a):
            if i < batch and split and hasattr(a, "shape"):
                raise ValueError("a batch argument of a split region must "
                                 "be a DTensor")
            return a
        if i < batch:
            return a.redistribute(mesh, shard).to_local(grad_placements=shard)
        return _whole_fn().apply(a, summed)

    prev = getattr(_state, "region", None)
    _state.region = (mesh, split)
    try:
        out = fn(*[local(i, a) for i, a in enumerate(args)])
    finally:
        _state.region = prev
    pls = summed if partial_out else shard

    def wrap(y):
        if isinstance(y, tuple):
            return tuple(wrap(v) for v in y)
        if hasattr(y, "shape") and not is_dtensor(y):
            return DTensor.from_local(y, mesh, pls, run_check=False)
        return y
    return wrap(out)


def shard_prefix_sum(x):
    """Inside a ``local_call`` region split over the batch: the sum of
    ``x`` over the shards that come before this rank's in the batch's order
    (an all-gather of ``x`` over the split axes). Zeros outside a region,
    or in one that runs whole."""
    import torch
    region = getattr(_state, "region", None)
    if region is None or not region[1]:
        return torch.zeros_like(x)
    from torch.distributed.tensor import DTensor, Shard

    mesh, split = region
    every = DTensor.from_local(
        x[None], mesh, _split_placements(mesh, split, Shard(0)),
        run_check=False).full_tensor()
    coord, idx = mesh.get_coordinate(), 0
    for i in split:
        idx = idx * mesh.shape[i] + coord[i]
    return every[:idx].sum(dim=0)
