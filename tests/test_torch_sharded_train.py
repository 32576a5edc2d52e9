"""The sharded training path across processes: four ``gloo`` ranks on the
CPU, one spawn for the whole file (each rank a subprocess on a shared
``FileStore``, with a timeout of its own), held to the reference.

* Steps: the port's ``make_train_step`` (f32, remat ``"full"``, batch 4,
  seq 16) on a 2x2 ("data", "model") mesh, params, AdamW state and batch
  laid out by ``sharding.rules`` as DTensors, against the reference's
  jitted step from the same numpy params (the port's ``init_params``):
  internlm2 at microbatches 2, its gradients ``make_grad_fn``'s over the
  whole batch; the others at 1, where the step's own gradients are the
  whole batch's and are recorded. At the unsharded training tests'
  tolerances (metrics 1e-5 relative, gradients 1e-4 of each tensor's
  scale, params after the step within 2·lr + 1e-4·scale and 99.9% of each
  tensor within 1e-4·scale). internlm2 (heads over ``model``), qwen3
  (experts over ``model``), recurrentgemma (one KV head: ``arch_rules``'
  ``kv_head_dim`` branch, its K/V projections split on head_dim) and a
  reduced granite with 3 query heads, 1 KV head and an odd vocabulary of
  255 (the ``head_dim`` branch for the queries, and the embedding's columns
  over ``("model", "data")``: a ``_StridedShard``); and qwen3 again at a
  capacity factor of 0.5, where experts drop entries and a capacity order
  counted on each rank's shard alone would keep other entries than the
  global order the MoE regions count (the worker counts those entries).
* Regions: every ``local_call`` region (MoE, RG-LRU, SSD) and the
  embedding lookup runs on each rank's half of the batch (``data`` = 2).
* A fresh sharded start (``rules.init_params``): each rank's blocks equal
  the same blocks of ``init_params`` bit for bit; no op touches a tensor
  larger than the largest leaf, and the live tensors never exceed the
  rank's blocks and one whole leaf.
* Elastic rescale: internlm2's state after its step, saved sealed (ColoE)
  from the 2x2 mesh, restored by ``elastic.rescale`` onto (4, 1), (1, 4)
  and (1, 1) meshes bit for bit; the files equal an unsharded save's.
* Memory and aliasing: each step runs under a dispatch mode that records
  every in-place op writing a view DTensor answered with a copy
  (``sharding.api.relax_views``); the sharded save copies to the host on
  rank 0 alone, and the restore onto 2x2 touches no tensor larger than
  the rank's own blocks.
* ``allreduce_compressed`` over the 4 ranks against the reference's under
  ``shard_map`` on 4 forced host devices (a subprocess): the summed codes
  bit for bit, the result within 2^-23 of its scale.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_reduced as jget
from repro.data.synthetic import lm_batch as jlm_batch
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.train.step import make_loss_fn as jmake_loss_fn
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import get_reduced
from repro_torch.models import transformer as T
from repro_torch.tree import flatten_with_path

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240
LR = 3e-4
# name: (arch, config overrides, microbatches)
CASES = {
    "internlm2_1_8b": ("internlm2_1_8b", {}, 2),
    "qwen3_moe_30b_a3b": ("qwen3_moe_30b_a3b", {}, 1),
    "recurrentgemma_9b": ("recurrentgemma_9b", {}, 1),
    "granite_odd": ("granite_3_2b", {"vocab_size": 255, "num_heads": 3,
                                     "num_kv_heads": 1}, 1),
    "qwen3_drops": ("qwen3_moe_30b_a3b", {"capacity_factor": 0.5}, 1),
}
# the batch dim of every region's arguments on a rank: 1/2 of the batch
DATA = 2
RESCALES = ((4, 1), (1, 4), (1, 1))

_WORKER = r'''
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
rank, out = int(sys.argv[1]), sys.argv[2]
from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                     shutdown_distributed)
init_distributed("cpu", world_size=WORLD, rank=rank,
                 init_method="file://" + os.path.join(out, "store"))
import dataclasses
from repro_torch.checkpoint.manager import CheckpointManager, rebuild_tree
from repro_torch.config import SealConfig, TrainConfig
from repro_torch.models import blocks as MB
from repro_torch.models import layers as ML
from repro_torch.configs import get_reduced
from repro_torch.data.synthetic import lm_batch
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, grad_compress
from repro_torch.runtime import elastic
from repro_torch.sharding import rules as R
from repro_torch.sharding.api import use_mesh
from repro_torch.train import step as S
from repro_torch.tree import flatten_with_path

import weakref
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten


def local(t):
    return getattr(t, "_local_tensor", t)


def nbytes(t):
    t = local(t)
    return t.numel() * t.element_size()


class ViewWrites(TorchDispatchMode):
    """Records each in-place op whose written argument is (a view of) the
    result of an ``aten.view``/``aten._unsafe_view`` of a DTensor that
    DTensor answered with a copy (``sharding.api.relax_views``)."""

    def __init__(self):
        super().__init__()
        self.copies = weakref.WeakValueDictionary()
        self.relaxed = 0
        self.bad = []

    def tainted(self, t):
        return self.copies.get(id(t)) is t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        vals = list(args) + [kwargs.get(a.name)
                             for a in schema.arguments[len(args):]]
        for a, v in zip(schema.arguments, vals):
            if (a.alias_info is not None and a.alias_info.is_write
                    and isinstance(v, torch.Tensor) and self.tainted(v)):
                self.bad.append(str(func))
        out = func(*args, **kwargs)
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if src is None or not isinstance(out, torch.Tensor):
            return out
        if func in (aten.view.default, aten._unsafe_view.default) \
                and hasattr(src, "_local_tensor"):
            if local(out).untyped_storage().data_ptr() != \
                    local(src).untyped_storage().data_ptr():
                self.relaxed += 1
                self.copies[id(out)] = out
        elif self.tainted(src) and schema.returns and \
                schema.returns[0].alias_info is not None:
            self.copies[id(out)] = out
        return out


class Bytes(TorchDispatchMode):
    """The largest tensor (a DTensor's local one; ``meta`` ones hold no
    bytes) any op reads or writes, the bytes of the host copies
    (``aten._to_copy`` results) made, and the most bytes of op results
    (not views) alive at once."""

    def __init__(self):
        super().__init__()
        self.most = 0
        self.copied = 0
        self.live = 0
        self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ts = [t for t in tree_flatten((args, kwargs, out))[0]
              if isinstance(t, torch.Tensor) and not local(t).is_meta]
        self.most = max([self.most] + [nbytes(t) for t in ts])
        if func is aten._to_copy.default:
            self.copied += nbytes(out)
        if not func.is_view:
            ins = {id(t) for t in tree_flatten((args, kwargs))[0]}
            for o in tree_flatten(out)[0]:
                if (isinstance(o, torch.Tensor) and id(o) not in ins
                        and not local(o).is_meta):
                    self.live += nbytes(o)
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(o, self._free, nbytes(o))
        return out


def config(arch, over):
    cfg = get_reduced(arch)
    over = dict(over)
    if "capacity_factor" in over:
        over["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=over.pop("capacity_factor"))
    return cfg.with_(dtype="float32", **over)


# each region's batch: (kind, global dim 0, the dim 0 the rank's fn sees)
regions = []


def watch(mod, kind):
    made = mod.local_call

    def watched(fn, *args, batch=0, **kw):
        def inner(*a):
            regions.append((kind, int(args[0].shape[0]), int(a[0].shape[0])))
            return fn(*a)
        return made(inner, *args, batch=batch, **kw)
    mod.local_call = watched


watch(MB, "blocks")
watch(ML, "layers")
_lookup = T._lookup


def lookup(w, tokens):
    x = _lookup(w, tokens)
    regions.append(("lookup", int(tokens.shape[0]),
                    int(x.to_local().shape[0])))
    return x


T._lookup = lookup
# entries whose keep flag an order counted on the rank's shard alone
# (no lower shards' counts) would change
reorders = [0]
_slots = ML.capacity_slots


def slots(gate_idx, e, cap):
    keep, slot = _slots(gate_idx, e, cap)
    made, ML.shard_prefix_sum = ML.shard_prefix_sum, torch.zeros_like
    try:
        alone = _slots(gate_idx, e, cap)[0]
    finally:
        ML.shard_prefix_sum = made
    reorders[0] += int((keep != alone).sum())
    return keep, slot


ML.capacity_slots = slots

# the step's own gradients: at one microbatch they are the full batch's
seen = {}
_made = S.make_grad_fn

def _recording(cfg, remat):
    fn = _made(cfg, remat)
    def grad_fn(params, batch):
        out = fn(params, batch)
        seen["grads"] = out[1]
        return out
    return grad_fn

S.make_grad_fn = _recording

def full(tree):
    return {"/".join(p): (t.full_tensor() if hasattr(t, "full_tensor")
                          else t).detach().numpy()
            for p, t in flatten_with_path(tree)}

mesh = make_host_mesh(2, 2, device_type="cpu")
state = None
report = {}
for name, (arch, over, mb) in CASES.items():
    cfg = config(arch, over)
    # a fresh sharded start against the unsharded draw
    whole = T.init_params(cfg, 0, "cpu")
    with Bytes() as drawing:
        fresh = R.init_params(cfg, 0, mesh, "cpu")
    same = True
    for (_, f), (_, w) in zip(flatten_with_path(fresh),
                              flatten_with_path(whole)):
        got = f.to_local()
        want = w[R.local_block(tuple(w.shape), mesh, f.placements)]
        same &= (got.shape == want.shape and
                 got.numpy().tobytes() == want.numpy().tobytes())
    report["init/" + name] = {
        "bitwise": bool(same), "most": drawing.most,
        "peak": drawing.peak,
        "blocks": sum(nbytes(f) for _, f in flatten_with_path(fresh)),
        "largest": max(nbytes(w) for _, w in flatten_with_path(whole)),
        "whole": sum(nbytes(w) for _, w in flatten_with_path(whole))}
    del whole, fresh
    regions.clear()
    reorders[0] = 0
    tc = TrainConfig(microbatches=mb, remat="full", total_steps=10)
    init = dict(np.load(os.path.join(out, name + "_params.npz")))
    params = R.distribute_tree(rebuild_tree(T.param_spec(cfg), init),
                               mesh, R.param_pspecs(cfg, mesh))
    opt = R.distribute_tree(adamw.init(rebuild_tree(T.param_spec(cfg), init)),
                            mesh, R.opt_pspecs(cfg, mesh))
    batch = R.distribute_tree(
        {k: torch.from_numpy(v) for k, v in lm_batch(cfg, 4, 16, 0).items()},
        mesh, R.batch_pspecs(cfg, mesh, "train"))
    views = ViewWrites()
    with use_mesh(mesh, R.arch_rules(cfg, mesh)), views:
        if mb > 1:
            _, grads = _made(cfg, "full")(params, batch)
        params, opt, metrics = S.make_train_step(cfg, tc)(params, opt, batch)
        if mb == 1:
            grads = seen["grads"]
    report["views/" + name] = {"relaxed": views.relaxed, "bad": views.bad}
    report["regions/" + name] = list(regions)
    report["reorders/" + name] = reorders[0]
    res = {"grads/" + k: v for k, v in full(grads).items()}
    res.update({"params/" + k: v for k, v in full(params).items()})
    res.update({"metrics/" + k: v for k, v in full(metrics).items()})
    if rank == 0:
        np.savez(os.path.join(out, name + "_port.npz"), **res)
    if state is None:
        state = (cfg, params, opt)

# the first case's state: sealed from the 2x2 mesh, and unsharded
cfg, params, opt = state
seal = SealConfig(mode="coloe")
sharded = CheckpointManager(os.path.join(out, "sharded"), seal=seal,
                            device="cpu")
with Bytes() as saving:
    sharded.save(1, params, opt, blocking=True)
report["save"] = {"copied": saving.copied, "state": sum(
    p.numel() * p.element_size() for tree in (params, opt)
    for _, p in flatten_with_path(tree))}
# the restore onto 2x2: no op on a rank touches more than its own blocks
_, host = sharded.restore()
spec = T.param_spec(cfg)
with Bytes() as placing:
    p2 = rebuild_tree(spec, host["params"], (mesh, R.param_pspecs(cfg, mesh)))
    o2 = rebuild_tree(adamw.init(spec), host["opt"],
                      (mesh, R.opt_pspecs(cfg, mesh)))
leaves = [t for tree in (p2, o2) for _, t in flatten_with_path(tree)]
report["restore"] = {"most": placing.most,
                     "block": max(nbytes(t) for t in leaves),
                     "largest": max(t.numel() * t.element_size()
                                    for t in leaves)}
plain = rebuild_tree(T.param_spec(cfg), full(params))
plain_opt = rebuild_tree(adamw.init(T.param_spec(cfg)), full(opt))
CheckpointManager(os.path.join(out, "plain"), seal=seal,
                  device="cpu").save(1, plain, plain_opt, blocking=True)
want = {"params": full(params), "opt": full(opt)}
checks = {}
for data, model in RESCALES:
    ranks = list(range(data * model))
    step, p2, o2, m2 = elastic.rescale(cfg, sharded, ranks=ranks,
                                       model_axis=model)
    got = {"params": p2, "opt": o2}
    ok = tuple(m2.shape) == (data, model) and step == 1
    if rank in ranks:
        for group, tree in got.items():
            for path, t in flatten_with_path(tree):
                g = t.full_tensor().numpy()
                w = want[group]["/".join(path)]
                ok &= (g.dtype == w.dtype and g.shape == w.shape
                       and g.tobytes() == w.tobytes())
    checks[f"{data}x{model}"] = bool(ok)
with open(os.path.join(out, f"rescale_{rank}.json"), "w") as f:
    json.dump(checks, f)
with open(os.path.join(out, f"report_{rank}.json"), "w") as f:
    json.dump(report, f)

g = torch.from_numpy(np.random.default_rng(rank).normal(
    size=(64, 32)).astype(np.float32))
codes, _ = grad_compress.compress(g)
summed = codes.to(torch.int32)
torch.distributed.all_reduce(summed)
res = grad_compress.allreduce_compressed(g)
if rank == 0:
    np.savez(os.path.join(out, "allreduce_port.npz"), codes=summed.numpy(),
             result=res.numpy())
shutdown_distributed()
'''

_REFERENCE_ALLREDUCE = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim import grad_compress
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
mesh = Mesh(np.array(jax.devices()[:4]), ("pod",))
g = np.stack([np.random.default_rng(r).normal(size=(64, 32)).astype(
    np.float32) for r in range(4)])

def body(x):
    codes, _ = grad_compress.compress(x[0])
    summed = jax.lax.psum(codes.astype(jnp.int32), "pod")
    return summed[None], grad_compress.allreduce_compressed(x[0], "pod")[None]

codes, res = jax.jit(shard_map(body, mesh=mesh, in_specs=P("pod"),
                               out_specs=(P("pod"), P("pod"))))(g)
np.savez(sys.argv[1], codes=np.asarray(codes)[0], result=np.asarray(res)[0])
'''


def _jax_flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _with(cfg, over):
    """``cfg`` in f32 with ``over``'s fields; ``capacity_factor`` is the
    MoE config's."""
    over = dict(over)
    if "capacity_factor" in over:
        over["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=over.pop("capacity_factor"))
    return cfg.with_(dtype="float32", **over)


def _cfg(arch, over):
    return _with(jget(arch), over)


def _init(arch, over, mb):
    """Both packages' start: the port's ``init_params`` (the reference's
    tree and scales; seconds faster than the reference's eager draws), as
    numpy."""
    cfg = _with(get_reduced(arch), over)
    return {"/".join(p): t.numpy()
            for p, t in flatten_with_path(T.init_params(cfg, 0, "cpu"))}


def _reference(arch, over, mb, flat):
    """The reference's full-batch gradients and one jitted step (``mb``
    microbatches) from the numpy ``flat`` params on ``lm_batch(cfg, 4,
    16, 0)``, as numpy."""
    cfg = _cfg(arch, over)
    tc = JTrainConfig(microbatches=mb, remat="full", total_steps=10)
    spec = jax.eval_shape(lambda: JT.init_params(cfg, jax.random.key(0)))
    leaves = jax.tree_util.tree_flatten_with_path(spec)[0]
    params = jax.tree_util.tree_unflatten(
        jax.tree.structure(spec),
        [flat["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in kp)] for kp, _ in leaves])
    batch = jlm_batch(cfg, 4, 16, 0)
    loss_fn = jmake_loss_fn(cfg, "full")
    step = jmake_train_step(cfg, tc)

    @jax.jit
    def run(p, b):
        grads = jax.grad(lambda q: loss_fn(q, b)[0])(p)
        p2, _, m = step(p, JA.init(p), b)
        return grads, p2, m
    grads, p2, m = run(params, batch)
    return _jax_flat(grads), _jax_flat(p2), {k: float(v) for k, v in
                                             m.items()}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Start the four ranks (and the reference's all-reduce), compute the
    reference's steps in this process meanwhile, then wait for them all."""
    out = tmp_path_factory.mktemp("sharded")
    inits = {name: _init(*case) for name, case in CASES.items()}
    for name, flat in inits.items():
        np.savez(out / f"{name}_params.npz", **flat)
    script = out / "worker.py"
    script.write_text(_WORKER.replace("WORLD", str(WORLD)).replace(
        "CASES", repr(CASES)).replace("RESCALES", repr(RESCALES)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_ALLREDUCE,
         str(out / "allreduce_ref.npz")], env=jenv, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    try:
        refs = {name: _reference(*case, inits[name])
                for name, case in CASES.items()}
        errs = []
        for p in procs:
            _, err = p.communicate(timeout=max(1.0, TIMEOUT -
                                               (time.time() - t0)))
            errs.append((p.returncode, err))
    finally:
        for p in procs:
            p.kill()
    for rc, err in errs:
        assert rc == 0, err[-4000:]
    return out, refs


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_reference(spawned, name):
    out, refs = spawned
    g_ref, p_ref, m_ref = refs[name]
    port = dict(np.load(out / f"{name}_port.npz"))
    for k, want in m_ref.items():
        got = float(port["metrics/" + k])
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-30), (k, got, want)
    for path, want in g_ref.items():
        got = port["grads/" + path]
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, path
    for path, want in p_ref.items():
        got = port["params/" + path]
        tol = 1e-4 * float(np.abs(want).max())
        diff = np.abs(got - want)
        assert float(diff.max()) <= 2 * LR + tol, path
        assert float((diff <= tol).mean()) >= 0.999, path


def test_rescaled_checkpoints_are_bitwise_and_files_unsharded(spawned):
    out, _ = spawned
    for rank in range(WORLD):
        checks = json.loads((out / f"rescale_{rank}.json").read_text())
        assert checks == {f"{d}x{m}": True for d, m in RESCALES}, rank
    a, b = out / "sharded" / "step_00000001", out / "plain" / "step_00000001"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) > 10
    for n in names:
        if n == "manifest.json":
            ma, mb = (json.loads((d / n).read_text()) for d in (a, b))
            assert ma["leaves"] == mb["leaves"]
            assert ma["meta"]["step"] == mb["meta"]["step"] == 1
        else:
            assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_allreduce_compressed_matches_reference(spawned):
    out, _ = spawned
    port = np.load(out / "allreduce_port.npz")
    ref = np.load(out / "allreduce_ref.npz")
    assert port["codes"].dtype == ref["codes"].dtype == np.int32
    assert np.array_equal(port["codes"], ref["codes"])
    scale = float(np.abs(ref["result"]).max())
    assert float(np.abs(port["result"] - ref["result"]).max()) <= \
        2.0 ** -23 * scale


def _reports(out):
    return [json.loads((out / f"report_{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_writes_no_relaxed_view(spawned, name):
    """No in-place op of the sharded step writes (a view of) a view that
    DTensor answered with a copy; the step does take such views, so the
    check sees them."""
    out, _ = spawned
    for rank, rep in enumerate(_reports(out)):
        views = rep["views/" + name]
        assert views["bad"] == [], (rank, views["bad"])
        assert views["relaxed"] > 0, rank


def test_sharded_restore_copies_only_each_ranks_blocks(spawned):
    """The restore onto the 2x2 mesh: no op on any rank reads or writes a
    tensor larger than that rank's largest block, which is smaller than
    the largest leaf."""
    out, _ = spawned
    for rank, rep in enumerate(_reports(out)):
        r = rep["restore"]
        assert 0 < r["most"] <= r["block"] < r["largest"], (rank, r)


def test_sharded_save_copies_to_host_on_rank_0_only(spawned):
    """The sharded save: rank 0 copies the whole state to the host once,
    the other ranks copy nothing."""
    out, _ = spawned
    for rank, rep in enumerate(_reports(out)):
        s = rep["save"]
        assert s["copied"] == (s["state"] if rank == 0 else 0), (rank, s)


@pytest.mark.parametrize("name", list(CASES))
def test_fresh_sharded_init_is_init_params_blocks(spawned, name):
    """``rules.init_params`` on the 2x2 mesh: each rank's blocks are
    ``init_params``'s, bit for bit; no op reads or writes a tensor larger
    than the largest leaf, and the live tensors stay below the rank's
    blocks and one whole leaf (the whole params, drawn at once and laid
    out after, would exceed them)."""
    out, _ = spawned
    for rank, rep in enumerate(_reports(out)):
        r = rep["init/" + name]
        assert r["bitwise"], (rank, r)
        assert r["most"] <= r["largest"], (rank, r)
        assert r["peak"] <= r["blocks"] + r["largest"] < r["whole"], \
            (rank, r)


@pytest.mark.parametrize("name", list(CASES))
def test_regions_run_on_each_ranks_batch_shard(spawned, name):
    """Every ``local_call`` region of the sharded step and the embedding
    lookup see 1/``data`` of the batch on each rank: the MoE regions in
    the qwen3 cases, the RG-LRU's in recurrentgemma's."""
    out, _ = spawned
    want = {"lookup"} | ({"layers"} if name.startswith("qwen3") else set()) \
        | ({"blocks"} if name.startswith("recurrent") else set())
    for rank, rep in enumerate(_reports(out)):
        seen = rep["regions/" + name]
        assert {kind for kind, _, _ in seen} == want, (rank, seen)
        for kind, whole, local in seen:
            assert local * DATA == whole, (rank, kind, whole, local)


def test_capacity_drops_keep_the_global_order(spawned):
    """At a capacity factor of 0.5 an order counted on each rank's tokens
    alone keeps other entries than the global order the regions count, so
    ``qwen3_drops``' match with the reference's step tests the offsets."""
    out, _ = spawned
    assert sum(rep["reorders/qwen3_drops"] for rep in _reports(out)) > 0
