"""The port's sharding layer (``sharding/api.py``, ``sharding/rules.py``,
``launch/mesh.py``, ``runtime/elastic.py::candidate_meshes``) held to the
reference's.

* Tables: ``arch_rules``, ``param_pspecs`` (serving off and on),
  ``opt_pspecs``, ``batch_pspecs`` and ``cache_pspecs`` equal the
  reference's entry for entry, for every ``ARCH_ID`` at its published
  config on 16x16, 2x16x16, 4x2, 2x2 and 1x1. The reference's functions
  read only ``mesh.axis_names`` and ``mesh.devices.shape``, so a stand-in
  with those two attributes needs no devices; the port's take a
  ``MeshShape``.
* Slices: each rank's local shard of every leaf of the reduced configs
  (and of an odd-vocabulary granite, whose embedding splits its columns
  over ``("model", "data")``: a ``_StridedShard``) equals, bit for bit,
  the block ``NamedSharding(...).devices_indices_map`` gives the device at
  the same mesh coordinate of a 4x2 mesh. The reference's maps come from
  one subprocess with 8 forced host devices; the port's shards from the
  ``fake`` process group, one rank after another, in another, both those
  ``distribute_tensor`` keeps and those ``rules.place`` builds from the
  rank's block alone (a restore onto a mesh).
* The launcher's fit check counts a fresh start's whole params.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.sharding import rules as JR
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.runtime.elastic import candidate_meshes
from repro_torch.sharding import api, rules
from repro_torch.sharding.api import MeshShape, P
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (4, 2)), (("data", "model"), (2, 2)),
          (("data", "model"), (1, 1))]


class _JMesh:
    """The two attributes the reference's tables read."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.zeros(shape)


@pytest.fixture
def cached_eval_shape(monkeypatch):
    """The reference's ``param_pspecs`` traces ``init_params`` once a call;
    one trace a config serves every mesh (the result is shapes only)."""
    real, memo = jax.eval_shape, {}

    def fast(fn, *a, **k):
        cells = tuple(c.cell_contents for c in fn.__closure__ or ())
        key = (fn.__code__, cells)
        if key not in memo:
            memo[key] = real(fn, *a, **k)
        return memo[key]
    monkeypatch.setattr(jax, "eval_shape", fast)


def _jflat(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _flat(tree):
    return [tuple(s) for s in rules._spec_leaves(tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tables_equal_the_reference(arch, cached_eval_shape):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for names, shape in MESHES:
        jm, m = _JMesh(names, shape), MeshShape(names, shape)
        where = f"{arch} on {'x'.join(map(str, shape))}"
        assert rules.arch_rules(cfg, m) == JR.arch_rules(jcfg, jm), where
        for serving in (False, True):
            assert _flat(rules.param_pspecs(cfg, m, serving=serving)) == \
                _jflat(JR.param_pspecs(jcfg, jm, serving=serving)), where
        assert _flat(rules.opt_pspecs(cfg, m)) == \
            _jflat(JR.opt_pspecs(jcfg, jm)), where
        for kind in ("train", "decode"):
            assert _flat(rules.batch_pspecs(cfg, m, kind)) == \
                _jflat(JR.batch_pspecs(jcfg, jm, kind)), where
        for batch in (128, 1):
            assert _flat(rules.cache_pspecs(cfg, m, batch, 4096)) == \
                _jflat(JR.cache_pspecs(jcfg, jm, batch, 4096)), where


# --------------------------------------------------------------------------
# slices at 4x2
# --------------------------------------------------------------------------

ODD = {"vocab_size": 255}          # granite reduced, odd vocabulary

_REFERENCE = r"""
import json, sys
import jax, numpy as np
from jax.sharding import NamedSharding
from repro.configs import ARCH_IDS, get_reduced
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as T
from repro.sharding import rules as R
mesh = make_host_mesh(data=4, model=2)
coord = {d.id: i for i, d in enumerate(mesh.devices.reshape(-1))}
out = {}
cases = [(a, {}) for a in ARCH_IDS] + [("granite_3_2b", ODD)]
for arch, over in cases:
    cfg = get_reduced(arch).with_(**over)
    spec = jax.eval_shape(lambda: T.init_params(cfg, jax.random.key(0)))
    ps = R.param_pspecs(cfg, mesh)
    flat = jax.tree_util.tree_flatten_with_path(spec)[0]
    pflat = jax.tree.leaves(ps, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    for (kp, leaf), p in zip(flat, pflat):
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)
        m = NamedSharding(mesh, p).devices_indices_map(leaf.shape)
        blocks = [None] * 8
        for d, idx in m.items():
            blocks[coord[d.id]] = [[s.start or 0, n if s.stop is None
                                    else s.stop] for s, n in
                                   zip(idx, leaf.shape)]
        out[f"{arch}{'_odd' if over else ''}:{path}"] = {
            "shape": list(leaf.shape), "spec": [list(e) if isinstance(
                e, tuple) else e for e in p], "blocks": blocks}
json.dump(out, sys.stdout)
""".replace("ODD", repr(ODD))

_PORT = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding import rules as R
from repro_torch.sharding.api import placements
from repro_torch.tree import flatten_with_path
out = {}
cases = [(a, {}) for a in ARCH_IDS] + [("granite_3_2b", ODD)]
for rank in range(8):
    init_distributed("cpu", fake=True, world_size=8, rank=rank)
    mesh = make_host_mesh(data=4, model=2, device_type="cpu")
    for arch, over in cases:
        cfg = get_reduced(arch).with_(**over)
        spec = T.param_spec(cfg)
        ps = R._spec_leaves(R.param_pspecs(cfg, mesh))
        for (path, leaf), p in zip(flatten_with_path(spec), ps):
            key = f"{arch}{'_odd' if over else ''}:{'/'.join(path)}"
            full = torch.arange(leaf.numel(), dtype=torch.int64).reshape(
                leaf.shape)
            local = distribute_tensor(full, mesh, placements(mesh, p, leaf.ndim),
                                      src_data_rank=None).to_local()
            out.setdefault(key, [None] * 8)[rank] = local.reshape(-1).tolist()
            # the block a restore copies (rules.place, from a host array)
            local = R.place(full.numpy(), mesh, p, torch.int64,
                            "cpu").to_local()
            out.setdefault("place/" + key, [None] * 8)[rank] = \
                local.reshape(-1).tolist()
    dist.destroy_process_group()
json.dump(out, sys.stdout)
""".replace("ODD", repr(ODD))


def _run(code, env_extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               **env_extra)
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_each_rank_holds_the_reference_slice():
    ref = _run(_REFERENCE, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    port = _run(_PORT, {})
    r_out, r_err = ref.communicate(timeout=120)
    p_out, p_err = port.communicate(timeout=120)
    assert ref.returncode == 0, r_err[-3000:]
    assert port.returncode == 0, p_err[-3000:]
    want, got = json.loads(r_out), json.loads(p_out)
    assert sorted(got) == sorted(list(want) + ["place/" + k for k in want])
    strided = 0
    for key, rec in want.items():
        full = np.arange(int(np.prod(rec["shape"]))).reshape(rec["shape"])
        for rank, block in enumerate(rec["blocks"]):
            sl = tuple(slice(a, b) for a, b in block)
            for k in (key, "place/" + key):
                assert got[k][rank] == full[sl].reshape(-1).tolist(), \
                    (k, rank, rec["spec"])
        strided += ["model", "data"] in rec["spec"]
    assert strided == 1      # the odd-vocabulary embedding


# --------------------------------------------------------------------------
# the API's small parts
# --------------------------------------------------------------------------

def test_spec_entries_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    assert P(("data",), None, (), ("pod", "data")) == \
        ("data", None, None, ("pod", "data"))
    m = MeshShape(("data", "model"), (4, 2))
    assert api.placements(m, P("model", "data"), 2) == [Shard(1), Shard(0)]
    assert api.placements(m, P(None, ("data", "model")), 2) == \
        [Shard(1), Shard(1)]
    assert api.placements(m, P(None, ("model", "data")), 3) == \
        [_StridedShard(1, split_factor=2), Shard(1)]
    assert api.placements(m, P(), 2) == [Replicate(), Replicate()]
    pod = MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert api.dp_axes(pod) == ("pod", "data")
    assert api.dp_axes(m) == ("data",)


def test_use_mesh_drops_axes_and_constrain_is_identity_without_one():
    import torch
    x = torch.ones(2, 3)
    assert api.constrain(x, "batch", None) is x
    assert api.logical_spec("batch") is None
    with api.use_mesh(MeshShape(("data", "model"), (2, 2)),
                      {"heads": None}):
        assert api.logical_spec("batch", "heads", "vocab", None) == \
            P("data", None, "model", None)
        assert api.constrain(x, "batch", None) is x    # a plain tensor
    assert api.logical_spec("batch") is None


def test_candidate_meshes_and_mesh_refusals():
    assert candidate_meshes(8) == [(1, 8), (2, 4), (4, 2), (8, 1)]
    assert candidate_meshes(256)[0] == (16, 16)
    assert candidate_meshes(6, prefer_model=2) == [(3, 2), (6, 1)]
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="need a world of 512 ranks"):
        mesh.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="need a world of 256 ranks"):
        mesh.make_production_mesh()


def test_launcher_fit_check_counts_a_fresh_start():
    """``card_bytes``: a step's f32 state divided over the mesh, or a fresh
    start's blocks beside the one whole leaf ``rules.init_params`` draws at
    a time, the larger; deepseek-coder-33b (its largest leaf, the stacked
    MLP ``wi``, 34.1 GB) now fits an 80 GB card on 16x16."""
    from repro_torch.launch import train as LT
    n = 1_889_110_016                     # internlm2-1.8B
    wi = 24 * 2048 * 8192                 # its largest leaf
    cfg = get_config("internlm2_1_8b")
    assert LT.card_bytes(cfg, 1, 1) == n * 16
    assert LT.card_bytes(cfg, 2, 1) == n * 20
    assert LT.card_bytes(cfg, 1, 256) == 4 * (wi + n / 256)
    deepseek = get_config("deepseek_coder_33b")
    tree = sum(p.numel() for p in leaves(
        T.param_spec(deepseek)))          # heads padded to 64
    assert LT.card_bytes(deepseek, 1, 256) == 4 * (
        62 * 7168 * 19200 + tree / 256)
    assert LT.card_bytes(deepseek, 1, 256) < 80e9
