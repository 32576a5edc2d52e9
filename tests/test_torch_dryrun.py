"""The dry run (``launch/dryrun.py``, ``launch/step_stats.py``), the chunked
prefill step (``train/step.py::make_prefill_step``) and the training
launcher at world 1, on the CPU.

* The dry run of reduced configs on a ``fake`` 4x2 mesh and on a 1x1 one
  (each in a subprocess: one process holds one default group): every
  record carries the fields ``launch.roofline`` reads and gives a row;
  collective bytes are 0 at 1x1 and above 0 at 4x2; FLOPs count once: at
  1x1 they equal the same step's on plain ``meta`` tensors under the same
  counter, and at 4x2 the devices together do at least that.
* ``make_prefill_step`` at ``batch_chunks`` 2 against the reference's
  (``lax.map`` over the chunks, the caches merged): logits and every cache
  leaf within 1e-6 of their scale, ``pos`` exactly.
* ``python -m torch.distributed.run --nproc-per-node 1 -m
  repro_torch.launch.train --device cpu`` (beside the dry runs): the world
  from ``torchrun``'s environment, a 1x1 host mesh over gloo, the final
  metrics printed and the checkpoint written.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget
from repro.models import transformer as JT
from repro.train.step import make_prefill_step as jmake_prefill_step
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch.roofline import roofline_row
from repro_torch.train.step import make_prefill_step
from repro_torch.tree import flatten_with_path

ROOT = Path(__file__).resolve().parents[1]
CELLS = (("internlm2_1_8b", "train_4k"), ("qwen3_moe_30b_a3b", "prefill_32k"),
         ("granite_3_2b", "decode_32k"), ("recurrentgemma_9b", "decode_32k"),
         ("mamba2_130m", "long_500k"), ("gemma2_2b", "decode_32k"))

_DRY = r'''
import json, sys
import torch
from repro_torch.config import SHAPES, TrainConfig
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun, step_stats
from repro_torch.launch.inputs import batch_specs, input_specs
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve.step import make_decode_step
from repro_torch.sharding import rules as R
from repro_torch.sharding.api import MeshShape, use_mesh
from repro_torch.train.step import make_prefill_step, make_train_step
data, model = (int(x) for x in sys.argv[1].split("x"))
init_distributed("cpu", fake=True, world_size=data * model)
mesh = make_host_mesh(data, model, device_type="cpu")
out = {}
for arch, shape in CELLS:
    rec = dryrun.run_cell(arch, shape, False, microbatches=1, reduced=True,
                          mesh=mesh)
    if data * model == 1:       # the same step on plain meta tensors
        cfg, sh = get_reduced(arch), SHAPES[shape]
        params, batch = T.param_spec(cfg), batch_specs(cfg, sh, sh.kind)
        rules = R.arch_rules(cfg, mesh)
        if sh.kind == "train":
            rules["seq_res"] = "model"
        # the same logical rules (they pick the attention's query chunks)
        with use_mesh(MeshShape(("data", "model"), (1, 1)), rules), \
                step_stats.StepStats() as st:
            if sh.kind == "train":
                make_train_step(cfg, TrainConfig(microbatches=1, remat="full"))(
                    params, adamw.init(params), batch)
            elif sh.kind == "prefill":
                make_prefill_step(cfg, sh.seq_len)(params, batch)
            else:
                make_decode_step(cfg)(params, input_specs(cfg, sh)["cache"],
                                      batch, sh.seq_len - 1)
        rec["plain_flops"] = st.totals()["flops"]
    out[f"{arch}:{shape}"] = rec
json.dump(out, sys.stdout)
'''.replace("CELLS", repr(CELLS))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two dry runs and the launcher under ``torchrun``, side by side;
    each subprocess's (returncode, stdout, stderr)."""
    ck = tmp_path_factory.mktemp("launcher") / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmds = {m: [sys.executable, "-c", _DRY, m] for m in ("4x2", "1x1")}
    cmds["launcher"] = [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", "1", "-m", "repro_torch.launch.train", "--arch",
        "internlm2_1_8b", "--device", "cpu", "--steps", "2", "--batch", "4",
        "--seq", "16", "--seal", "none", "--checkpoint-dir", str(ck),
        "--checkpoint-every", "2"]
    procs = {k: subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    out = {"checkpoint_dir": ck}
    try:
        for k, p in procs.items():
            o, e = p.communicate(timeout=150)
            out[k] = (p.returncode, o, e)
    finally:
        for p in procs.values():
            p.kill()
    return out


@pytest.fixture(scope="module")
def records(runs):
    out = {}
    for m in ("4x2", "1x1"):
        rc, o, e = runs[m]
        assert rc == 0, e[-4000:]
        out[m] = json.loads(o)
    return out


@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s in CELLS])
def test_dryrun_records(records, cell):
    big, one = records["4x2"][cell], records["1x1"][cell]
    for rec, devices, mesh in ((big, 8, "4x2"), (one, 1, "1x1")):
        assert rec["status"] == "ok", rec
        assert rec["devices"] == devices and rec["mesh"] == mesh
        assert rec["config"] == "reduced"
        assert rec["plan"] == "dtensor-eager"
        assert rec["memory"]["argument_bytes"] > 0
        assert rec["memory"]["temp_bytes"] > 0
        assert rec["bytes_per_device"] > 0
        row = roofline_row(rec)
        assert row is not None and row["model_flops"] > 0
    assert one["collective_bytes_per_device"] == {}
    assert sum(big["collective_bytes_per_device"].values()) > 0
    assert set(big["collective_bytes_per_device"]) <= {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}
    # the bytes by source add up to each kind's, and name the port's code
    src = big["collective_sources_per_device"]
    for kind, total in big["collective_bytes_per_device"].items():
        assert sum(v for k, v in src.items()
                   if k.split(" ")[0] == kind) == total, kind
    assert all(".py:" in k for k in src), src
    # each product counted once, at the device's share
    assert one["flops_per_device"] == one["plain_flops"] > 0
    assert big["flops_per_device"] * 8 >= one["flops_per_device"]
    assert big["flops_per_device"] < one["flops_per_device"]


# --------------------------------------------------------------------------
# make_prefill_step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2_1_8b", "recurrentgemma_9b"])
def test_prefill_step_batch_chunks(arch):
    cfg_j = jget(arch).with_(dtype="float32")
    cfg = get_reduced(arch).with_(dtype="float32")
    params = jax.tree.map(np.asarray, JT.init_params(cfg_j,
                                                     jax.random.key(0)))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 24)).astype(np.int32)
    j_logits, j_cache = jmake_prefill_step(cfg_j, 32, batch_chunks=2)(
        params, {"tokens": tokens})
    logits, cache = make_prefill_step(cfg, 32, batch_chunks=2)(
        params_from_numpy(params), {"tokens": torch.from_numpy(tokens)})
    want = np.asarray(j_logits)
    assert float(np.abs(logits.numpy() - want).max()) <= \
        1e-6 * float(np.abs(want).max())
    j_flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in kp): np.asarray(v)
              for kp, v in jax.tree_util.tree_flatten_with_path(j_cache)[0]}
    flat = {"/".join(p): t for p, t in flatten_with_path(cache)}
    assert sorted(flat) == sorted(j_flat)
    for path, want in j_flat.items():
        got = flat[path].float().numpy() if flat[path].is_floating_point() \
            else flat[path].numpy()
        assert got.shape == want.shape, path
        if path.endswith("pos"):
            assert np.array_equal(got, want), path
        else:
            want = want.astype(np.float32)
            assert float(np.abs(got - want).max()) <= \
                1e-6 * max(float(np.abs(want).max()), 1e-30), path


def test_launcher_world_from_torchrun(runs):
    rc, out, err = runs["launcher"]
    assert rc == 0, err[-4000:]
    final = eval(out.strip().splitlines()[-1])
    assert list(final) == ["accuracy", "aux", "ce", "grad_norm", "loss", "lr"]
    assert np.isfinite(final["loss"])
    assert sorted(os.listdir(runs["checkpoint_dir"])) == ["step_00000002"]
