"""The port's three examples (``examples/torch_*.py``) run in-process on
the CPU (``--device cpu``) at the reference examples' own sizes
(``--tiny`` for the training example), their claim lines checked:

* ``torch_quickstart.py``: all eight steps; ``equal=True`` (decrypt-on-use
  loss against plaintext), identical streams under prefix sharing, the
  fused kernel's step-5 product within 1e-4 of its scale of the plain
  product (on the CPU the wrapper takes the plain version, so no launch),
  a tamper detected and recovered, ``quickstart OK`` last;
* ``torch_sealed_serving.py``: the four modes' generations identical;
* ``torch_train_lm.py --tiny``: the reference's example stops on this jax
  (its microbatch ``lax.scan``), so the port's run is held to the
  reference's jitted training step instead, as
  ``tests/test_torch_train_loop.py`` holds the loop: each of its 20 losses
  against the reference's step applied to the same params (the port's
  ``init_params``, which a fresh sharded start reproduces bit for bit) and
  ``lm_batch`` data, at 2e-2 relative (the config computes in bf16; the
  gate of ``tests/test_torch_train_step.py``'s bf16 step).
"""
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.data.synthetic import lm_batch as jlm_batch
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.models import transformer as T
from repro_torch.tree import flatten_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    """An example's module, from ``examples/`` (not a package)."""
    path = os.path.join(ROOT, "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: intra-op threads only contend under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_claims(capsys):
    assert _load("torch_quickstart").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert lines[-1] == "quickstart OK"
    for step in range(1, 9):
        assert f"== {step}. " in out, step
    assert "equal=True" in out
    assert "identical prompts, identical streams: True" in out
    step5 = json.loads(next(x for x in lines if x.startswith("step5 "))[6:])
    assert step5["max_abs_err"] <= 1e-4 * step5["scale"], step5
    assert step5["sealed_matmul_launches"] == 0       # the plain version
    assert "mac_failures=1 retries=1" in out
    assert "done=True error=None" in out


def test_sealed_serving_claims(capsys):
    assert _load("torch_sealed_serving").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for mode in ("none", "direct", "counter", "coloe"):
        assert f"{mode:8s}: 6 reqs in" in out, mode
    assert "all modes produce identical generations: True" in out


def _reference_losses(cfg, steps, batch, seq):
    """The reference's jitted step applied ``steps`` times from the port's
    ``init_params(cfg, 0)`` to ``lm_batch(cfg, batch, seq, s, seed=0)``."""
    jcfg = _load("train_lm").lm_100m().with_(
        num_layers=2, d_model=128, d_ff=512, num_heads=4, num_kv_heads=2,
        vocab_size=1024)
    assert jcfg.name == cfg.name and jcfg.d_model == cfg.d_model
    flat = {"/".join(p): t.numpy()
            for p, t in flatten_with_path(T.init_params(cfg, 0, "cpu"))}
    spec = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.key(0)))
    params = jax.tree_util.tree_unflatten(
        jax.tree.structure(spec),
        [jnp.asarray(flat["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                   for k in kp)])
         for kp, _ in jax.tree_util.tree_flatten_with_path(spec)[0]])
    tc = JTrainConfig(learning_rate=3e-4, warmup_steps=max(10, steps // 10),
                      total_steps=steps, microbatches=2)
    step = jax.jit(jmake_train_step(jcfg, tc))
    opt, out = JA.init(params), []
    for s in range(steps):
        b = {k: jnp.asarray(v)
             for k, v in jlm_batch(jcfg, batch, seq, s, seed=0).items()}
        params, opt, m = step(params, opt, b)
        out.append(float(m["loss"]))
    return out


def test_train_lm_tiny_matches_the_reference_step(tmp_path, capsys):
    ex = _load("torch_train_lm")
    ckpt = str(tmp_path / "ckpt")
    assert ex.main(["--tiny", "--device", "cpu", "--ckpt", ckpt]) == 0
    out = capsys.readouterr().out
    assert "trained lm-100m (0.7M params) for 20 steps: final loss=" in out
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        got = [json.loads(x)["loss"] for x in f if '"loss"' in x]
    assert len(got) == 20
    args = ex.argparse.Namespace(tiny=True, steps=300, seq=128, ckpt=ckpt)
    cfg, tc = ex.configure(args)
    assert (tc.microbatches, tc.total_steps, args.seq) == (2, 20, 64)
    want = _reference_losses(cfg, 20, 8, 64)
    for s, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= 2e-2 * abs(w), (s, g, w)
