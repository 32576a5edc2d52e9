"""The port's training loop (``train/loop.py::train``) and launcher
(``launch/train.py``) on the CPU, reduced internlm2.

The reference's loop has no run to compare with (its ``train`` fails on a
1x1 host mesh, ROADMAP §3), so it is held piece by piece: its losses
against the reference's jitted step applied to the same params and
``lm_batch`` data (1e-5 relative, f32); a straight run against a run that
stops, checkpoints and resumes (bit for bit on the CPU, sealed under
ColoE); and the preemption and straggler exits, which each leave a
complete checkpoint.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_reduced as jget
from repro.data.synthetic import lm_batch as jlm_batch
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import SealConfig, TrainConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import train as LT
from repro_torch.runtime.fault import (PreemptionGuard, StepWatchdog,
                                       StragglerTimeout)
from repro_torch.train import loop as TL
from repro_torch.tree import flatten_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "internlm2_1_8b"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: intra-op threads only contend under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tc(d, **kw):
    base = dict(learning_rate=1e-3, total_steps=6, warmup_steps=1,
                microbatches=2, checkpoint_every=3, checkpoint_dir=str(d))
    base.update(kw)
    return TrainConfig(**base)


def _losses(log):
    with open(log) as f:
        recs = [json.loads(x) for x in f]
    return {r["step"]: r["loss"] for r in recs if "loss" in r}, \
        [r.get("event") for r in recs if "event" in r]


def _equal_trees(a, b):
    fa, fb = flatten_with_path(a), flatten_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def test_resume_equals_the_straight_run_bitwise(tmp_path):
    """6 steps straight against 3 steps, a ColoE checkpoint, and a fresh
    ``train`` that resumes at step 3 and runs to 6: params, AdamW state and
    the losses of steps 3-5 equal bit for bit."""
    cfg, seal = get_reduced(ARCH), SealConfig(mode="coloe")
    a = TL.train(cfg, _tc(tmp_path / "a", checkpoint_every=10), "cpu",
                 batch=4, seq=16, seal=seal, log_path=str(tmp_path / "a.log"))
    TL.train(cfg, _tc(tmp_path / "b"), "cpu", batch=4, seq=16, steps=3,
             seal=seal, log_path=str(tmp_path / "b.log"))
    assert CheckpointManager(str(tmp_path / "b"),
                             device="cpu").list_steps() == [3]
    b = TL.train(cfg, _tc(tmp_path / "b"), "cpu", batch=4, seq=16, seal=seal,
                 log_path=str(tmp_path / "b.log"))
    _equal_trees(a[0], b[0])
    _equal_trees(a[1], b[1])
    assert int(b[1]["step"]) == 6
    la, _ = _losses(tmp_path / "a.log")
    lb, events = _losses(tmp_path / "b.log")
    assert events == ["resumed"]
    assert sorted(la) == sorted(lb) == list(range(6))
    assert all(la[s] == lb[s] for s in range(6))
    assert list(a[2]) == sorted(a[2])
    assert all(np.array_equal(a[2][k], b[2][k]) for k in a[2])


def test_losses_match_the_reference_step(tmp_path):
    """The reference's params written as the step-0 checkpoint, so the
    port's ``train`` starts from them: its six losses against the
    reference's jitted step applied six times to the same batches."""
    jcfg = jget(ARCH).with_(dtype="float32")
    jtc = JTrainConfig(learning_rate=1e-3, total_steps=6, warmup_steps=1,
                       microbatches=2)
    params = JT.init_params(jcfg, jax.random.key(4))
    opt = JA.init(params)
    CheckpointManager(str(tmp_path / "ck"), device="cpu").save(
        0, params_from_numpy(jax.tree.map(np.asarray, params)),
        params_from_numpy(jax.tree.map(np.asarray, opt)), blocking=True)
    step = jax.jit(jmake_train_step(jcfg, jtc))
    want = []
    for s in range(6):
        batch = {k: jnp.asarray(v)
                 for k, v in jlm_batch(jcfg, 4, 16, s, seed=0).items()}
        params, opt, m = step(params, opt, batch)
        want.append(float(m["loss"]))
    TL.train(get_reduced(ARCH).with_(dtype="float32"),
             _tc(tmp_path / "ck", checkpoint_every=100), "cpu", batch=4,
             seq=16, log_path=str(tmp_path / "l.log"))
    got, events = _losses(tmp_path / "l.log")
    assert events == ["resumed"]
    for s in range(6):
        assert abs(got[s] - want[s]) <= 1e-5 * abs(want[s]), (s, got[s],
                                                               want[s])


def test_preemption_leaves_a_complete_checkpoint(tmp_path, monkeypatch):
    guard = PreemptionGuard(install=False)
    guard.trigger()
    monkeypatch.setattr(TL, "PreemptionGuard", lambda: guard)
    p, o, _ = TL.train(get_reduced(ARCH), _tc(tmp_path / "ck"), "cpu",
                       batch=4, seq=16, seal=SealConfig(mode="counter"),
                       log_path=str(tmp_path / "p.log"))
    mgr = CheckpointManager(str(tmp_path / "ck"), device="cpu")
    assert mgr.list_steps() == [1]
    step, host = mgr.restore()
    assert step == 1 and int(host["opt"]["step"]) == 1
    assert np.array_equal(host["params"]["embed/w"], p["embed"]["w"].numpy())
    _, events = _losses(tmp_path / "p.log")
    assert events == ["preempted_clean_exit"]


def test_straggler_timeout_leaves_a_complete_checkpoint(tmp_path):
    with pytest.raises(StragglerTimeout):
        TL.train(get_reduced(ARCH), _tc(tmp_path / "ck"), "cpu", batch=4,
                 seq=16, seal=SealConfig(mode="direct"),
                 watchdog=StepWatchdog(hard_limit_s=1e-9))
    mgr = CheckpointManager(str(tmp_path / "ck"), device="cpu")
    assert mgr.list_steps() == [1]
    step, host = mgr.restore()
    assert step == 1 and int(host["opt"]["step"]) == 1


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train ... --device cpu``: a sealed
    checkpoint after 3 steps, then a second run resumes from it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--device", "cpu", "--batch", "4", "--seq", "16", "--seal",
           "coloe", "--checkpoint-dir", str(tmp_path / "ck"),
           "--checkpoint-every", "3"]
    out = subprocess.run(cmd + ["--steps", "3"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "event=resumed" not in out.stderr
    # the second run in this process (its own import of torch is saved)
    assert LT.main(cmd[3:] + ["--steps", "5"]) == 0
    second = capsys.readouterr()
    assert "step=3 event=resumed" in second.err
    assert "step=4 loss=" in second.err
    for text in (out.stdout, second.out):
        final = eval(text.strip().splitlines()[-1])     # the printed dict
        assert list(final) == ["accuracy", "aux", "ce", "grad_norm", "loss",
                               "lr"]
        assert np.isfinite(final["loss"])
    assert CheckpointManager(str(tmp_path / "ck"),
                             device="cpu").list_steps() == [3]


def test_launcher_refusals():
    """``--multi-pod`` on a world of the wrong size is refused with a
    message naming the size it needs."""
    for argv in (["--arch", ARCH, "--multi-pod", "--device", "cpu"],):
        with pytest.raises(SystemExit, match="needs a world of 512 ranks"):
            LT.main(argv)
    # internlm2-1.8B's 1,889,110,016 params: 20 bytes each with an
    # accumulator; Qwen3-30B-A3B's would not fit one card
    assert LT.training_bytes(get_config(ARCH), 2) == 1_889_110_016 * 20
    assert LT.training_bytes(get_config(ARCH), 1) == 1_889_110_016 * 16
    assert LT.training_bytes(get_config("qwen3_moe_30b_a3b"), 1) > 80e9
