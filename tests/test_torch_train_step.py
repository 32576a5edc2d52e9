"""The port's train step (``train/step.py``: ``models/transformer.py::
forward`` under remat and microbatches, autograd, ``optim/schedule.py``,
``optim/adamw.py``) held against the reference's ``jax.jit``-ed
``make_train_step`` on the same numpy params and ``lm_batch`` data.

Half the architectures are here, the other half in
``test_torch_train_families.py`` (the suite spreads whole files over its
workers). Each reduced config runs in f32 at microbatches 2 and remat
``"full"`` (the reference's ``test_smoke_train_step`` setting), batch 4,
seq 16. Tolerances:

* loss, ce, aux, grad_norm, lr and accuracy within 1e-5 relative (the two
  packages sum in different orders, nothing else differs);
* the gradients of ``forward`` (port autograd against ``jax.grad``) within
  1e-4 of each tensor's scale (its largest magnitude);
* params after the step: every element within ``2·lr + 1e-4·scale``, and
  at least 99.9% of a tensor's within ``1e-4·scale``. AdamW's first step
  moves an element by about ``lr·sign(g)``, so a gradient within rounding
  of 0 can take the other sign in the other package.

internlm2 also runs in its bf16 default, gated at 2e-2 of scale; and in the
port, microbatches 1 with remat ``"none"`` equals remat ``"full"`` bit for
bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import ARCH_IDS
from repro.configs import get_reduced as jget
from repro.data.synthetic import lm_batch as jlm_batch
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.train.step import make_loss_fn as jmake_loss_fn
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.config import TrainConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.train.step import make_grad_fn, make_train_step
from repro_torch.tree import flatten_with_path

HERE = ARCH_IDS[:5]
METRICS = ("loss", "ce", "aux", "grad_norm", "lr", "accuracy")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: intra-op threads only contend under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_flat(tree):
    """{"/"-joined path: numpy} of a JAX tree (the port's path spelling)."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def torch_flat(tree):
    return {"/".join(p): t.detach().float().numpy()
            for p, t in flatten_with_path(tree)}


def reference_step(arch, dtype="float32", microbatches=2, remat="full",
                   seed=0):
    """The reference's step and its full-batch ``forward`` gradients, one
    jit; returns (numpy params, numpy batch, grads, params', step', metrics)
    as numpy."""
    cfg = jget(arch).with_(dtype=dtype)
    tc = JTrainConfig(microbatches=microbatches, remat=remat, total_steps=10)
    params = JT.init_params(cfg, jax.random.key(seed))
    batch = jlm_batch(cfg, 4, 16, seed)
    loss_fn, step = jmake_loss_fn(cfg, remat), jmake_train_step(cfg, tc)

    def both(p, o, b):
        grads = jax.grad(lambda p_: loss_fn(p_, b)[0])(p)
        return step(p, o, b), grads

    (p2, o2, m), grads = jax.jit(both)(
        params, JA.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, params), batch, jax_flat(grads),
            jax_flat(p2), int(o2["step"]), {k: float(m[k]) for k in METRICS})


def port_step(arch, params_np, batch, dtype="float32", microbatches=2,
              remat="full"):
    cfg = get_reduced(arch).with_(dtype=dtype)
    tc = TrainConfig(microbatches=microbatches, remat=remat, total_steps=10)
    params = params_from_numpy(params_np)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, grads = make_grad_fn(cfg, remat)(params, tb)
    grads = torch_flat(grads)
    p2, o2, m = make_train_step(cfg, tc)(params, adamw.init(params), tb)
    return (grads, torch_flat(p2), int(o2["step"]),
            {k: float(m[k]) for k in METRICS})


def assert_step_close(ref, got, tol=1e-4, rel=1e-5, share=0.999):
    """(a)'s gates: metrics, gradients, params after the step (``share``:
    the least share of a tensor's elements within ``tol·scale``)."""
    _, _, g_ref, p_ref, s_ref, m_ref = ref
    g_got, p_got, s_got, m_got = got
    assert s_got == s_ref == 1
    for k in METRICS:
        assert abs(m_got[k] - m_ref[k]) <= rel * max(abs(m_ref[k]), 1e-30), \
            (k, m_got[k], m_ref[k])
    assert g_got.keys() == g_ref.keys()
    for k, want in g_ref.items():
        scale = max(np.abs(want).max(), 1e-30)
        err = np.abs(g_got[k] - want).max()
        assert err <= tol * scale, (k, err / scale)
    lr = m_ref["lr"]
    assert p_got.keys() == p_ref.keys()
    for k, want in p_ref.items():
        scale = max(np.abs(want).max(), 1e-30)
        diff = np.abs(p_got[k] - want)
        assert diff.max() <= 2 * lr + tol * scale, (k, diff.max())
        assert (diff <= tol * scale).mean() >= share, k


@pytest.mark.parametrize("arch", HERE)
def test_train_step_matches_reference_f32(arch):
    ref = reference_step(arch)
    assert_step_close(ref, port_step(arch, ref[0], ref[1]))


def test_train_step_bf16_internlm2():
    """The config's own bf16 compute: both packages round the same operands
    to bf16, so they part by bf16 roundings of differently ordered sums.
    Metrics and gradients at 2e-2; every param within ``2·lr + 2e-2·scale``.
    The share gate is left out: in bf16 a gradient within rounding of 0 is
    no longer rare (about 1% of a norm scale's elements take the other
    sign, and a norm scale that starts at 0 is ``lr`` in size after one
    step)."""
    ref = reference_step("internlm2_1_8b", dtype="bfloat16")
    got = port_step("internlm2_1_8b", ref[0], ref[1], dtype="bfloat16")
    assert_step_close(ref, got, tol=2e-2, rel=2e-2, share=0.0)


def test_remat_none_equals_full_bitwise():
    """Recomputing a super-block in the backward gives the bits it gave in
    the forward: remat changes memory, not results."""
    cfg = jget("internlm2_1_8b").with_(dtype="float32")
    params = jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.key(2)))
    batch = jlm_batch(cfg, 4, 16, 3)
    runs = [port_step("internlm2_1_8b", params, batch, microbatches=1,
                      remat=remat) for remat in ("none", "full")]
    for a, b in zip(runs[0], runs[1]):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), k
        else:
            assert a == b
