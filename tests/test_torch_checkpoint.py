"""The port's sealed checkpoints (``checkpoint/manager.py``) held against
the reference's on the CPU.

* Under ``none``, ``coloe``, ``counter`` and ``direct``: the port's files
  are the reference's byte for byte (file names, ``.npy`` bytes, SHA-256
  digests and manifests less ``meta.time``), and each package restores the
  other's checkpoint to the saved arrays exactly, through ``rebuild_tree``;
  the port also rebuilds a model's whole tree from ``param_spec`` and
  ``adamw.init`` on the ``meta`` device.
* The reference's own checks (``tests/test_substrate.py:132-170``):
  ciphertext at rest, atomicity, ``keep`` GC, corruption.
* A save followed at once by an in-place AdamW step still restores the
  pre-step params: the snapshot is taken before ``save`` returns.
* The reference's keystream reuse, kept by the port (ROADMAP §3): every
  leaf is sealed under one keystream, so under ColoE and Counter the XOR
  of two leaves' ciphertext data words is the XOR of their plaintexts, in
  both packages, and so is the XOR of one leaf's words at two steps.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.checkpoint.manager import rebuild_tree as jrebuild_tree
from repro.config import SealConfig as JSealConfig
from repro.optim import adamw as JA
from repro_torch.checkpoint.manager import CheckpointManager, rebuild_tree
from repro_torch.config import SealConfig, TrainConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import flatten_with_path, map_leaves

MODES = ("none", "coloe", "counter", "direct")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: intra-op threads only contend under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state():
    """A small params tree with a model's leaf kinds (a 2-D embedding, a
    stacked 4-D attention leaf, a 1-D norm) and an AdamW state one update
    in, as numpy trees. Few leaves: the reference seals each leaf with
    eager jnp ChaCha or AES, about half a second a leaf."""
    rng = np.random.RandomState(0)
    params = {"embed": {"w": rng.randn(32, 8).astype(np.float32)},
              "final_norm": {"scale": rng.randn(8).astype(np.float32)},
              "blocks": ({"attn": {"wq": rng.randn(2, 8, 2, 4).astype(
                  np.float32)}},)}
    jp = jax.tree.map(jnp.asarray, params)
    grads = jax.tree.map(lambda p: jnp.sin(p * 7.0), jp)
    jp, opt, _ = jax.jit(lambda p, o, g: JA.update(
        p, o, g, jnp.float32(1e-3), JA.TrainConfig()))(jp, JA.init(jp), grads)
    return jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, opt)


def _seal(cls, mode):
    return None if mode == "none" else cls(mode=mode)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        m = json.load(f)
    assert isinstance(m["meta"].pop("time"), float)
    return m


def _flat(tree):
    return {"/".join(p): np.asarray(v) for p, v in flatten_with_path(tree)}


@pytest.mark.parametrize("mode", MODES)
def test_files_identical_and_each_restores_the_other(tmp_path, state, mode):
    params, opt = state
    dj, dt = str(tmp_path / "ref"), str(tmp_path / "port")
    JCheckpointManager(dj, seal=_seal(JSealConfig, mode)).save(
        7, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, opt), blocking=True)
    CheckpointManager(dt, seal=_seal(SealConfig, mode), device="cpu").save(
        7, params_from_numpy(params), params_from_numpy(opt), blocking=True)
    files = sorted(os.listdir(os.path.join(dj, "step_00000007")))
    assert files == sorted(os.listdir(os.path.join(dt, "step_00000007")))
    for f in files:
        if f.endswith(".npy"):
            with open(os.path.join(dj, "step_00000007", f), "rb") as a, \
                    open(os.path.join(dt, "step_00000007", f), "rb") as b:
                assert a.read() == b.read(), f
    assert _manifest(dt, 7) == _manifest(dj, 7)

    want = {"params": _flat(params), "opt": _flat(opt)}
    tmpl = params_from_numpy(params)
    for d in (dj, dt):      # the port reads both
        step, host = CheckpointManager(
            d, seal=_seal(SealConfig, mode), device="cpu").restore()
        assert step == 7
        _assert_equal({"params": _flat(rebuild_tree(tmpl, host["params"])),
                       "opt": _flat(rebuild_tree(adamw.init(tmpl),
                                                 host["opt"]))}, want)
    # the reference reads the port's (it reads its own in its own tests)
    step, host = JCheckpointManager(dt).restore()
    assert step == 7
    jtmpl = jax.eval_shape(lambda: jax.tree.map(jnp.asarray, params))
    _assert_equal({"params": _flat(jax.tree.map(
        np.asarray, jrebuild_tree(jtmpl, host["params"]))),
        "opt": {k: np.asarray(v) for k, v in host["opt"].items()}}, want)


def _assert_equal(got, want):
    for group in want:
        assert got[group].keys() == want[group].keys()
        for k, v in want[group].items():
            assert got[group][k].dtype == v.dtype, k
            assert np.array_equal(got[group][k], v), k


def test_rebuild_from_param_spec(tmp_path):
    """A checkpoint of a model's whole tree rebuilt from ``param_spec`` and
    ``adamw.init`` of it (tensors on the ``meta`` device), on a device."""
    cfg = get_reduced("internlm2_1_8b")
    params = T.init_params(cfg, 3, "cpu")
    opt = adamw.init(params)
    mgr = CheckpointManager(str(tmp_path), seal=SealConfig(mode="coloe"),
                            device="cpu")
    mgr.save(2, params, opt, blocking=True)
    _, host = mgr.restore()
    pspec = T.param_spec(cfg)
    got_p = rebuild_tree(pspec, host["params"], torch.device("cpu"))
    got_o = rebuild_tree(adamw.init(pspec), host["opt"], torch.device("cpu"))
    for got, want in ((got_p, params), (got_o, opt)):
        for (pa, a), (pb, b) in zip(flatten_with_path(got),
                                    flatten_with_path(want)):
            assert pa == pb and a.device.type == "cpu"
            assert a.dtype == b.dtype and torch.equal(a, b), pa


def test_sealed_at_rest(tmp_path, state):
    params, _ = state
    mgr = CheckpointManager(str(tmp_path), seal=SealConfig(mode="coloe"),
                            device="cpu")
    mgr.save(7, params_from_numpy(params), blocking=True)
    raw = np.load(tmp_path / "step_00000007" / "params__embed.w.npy")
    assert raw.dtype == np.uint32 and raw.shape[1] == 34
    plain = params["embed"]["w"].reshape(-1).view(np.uint32)
    assert not np.array_equal(raw[:, :32].reshape(-1)[:plain.size], plain)


def test_atomicity_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    p = {"w": torch.arange(4.0)}
    for s in [1, 2, 3]:
        mgr.save(s, p, blocking=True)
    assert mgr.list_steps() == [2, 3]
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert 9 not in mgr.list_steps()
    os.makedirs(tmp_path / "step_00000011")          # no manifest yet
    assert mgr.list_steps() == [2, 3]
    assert mgr.restore()[0] == 3


def test_detects_corruption(tmp_path):
    for mode in ("none", "coloe"):
        d = tmp_path / mode
        mgr = CheckpointManager(str(d), seal=_seal(SealConfig, mode),
                                device="cpu")
        mgr.save(1, {"w": torch.arange(64.0)}, blocking=True)
        f = list((d / "step_00000001").glob("*.npy"))[0]
        data = bytearray(f.read_bytes())
        data[-5] ^= 0x10
        f.write_bytes(bytes(data))
        with pytest.raises(IOError, match="checksum mismatch"):
            mgr.restore()
        assert mgr.restore(verify=False)[0] == 1


def test_snapshot_survives_an_in_place_step(tmp_path):
    """``save`` copies every leaf before it returns, so the AdamW step that
    follows at once (in place) does not reach the checkpoint being written
    in the background."""
    cfg = get_reduced("internlm2_1_8b").with_(dtype="float32")
    params = T.init_params(cfg, 0, "cpu")
    opt = adamw.init(params)
    before = {k: v.copy() for k, v in _flat(params).items()}
    mgr = CheckpointManager(str(tmp_path), seal=SealConfig(mode="coloe"),
                            device="cpu")
    mgr.save(1, params, opt)                       # async
    adamw.update(params, opt, map_leaves(torch.ones_like, params),
                 torch.tensor(1e-2), TrainConfig())
    assert not np.array_equal(_flat(params)["embed/w"], before["embed/w"])
    mgr.wait()
    _, host = mgr.restore()
    for k, v in before.items():
        assert np.array_equal(host["params"][k], v), k
    assert int(host["opt"]["step"]) == 0


def _data_words(payload, scheme):
    """The (L, 32) ciphertext data words of a sealed payload."""
    return payload[:, :32] if scheme == "coloe" else payload


@pytest.mark.parametrize("mode", ["coloe", "counter"])
def test_keystream_reuse_kept_from_the_reference(tmp_path, mode):
    """Two 64x32 f32 leaves: the XOR of their ciphertext data words is the
    XOR of their plaintexts (a two-time pad), in both packages; and one
    leaf saved at two steps likewise."""
    rng = np.random.RandomState(0)
    a, b = (rng.randn(64, 32).astype(np.float32) for _ in range(2))
    ptx = a.view(np.uint32).reshape(-1, 32) ^ b.view(np.uint32).reshape(-1, 32)
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        if pkg == "ref":
            mgr = JCheckpointManager(str(d), seal=JSealConfig(mode=mode))
            mgr.save(1, {"a": jnp.asarray(a), "b": jnp.asarray(b)},
                     blocking=True)
            mgr.save(2, {"a": jnp.asarray(b), "b": jnp.asarray(a)},
                     blocking=True)
        else:
            mgr = CheckpointManager(str(d), seal=SealConfig(mode=mode),
                                    device="cpu")
            mgr.save(1, {"a": torch.from_numpy(a), "b": torch.from_numpy(b)},
                     blocking=True)
            mgr.save(2, {"a": torch.from_numpy(b), "b": torch.from_numpy(a)},
                     blocking=True)

        def ct(step, leaf):
            return _data_words(np.load(
                d / f"step_{step:08d}" / f"params__{leaf}.npy"), mode)
        assert np.array_equal(ct(1, "a") ^ ct(1, "b"), ptx), pkg
        assert np.array_equal(ct(1, "a") ^ ct(2, "a"), ptx), pkg
        assert not np.array_equal(ct(1, "a"), a.view(np.uint32).reshape(
            -1, 32))
