"""The paper's sealed-decode comparison (``launch/sealed_dryrun.py``) and
``core/sealed_store.py::sealed_byte_report``, held against the JAX package
on the CPU at the reduced granite-3-2b in f32.

* ``synthetic_masks`` and ``_leaf_lines`` equal the reference's for every
  architecture's reduced tree and the published granite. The reference
  module forces 512 host devices through ``XLA_FLAGS`` when it is
  imported, so it is imported only in a subprocess.
* Each variant's record counts the bytes the reference's formulas
  (``sealed_dryrun.py:119-176``, with its ``tile_geometry`` and
  ``COLOE_LINE_WORDS``) give: stored, materialized, KV cache, fused
  leaves; its FLOPs are the reference's ``model_flops`` of the cut cell.
* Every variant's first-step logits are bitwise equal to the baseline's
  and to the port's plaintext ``decode_step`` on the same cache (the same
  plaintext words meet the same products), and within 1e-5 of scale of
  the reference's ``decode_step``, with the same greedy tokens; the cache
  is left as it was found but for the slot the step writes.
* ``sealed_byte_report`` equals the reference's under ColoE, Counter and
  Direct, with and without MACs, exactly, both over the port's image.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as JC
from repro.configs import get_reduced as jget_reduced
from repro.core import coloe as JCL
from repro.core import plan as JPL
from repro.core import sealed_store as JSS
from repro.launch import inputs as JI
from repro.launch import roofline as JR
from repro.models import transformer as JT
from repro_torch.config import SealConfig
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import sealed_store as SS
from repro_torch.launch import sealed_dryrun as SD
from repro_torch.models import transformer as T
from repro_torch.tree import flatten_with_path

ROOT = Path(__file__).resolve().parents[1]
KEY = bytes(range(32))
ARCH = "granite_3_2b"
SHAPE = "decode_32k"
BATCH = 2
RATIO = 0.5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Plain PyTorch on one thread while this module runs: under
    pytest-xdist each worker's intra-op threads contend with every other
    worker's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_helpers():
    """{arch/config: {"masks", "lines"}} from the reference's module, run
    in a subprocess."""
    code = f"""
import json
import jax
from repro.config import SealConfig
from repro.configs import get_config, get_reduced
from repro.launch import sealed_dryrun as SD
from repro.models import transformer as T
out = {{}}
cfgs = [(a + "/reduced", get_reduced(a)) for a in {ARCH_IDS!r}]
cfgs.append(("{ARCH}/published", get_config("{ARCH}")))
for name, cfg in cfgs:
    ps = T.param_spec(cfg)
    out[name] = {{
        "masks": {{r: SD.synthetic_masks(ps, SealConfig(smart_ratio=r))
                  for r in (0.5, 0.3, 1.0)}},
        "lines": [SD._leaf_lines(x) for x in jax.tree.leaves(ps)]}}
print(json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_masks_and_lines_match_reference():
    want = _reference_helpers()
    cfgs = [(a + "/reduced", get_reduced(a)) for a in ARCH_IDS]
    cfgs.append((f"{ARCH}/published", get_config(ARCH)))
    for name, cfg in cfgs:
        ps = T.param_spec(cfg)
        for r, masks in want[name]["masks"].items():
            assert SD.synthetic_masks(ps, SealConfig(smart_ratio=float(r))) \
                == masks, (name, r)
        assert [SD._leaf_lines(x) for _, x in flatten_with_path(ps)] == \
            want[name]["lines"], name


def _expected_bytes(variant):
    """The reference's byte accounting (``sealed_dryrun.py:119-176``),
    written out over its param spec."""
    cfg = jget_reduced(ARCH).with_(dtype="float32")
    seal = JC.SealConfig(mode="coloe", smart_ratio=RATIO)
    stored = plain = fused = 0
    for kp, leaf in jax.tree_util.tree_flatten_with_path(
            JT.param_spec(cfg))[0]:
        pt = JPL._path_tuple(kp)
        cls = JPL._classify(pt, leaf.ndim)
        r = None if cls is None or pt[0] in ("embed", "head") else RATIO
        words = -(-leaf.size * leaf.dtype.itemsize // 4)
        lines = -(-words // JCL.WORDS_PER_LINE)
        geom = (JSS.tile_geometry(pt, leaf.shape, leaf.dtype, seal)
                if variant == "coloe_fused" else None)
        if geom is not None:
            nb, _, _, k, _, _, _ = geom
            stored += leaf.size * 4 + int(np.prod(leaf.shape[:nb] + (k,)))
            fused += 1
            continue
        if variant == "baseline":
            enc = 0
        elif variant in ("counter", "coloe", "coloe_fused"):
            enc = lines
        else:
            enc = lines if r is None else -(-int(lines * r) // 1)
        wp = (JCL.COLOE_LINE_WORDS if variant in ("coloe", "coloe_se",
                                                   "coloe_fused")
              else JCL.WORDS_PER_LINE)
        stored += (enc * wp + (lines - enc) * JCL.WORDS_PER_LINE
                   + (enc * 2 if variant == "counter" else 0)) * 4
        plain += 0 if variant == "baseline" else \
            leaf.size * jnp.dtype(leaf.dtype).itemsize
    shape = JC.ShapeConfig(SHAPE, "decode", JC.SHAPES[SHAPE].seq_len, BATCH)
    kv = sum(int(np.prod(s.shape)) * jnp.dtype(s.dtype).itemsize
             for s in jax.tree.leaves(JI.input_specs(cfg, shape)["cache"]))
    return {"stored_param_bytes_global": stored,
            "plaintext_bytes_materialized_per_step": plain,
            "kv_cache_plaintext_bytes_per_step": kv,
            "fused_matmul_leaves": fused,
            "flops_per_device": JR.model_flops(cfg, shape)}


def _clone(cache):
    return tuple({k: t.clone() for k, t in c.items()} for c in cache)


def test_variants_count_the_reference_bytes_and_agree():
    state = SD.decode_state(ARCH, SHAPE, reduced=True, batch=BATCH,
                            dtype="float32", device="cpu", seed=3)
    cache0 = _clone(state.cache)
    recs = {v: SD.sealed_decode_variant(ARCH, SHAPE, v, RATIO, True,
                                        state=state, warmup=1, iters=2)
            for v in SD.VARIANTS}
    for v, rec in recs.items():
        want = _expected_bytes(v)
        assert {k: rec[k] for k in want} == want, v
        assert rec["bytes_per_device"] == (
            want["stored_param_bytes_global"]
            + 2 * want["plaintext_bytes_materialized_per_step"]
            + want["kv_cache_plaintext_bytes_per_step"])
        assert rec["plaintext_bytes_written"] == \
            want["plaintext_bytes_materialized_per_step"]
        assert rec["collective_bytes_per_device"] == 0
        assert rec["reduced"] == ["config: reduced",
                                  f"global_batch 128 -> {BATCH}"]
        assert rec["launches_per_step"] == {}     # plain versions count none
        assert len(rec["step_ms_each"]) == 2 and rec["peak_gib"] is None
    assert recs["coloe_fused"]["fused_matmul_slices"] == 7 * 2
    assert [recs[v]["unsealed_line_leaves"] for v in SD.VARIANTS] == \
        [0, 11, 11, 11, 4]
    # every variant computes the baseline's logits, the port's plaintext
    # step's, and the reference's within 1e-5 of scale
    base = state.logits["baseline"]
    for v in SD.VARIANTS:
        assert torch.equal(state.logits[v], base), v
    want, _, tok = T.decode_step(state.cfg, state.params, _clone(cache0),
                                 state.batch["tokens"], state.pos)
    assert torch.equal(want, base)
    cfg_j = jget_reduced(ARCH).with_(dtype="float32")
    lj, _, tj = JT.decode_step(
        cfg_j, jax.tree.map(lambda t: jnp.asarray(t.numpy()), state.params),
        tuple({k: jnp.asarray(t.numpy()) for k, t in c.items()}
              for c in cache0),
        {"tokens": jnp.asarray(state.batch["tokens"].numpy(), jnp.int32)},
        jnp.int32(state.pos))
    lj = np.asarray(lj)
    np.testing.assert_allclose(base.numpy(), lj, rtol=0,
                               atol=1e-5 * np.abs(lj).max())
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tj))
    # the steps leave the cache as they found it, but the written slot
    for c, c0 in zip(state.cache, cache0):
        assert torch.equal(c["pos"], c0["pos"])
        keep = torch.arange(c["k"].shape[2]) != state.pos
        assert torch.equal(c["k"][:, :, keep], c0["k"][:, :, keep])


def test_refusals_and_cli(tmp_path, capsys):
    with pytest.raises(ValueError, match="unknown variant"):
        SD.sealed_decode_variant(ARCH, SHAPE, "direct", reduced=True,
                                 batch=1, device="cpu")
    with pytest.raises(ValueError, match="decode shape"):
        SD.decode_state(ARCH, "train_4k", reduced=True, device="cpu")
    out = tmp_path / "rec.json"
    assert SD.main(["--reduced", "--device", "cpu", "--batch", "1",
                    "--variant", "coloe_se", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [r["variant"] for r in recs] == ["coloe_se"]
    assert recs[0]["dtype"] == "bfloat16" and recs[0]["status"] == "ok"
    assert json.loads(capsys.readouterr().out) == recs[0]


def _reference_image(sp, pj, seal):
    """The port's sealed image as the reference's ``SealedParams``: each
    leaf's arrays as numpy, its metadata field for field, and the
    reference's own SE plans over the same weights."""
    from repro.core import sealed_tensor as JST
    from repro_torch import u32

    def np_(t):
        if t is None:
            return None
        return u32.to_numpy(t) if t.dtype == torch.int32 else t.numpy()

    tensors = {p: JST.SealedTensor(
        np_(st.payload), np_(st.counters), np_(st.row_mask),
        np_(st.key_words), np_(st.wc), JST.SealMeta(**vars(st.meta)),
        macs=np_(st.macs)) for p, st in sp.tensors.items()}
    return JSS.SealedParams(tensors, JPL.make_plan(pj, seal),
                            jax.tree_util.tree_structure(pj), seal)


@pytest.mark.parametrize("mode", ["coloe", "counter", "direct"])
@pytest.mark.parametrize("verify", [False, True])
def test_sealed_byte_report_matches_reference(mode, verify):
    """The port's report and the reference's over the same image (the
    images' words against the reference's are held in
    ``test_torch_store*.py`` and ``test_torch_direct.py``)."""
    # any weights will do: numpy draws in the reference's tree (its
    # param_spec traces the init, compiling nothing)
    rng = np.random.RandomState(1)
    pj = jax.tree.map(
        lambda t: rng.standard_normal(t.shape).astype(np.float32),
        JT.param_spec(jget_reduced(ARCH).with_(dtype="float32")))
    pt = params_from_numpy(pj)
    sp = SS.seal_params(pt, SealConfig(mode=mode, smart_ratio=RATIO,
                                       verify=verify), KEY)
    got = SS.sealed_byte_report(sp)
    want = JSS.sealed_byte_report(_reference_image(
        sp, pj, JC.SealConfig(mode=mode, smart_ratio=RATIO, verify=verify)))
    assert got == want
    assert got["fused_leaves"] == (0 if mode == "direct" else 7)
