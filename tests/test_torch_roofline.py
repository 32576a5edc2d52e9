"""The roofline slice held against the JAX package on the CPU: the config
additions (``layer_kinds``, ``param_count``, ``ShapeConfig``/``SHAPES``,
``cell_supported``, ``MeshConfig``, ``RunConfig``), the card's ``HW``,
the step input specs (``launch/inputs.py``, ``models/cache.py``'s
``model_cache_spec`` and ``paged_pool_spec``) and ``launch/roofline.py``.

Every comparison is exact: counts, shapes, dtypes (the port's int32 words
for the reference's uint32), floats computed by the same formula in the
same order. ``roofline_row`` is compared with the reference module's
``HW``/``ICI_LINKS`` patched to the card's constants, so both divide by
the same rates.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

from repro import config as JC
from repro import configs as JCS
from repro.launch import inputs as JI
from repro.launch import roofline as JR
from repro.models import cache as JMC
from repro_torch import config as TC
from repro_torch import configs as TCS
from repro_torch.launch import inputs as TI
from repro_torch.launch import roofline as TR
from repro_torch.models import cache as TMC

ARCHS = TCS.ARCH_IDS
SHAPES = list(TC.SHAPES)
BLOCK = 16


def _dtype_name(dt) -> str:
    """A spec's dtype by the reference's name; the port keeps u32 words as
    int32 bit patterns."""
    name = str(dt).replace("torch.", "")
    return "uint32" if name == "int32" else name


def _same_specs(tree_t, tree_j, words=False):
    """Two spec trees of one structure: each port leaf a ``meta`` tensor of
    the reference leaf's shape and dtype."""
    if isinstance(tree_j, dict):
        assert set(tree_t) == set(tree_j)
        for k in tree_j:
            _same_specs(tree_t[k], tree_j[k], words)
        return
    if isinstance(tree_j, (tuple, list)):
        assert len(tree_t) == len(tree_j)
        for a, b in zip(tree_t, tree_j):
            _same_specs(a, b, words)
        return
    assert tree_t.device.type == "meta"
    assert tuple(tree_t.shape) == tuple(tree_j.shape)
    got = _dtype_name(tree_t.dtype) if words else \
        str(tree_t.dtype).replace("torch.", "")
    assert got == str(jnp.dtype(tree_j.dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_counts_match_reference(arch):
    cj, ct = JCS.get_config(arch), TCS.get_config(arch)
    assert ct.layer_kinds() == cj.layer_kinds()
    for active in (False, True):
        assert ct.param_count(active_only=active) == \
            cj.param_count(active_only=active)
    rj, rt = JCS.get_reduced(arch), TCS.get_reduced(arch)
    assert rt.layer_kinds() == rj.layer_kinds()
    assert rt.param_count() == rj.param_count()
    for name in SHAPES:
        assert TC.cell_supported(ct, TC.SHAPES[name]) == \
            JC.cell_supported(cj, JC.SHAPES[name])
        assert TR.model_flops(ct, TC.SHAPES[name]) == \
            JR.model_flops(cj, JC.SHAPES[name])


def test_shape_mesh_run_configs_match_reference():
    assert list(TC.SHAPES) == list(JC.SHAPES)
    for name in SHAPES:
        assert dataclasses.asdict(TC.SHAPES[name]) == \
            dataclasses.asdict(JC.SHAPES[name])
    for kw in ({}, dict(pod=2), dict(data=4, model=2)):
        mt, mj = TC.MeshConfig(**kw), JC.MeshConfig(**kw)
        assert dataclasses.asdict(mt) == dataclasses.asdict(mj)
        assert (mt.n_devices, mt.axis_names(), mt.shape()) == \
            (mj.n_devices, mj.axis_names(), mj.shape())
    run = TC.RunConfig(TCS.get_config("granite_3_2b"), TC.SHAPES["decode_32k"])
    assert [f.name for f in dataclasses.fields(run)] == \
        [f.name for f in dataclasses.fields(JC.RunConfig)]
    assert run.mesh == TC.MeshConfig() and run.seal == TC.SealConfig()
    assert run.train == TC.TrainConfig()


def test_hw_is_the_card():
    """The H100's data-sheet constants, none of the TPU's."""
    assert TC.HW["peak_flops_bf16"] == 989e12
    assert TC.HW["hbm_bw"] == 3.35e12
    assert TC.HW["hbm_bytes"] == 80 * 10**9
    assert TC.HW["nvlink_bw"] == 900e9
    assert "ici_bw" not in TC.HW and "vmem_bytes" not in TC.HW
    assert TC.HW["smem_bytes"] == 228 * 2**10


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_reference(arch):
    cj, ct = JCS.get_config(arch), TCS.get_config(arch)
    for name in SHAPES:
        sj, st = JC.SHAPES[name], TC.SHAPES[name]
        _same_specs(TI.input_specs(ct, st), JI.input_specs(cj, sj))
        for kind in ("train", "prefill", "decode"):
            _same_specs(TI.batch_specs(ct, st, kind),
                        JI.batch_specs(cj, sj, kind))
        _same_specs(TMC.model_cache_spec(ct, 2, sj.seq_len),
                    JMC.model_cache_spec(cj, 2, sj.seq_len))
        blocks = 1 + sj.global_batch * -(-sj.seq_len // BLOCK)
        if all(k in ("attn", "local_attn") for k in cj.pattern):
            _same_specs(TMC.paged_pool_spec(ct, blocks, BLOCK),
                        JMC.paged_pool_spec(cj, blocks, BLOCK), words=True)
        else:      # the paged pools cover attention layers only
            with pytest.raises(AssertionError):
                JMC.paged_pool_spec(cj, blocks, BLOCK)
            with pytest.raises(ValueError):
                TMC.paged_pool_spec(ct, blocks, BLOCK)


@pytest.mark.parametrize("arch", ["granite_3_2b", "recurrentgemma_9b",
                                  "mamba2_130m"])
def test_cache_init_matches_reference(arch):
    cj, ct = JCS.get_reduced(arch), TCS.get_reduced(arch)
    w = cj.window or 8
    for kind in dict.fromkeys(cj.pattern):
        if kind in ("attn", "local_attn"):
            got = TMC.attn_cache_init(ct, 2, w + 3, kind, "cpu")
            want = JMC.attn_cache_init(cj, 2, w + 3, kind)
        elif kind == "rglru":
            got, want = TMC.rglru_cache_init(ct, 2), JMC.rglru_cache_init(cj, 2)
        else:
            got, want = TMC.ssd_cache_init(ct, 2), JMC.ssd_cache_init(cj, 2)
        assert set(got) == set(want)
        for k in want:
            assert str(got[k].dtype).replace("torch.", "") == \
                str(want[k].dtype)
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k], np.float32))


def _records():
    """Dry-run records in the reference's format, one a cell, with made-up
    per-device counts that put each of the three terms on top somewhere."""
    rng = np.random.RandomState(5)
    recs = []
    for i, arch in enumerate(ARCHS):
        for name in SHAPES:
            rec = {"arch": arch, "shape": name, "mesh": "16x16",
                   "status": "ok", "devices": 256,
                   "flops_per_device": float(rng.uniform(1e12, 1e16)),
                   "bytes_per_device": float(rng.uniform(1e9, 1e13)),
                   "collective_bytes_per_device": {
                       "all-reduce": float(rng.uniform(0, 1e12)),
                       "all-gather": float(rng.uniform(0, 1e11))},
                   "memory": {"temp_bytes": int(rng.randint(1, 2**34)),
                              "argument_bytes": int(rng.randint(1, 2**34))}}
            if (i + len(name)) % 3 == 0:   # the older record's byte key
                rec["bytes_accessed_scaled"] = rec.pop("bytes_per_device")
            recs.append(rec)
    recs.append({"arch": "granite_3_2b", "shape": "decode_32k",
                 "mesh": "16x16", "status": "skipped"})
    recs.append({"arch": "granite_3_2b", "shape": "long_500k",
                 "mesh": "2x16x16", "status": "ok", "devices": 512,
                 "flops_per_device": 1e12, "bytes_per_device": 1e9,
                 "collective_bytes_per_device": {}, "memory": None})
    return recs


@pytest.fixture
def card_reference(monkeypatch):
    """The reference's roofline dividing by the card's rates."""
    monkeypatch.setattr(JR, "HW", dict(TC.HW, ici_bw=TC.HW["nvlink_bw"]))
    monkeypatch.setattr(JR, "ICI_LINKS", TR.NVLINK_LINKS)
    return JR


def test_roofline_rows_match_reference(card_reference, tmp_path):
    recs = _records()
    for rec in recs:
        assert TR.roofline_row(rec) == card_reference.roofline_row(rec)
    for i, rec in enumerate(recs):
        (tmp_path / f"{i:03d}.json").write_text(json.dumps(rec))
    for mesh in ("16x16", "2x16x16"):
        rows = TR.build_table(str(tmp_path), mesh)
        assert rows == card_reference.build_table(str(tmp_path), mesh)
    rows = [r for r in rows if r["memory_gib"] is not None] + \
        TR.build_table(str(tmp_path), "16x16")
    assert TR.render_markdown(rows) == card_reference.render_markdown(rows)


def test_roofline_of_a_cut_one_card_record():
    """A record of the port's sealed decode: one device, the batch cut,
    the reduced config, no collective bytes."""
    cfg = TCS.get_reduced("granite_3_2b")
    shape = dataclasses.replace(TC.SHAPES["decode_32k"], global_batch=2)
    flops = TR.model_flops(cfg, shape)
    rec = {"arch": "granite_3_2b", "shape": "decode_32k", "mesh": "1",
           "status": "ok", "devices": 1, "config": "reduced", "batch": 2,
           "flops_per_device": flops, "bytes_per_device": 3.35e9,
           "collective_bytes_per_device": 0,
           "memory": {"argument_bytes": 2**30, "temp_bytes": 2**29}}
    row = TR.roofline_row(rec)
    assert row["model_flops"] == flops and row["useful_ratio"] == 1.0
    assert row["t_memory_s"] == pytest.approx(1e-3)
    assert row["t_collective_s"] == 0.0 and row["bottleneck"] == "memory"
    assert row["memory_gib"] == 1.5
    assert row["roofline_fraction"] == pytest.approx(
        flops / TC.HW["peak_flops_bf16"] / 1e-3)
    full = TR.roofline_row(dict(rec, config="published", batch=128))
    assert full["model_flops"] == TR.model_flops(
        TCS.get_config("granite_3_2b"), TC.SHAPES["decode_32k"])


def test_roofline_cli(tmp_path, capsys):
    for i, rec in enumerate(_records()[:4]):
        (tmp_path / f"{i}.json").write_text(json.dumps(rec))
    TR.main(["--dir", str(tmp_path), "--json"])
    rows = json.loads(capsys.readouterr().out)
    assert len(rows) == 4
    TR.main(["--dir", str(tmp_path)])
    assert capsys.readouterr().out.startswith("| arch | shape |")
