"""The port's analytic performance model (``core/perfmodel.py``) held
against the JAX package's: every output equal (``==``, no tolerance: the
same float64 arithmetic in the same order) for the three CNNs x six
schemes x four counter-cache sizes, the GEMM workload and the VGG-16 conv
and pool picks; then each paper claim of ``tests/test_perfmodel.py``
re-asserted against the port's model, one parametrised case a claim.

The model's outputs are the paper's modelled GTX480, not any card's.
"""
import dataclasses

import pytest

from repro.config import PAPER_GPU as J_PAPER_GPU
from repro.configs import get_config as jget_config
from repro.core import perfmodel as JPM
from repro_torch.config import PAPER_GPU
from repro_torch.configs import get_config
from repro_torch.core import perfmodel as PM

CNN_IDS = ("vgg16", "resnet18", "resnet34")
CTR_KB = (24, 96, 384, 1536)


def test_calibration_constants_equal():
    names = ("C_EFF", "BW_GDDR_EFF", "BW_AES_TOTAL", "AI_CONV", "AI_GEMM",
             "PHI", "LAM", "CTR_HIT", "LINE", "SCHEMES")
    assert {n: getattr(PM, n) for n in names} == \
        {n: getattr(JPM, n) for n in names}
    assert PAPER_GPU == J_PAPER_GPU


def _work(layers):
    return [dataclasses.asdict(w) for w in layers]


@pytest.mark.parametrize("ratio,protect,img", [(0.5, True, 224),
                                               (0.2, True, 224),
                                               (0.8, False, 32)])
@pytest.mark.parametrize("cid", CNN_IDS)
def test_cnn_workload_equal(cid, ratio, protect, img):
    got = PM.cnn_workload(get_config(cid), ratio, protect, img)
    want = JPM.cnn_workload(jget_config(cid), ratio, protect, img)
    assert _work(got) == _work(want)
    assert [w.bytes_eff() for w in got] == [w.bytes_eff() for w in want]
    assert [w.enc_frac() for w in got] == [w.enc_frac() for w in want]


def _outputs(pm, layers, scheme, kb):
    return (pm.evaluate_network(layers, scheme, ctr_cache_kb=kb),
            pm.relative_ipc(layers, scheme, ctr_cache_kb=kb),
            pm.relative_latency(layers, scheme, ctr_cache_kb=kb),
            [dataclasses.asdict(pm.evaluate_layer(w, scheme, ctr_cache_kb=kb))
             for w in layers])


@pytest.mark.parametrize("kb", CTR_KB)
@pytest.mark.parametrize("scheme", PM.SCHEMES)
@pytest.mark.parametrize("cid", CNN_IDS)
def test_network_outputs_equal(cid, scheme, kb):
    got = _outputs(PM, PM.cnn_workload(get_config(cid), 0.5), scheme, kb)
    want = _outputs(JPM, JPM.cnn_workload(jget_config(cid), 0.5), scheme,
                    kb)
    assert got == want


@pytest.mark.parametrize("n", [2048, 512])
def test_gemm_workload_outputs_equal(n):
    got, want = PM.gemm_workload(n), JPM.gemm_workload(n)
    assert _work(got) == _work(want)
    for scheme in PM.SCHEMES:
        for kb in CTR_KB:
            assert _outputs(PM, got, scheme, kb) == \
                _outputs(JPM, want, scheme, kb)


@pytest.mark.parametrize("ratio", [0.5, 0.2, 1.0])
def test_vgg_picks_equal(ratio):
    got, want = PM.vgg_conv_layers(ratio), JPM.vgg_conv_layers(ratio)
    assert sorted(got) == sorted(want) == [64, 128, 256, 512]
    assert {c: dataclasses.asdict(w) for c, w in got.items()} == \
        {c: dataclasses.asdict(w) for c, w in want.items()}
    assert _work(PM.vgg_pool_layers(ratio)) == \
        _work(JPM.vgg_pool_layers(ratio))


# --------------------------------------------------------------------------
# the paper's claims, against the port's model (bands of
# tests/test_perfmodel.py)
# --------------------------------------------------------------------------

CNNS = [get_config(c) for c in CNN_IDS]
VGG = CNNS[0]


def _fig3a_gemm_direct_drop_45_54pct():
    ipc = PM.relative_ipc(PM.gemm_workload(), "direct")
    assert 0.46 <= ipc <= 0.55          # paper: IPC drops 45-54%


def _fig3a_counter_not_better_than_direct_small_cache():
    g = PM.gemm_workload()
    d = PM.relative_ipc(g, "direct")
    for kb in (24, 96, 384):
        assert PM.relative_ipc(g, "counter", ctr_cache_kb=kb) <= d + 1e-9


def _fig3a_large_counter_cache_recovers():
    g = PM.gemm_workload()
    small = PM.relative_ipc(g, "counter", ctr_cache_kb=96)
    big = PM.relative_ipc(g, "counter", ctr_cache_kb=1536)
    assert big > small                  # paper: +15% with 1536KB


def _fig13_e2e_ipc_drop_30_38pct():
    for cfg in CNNS:
        w = PM.cnn_workload(cfg, 0.5)
        for sch in ("direct", "counter"):
            ipc = PM.relative_ipc(w, sch)
            assert 0.62 <= ipc <= 0.70, (cfg.name, sch, ipc)


def _fig13_seal_1p4_to_1p6x_over_traditional():
    for cfg in CNNS:
        w = PM.cnn_workload(cfg, 0.5)
        seal = PM.relative_ipc(w, "seal")
        for sch in ("direct", "counter"):
            ratio = seal / PM.relative_ipc(w, sch)
            assert 1.38 <= ratio <= 1.62, (cfg.name, sch, ratio)


def _fig13_seal_small_loss_vs_baseline():
    for cfg in CNNS:
        ipc = PM.relative_ipc(PM.cnn_workload(cfg, 0.5), "seal")
        assert 0.93 <= ipc <= 0.985, (cfg.name, ipc)


def _fig14_counter_extra_accesses_31_35pct():
    w = PM.cnn_workload(VGG, 0.5)
    base = PM.evaluate_network(w, "baseline")
    ctr = PM.evaluate_network(w, "counter")
    b = base["accesses_plain"] + base["accesses_enc"]
    assert 0.31 <= ctr["accesses_ctr"] / b <= 0.35


def _fig14_se_reduces_encrypted_accesses_39_45pct():
    for cfg in CNNS:
        w = PM.cnn_workload(cfg, 0.5)
        full = PM.evaluate_network(w, "direct")["accesses_enc"]
        se = PM.evaluate_network(w, "seal")["accesses_enc"]
        assert 0.36 <= 1 - se / full <= 0.48, cfg.name


def _fig14_counter_se_about_20pct_extra():
    w = PM.cnn_workload(VGG, 0.5)
    base = PM.evaluate_network(w, "baseline")
    cse = PM.evaluate_network(w, "counter+se")
    b = base["accesses_plain"] + base["accesses_enc"]
    assert 0.15 <= cse["accesses_ctr"] / b <= 0.25


def _fig15_latency_direct_counter_39_60pct():
    for cfg in CNNS:
        w = PM.cnn_workload(cfg, 0.5)
        for sch in ("direct", "counter"):
            lat = PM.relative_latency(w, sch)
            assert 1.39 <= lat <= 1.62, (cfg.name, sch, lat)


def _fig15_seal_latency_5_7pct():
    for cfg in CNNS:
        lat = PM.relative_latency(PM.cnn_workload(cfg, 0.5), "seal")
        assert 1.015 <= lat <= 1.075, (cfg.name, lat)


def _fig12_ratio_sweep_monotone_and_recovers():
    layer = PM.vgg_conv_layers()[256]
    prev = 0.0
    for r in [1.0, 0.8, 0.5, 0.2, 0.0]:
        lw = dataclasses.replace(layer, enc_frac_w=r, enc_frac_in=r,
                                 enc_frac_out=r)
        ipc = PM.relative_ipc([lw], "seal")
        assert ipc >= prev - 1e-9
        prev = ipc
    assert prev == pytest.approx(1.0, abs=0.01)   # ratio 0 == baseline


def _fig10_conv_ipc_ordering():
    for ch, layer in PM.vgg_conv_layers().items():
        ipc = {s: PM.relative_ipc([layer], s)
               for s in ("direct", "counter", "seal", "counter+se")}
        assert ipc["seal"] >= ipc["counter+se"] >= ipc["counter"] - 1e-9
        assert ipc["direct"] <= 0.80, ch


def _fig11_pool_more_bandwidth_bound_than_conv():
    pool = PM.vgg_pool_layers()[0]
    conv = PM.vgg_conv_layers()[256]
    assert PM.relative_ipc([pool], "direct") < \
        PM.relative_ipc([conv], "direct")


CLAIMS = {f.__name__[1:]: f for f in (
    _fig3a_gemm_direct_drop_45_54pct,
    _fig3a_counter_not_better_than_direct_small_cache,
    _fig3a_large_counter_cache_recovers,
    _fig13_e2e_ipc_drop_30_38pct,
    _fig13_seal_1p4_to_1p6x_over_traditional,
    _fig13_seal_small_loss_vs_baseline,
    _fig14_counter_extra_accesses_31_35pct,
    _fig14_se_reduces_encrypted_accesses_39_45pct,
    _fig14_counter_se_about_20pct_extra,
    _fig15_latency_direct_counter_39_60pct,
    _fig15_seal_latency_5_7pct,
    _fig12_ratio_sweep_monotone_and_recovers,
    _fig10_conv_ipc_ordering,
    _fig11_pool_more_bandwidth_bound_than_conv)}


@pytest.mark.parametrize("claim", sorted(CLAIMS))
def test_paper_claim_holds_in_the_port(claim):
    CLAIMS[claim]()
