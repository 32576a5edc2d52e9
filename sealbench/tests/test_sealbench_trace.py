"""The trace's reduction and the per-layer readers, on events made here."""

import pytest

from sealbench import harness, readers, roofline_work as W, spec
from sealbench.trace import Stretch, breakdown, short_name

CUDA, CPU = "DeviceType.CUDA", "DeviceType.CPU"


def ev(name, a, b, dev=CUDA):
    """A profiler event from a to b microseconds."""
    return (name, dev == CUDA, a * 1e-6, b * 1e-6)


def stretch():
    events = [
        ev("engine.step", 100, 200, CPU), ev("engine.step", 200, 300, CPU),
        ev("engine.step", 100, 200),          # its GPU user annotation
        ev("step.decode_tick", 110, 150, CPU),
        ev("engine.fetch", 180, 199, CPU),
        ev("void sealed_matmul_dec_kernel<4>(CUtensorMap, Args)", 120, 140),
        ev("void sealed_matmul_dec_kernel<4>(CUtensorMap, Args)", 130, 160),
        ev("cache_view_kernel(unsigned int const*)", 210, 230),
        ev("void at::native::elementwise_kernel<128, 2>(int)", 240, 280),
        ev("void sealed_matmul_tc_kernel(CUtensorMap)", 50, 90),   # before
    ]
    return Stretch(events, {"engine.step", "step.decode_tick",
                            "engine.fetch"})


def test_stretch_unions_device_time_within_the_steps():
    s = stretch()
    assert (s.t0, s.t1, s.steps) == pytest.approx((100e-6, 300e-6, 2))
    assert s.window_s == pytest.approx(200e-6)
    # 120-160 (two overlapping), 210-230, 240-280
    assert s.busy_s == pytest.approx((40 + 20 + 40) * 1e-6)
    assert s.time_of("sealed_matmul_dec_kernel") == (pytest.approx(50e-6), 2)
    assert s.time_of("sealed_matmul_kernel")[1] == 0
    assert s.time_of("sealed_matmul_tc_kernel")[1] == 0


def test_idle_gaps_are_named_by_the_open_span():
    gaps = stretch().idle_by_span()
    # 100-120 in the decode tick's call, 160-210 (mid 185, the fetch),
    # 230-240 and 280-300 inside the second step
    assert gaps["step.decode_tick"] == pytest.approx(20e-6)
    assert gaps["engine.fetch"] == pytest.approx(50e-6)
    assert gaps["engine.step"] == pytest.approx(30e-6)
    b = breakdown(stretch())
    assert b["device_ops"][0] == ["sealed_matmul_dec_kernel",
                                  pytest.approx(50e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_short_names():
    assert short_name("void foo<1, (bar)2>(int, float)") == "foo"
    assert short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
    assert short_name("(anonymous namespace)::sealed_matmul_tc_kernel("
                      "CUtensorMap_st, (anonymous namespace)::Args)") == \
        "sealed_matmul_tc_kernel"
    assert short_name("void at::native::(anonymous namespace)::cat<int>("
                      "float)") == "at::native::cat"


def run_data(dispatches, s=None):
    cell = spec.load_cell("internlm2-chat")
    return harness.RunData(cell.config, cell.mix, {"first": 3},
                           {"tokens": 99, "decode_steps": 3},
                           {"engine.decode_tick": (0.3, 3),
                            "step.decode_tick": (0.12, 3)},
                           s, dispatches, ["sealed_matmul_dec_kernel",
                                           "cache_view_kernel"])


def counts(**kw):
    base = dict.fromkeys(["sealed_matmul", "sealed_matmul_dec",
                          "sealed_matmul_tc", "chacha20_cache_view"], 0)
    base.update(kw)
    return base


def test_span_and_counter_readers():
    run = run_data([])
    assert spec.reader("decode_tick_ms")(run) == pytest.approx(100.0)
    assert spec.reader("decode_enqueue_ms")(run) == pytest.approx(40.0)
    assert spec.reader("chunk_tick_ms")(run) is None
    # 96 decoded tokens over 3 ticks of 32 slots
    assert spec.reader("sched.decode_occupancy")(run) == pytest.approx(1.0)


def test_device_readers():
    c = spec.load_cell("internlm2-chat").config
    shape = {"kind": "decode", "slots": 32, "lengths": [100] * 32,
             "running": [True] * 32, "mb": 110}
    launches = W.matmul_launches(c, shape)
    d = {"shape": shape, "before": counts(),
         "after": counts(sealed_matmul_dec=len(launches),
                         chacha20_cache_view=24)}
    run = run_data([d], stretch())
    bound = sum(W.sealed_bound(*x, 2)[0] for x in launches)
    # 169 launches counted, 2 traced in 50 us
    want = 100 * (bound / 169) / (50e-3 / 2)
    assert spec.reader("sealed_matmul_dec_roofline")(run) == \
        pytest.approx(want)
    assert spec.reader("sealed_matmul_tc_roofline")(run) is None
    view = sum(W.pad_bound(*x)[0] for x in W.view_launches(c, shape, 16))
    assert spec.reader("cache_view_roofline")(run) == \
        pytest.approx(100 * (view / 24) / 20e-3)
    assert spec.reader("device.idle_share")(run) == pytest.approx(50.0)
    assert spec.reader("torch_ops.device_share")(run) == \
        pytest.approx(100 * 40 / 110)
    assert spec.reader("mfu")(run) == pytest.approx(
        100 * W.dispatch_flops(c, shape) / (200e-6 * 989e12))


def test_unattributable_dispatches_read_nothing():
    shape = {"kind": "chunk", "rows": 2, "chunk": 512, "cl": [512, 40],
             "final": [False, True], "lengths": [0, 512], "mb": 110}
    bad = {"shape": shape, "before": counts(),
           "after": counts(sealed_matmul_tc=100, chacha20_cache_view=24)}
    assert readers.matmul_bound_ms(run_data([bad], stretch())) is None
    good = dict(bad, after=counts(sealed_matmul_tc=168, sealed_matmul_dec=1,
                                  chacha20_cache_view=24))
    got = readers.matmul_bound_ms(run_data([good], stretch()))
    assert got["sealed_matmul_dec"][1] == 1 and got["sealed_matmul_tc"][1] == 168
    assert spec.reader("cache_view_roofline")(
        run_data([dict(good, after=counts(sealed_matmul_tc=168,
                                          sealed_matmul_dec=1,
                                          chacha20_cache_view=23))],
                 stretch())) is None


def test_every_listed_metric_has_a_reader():
    import json

    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
