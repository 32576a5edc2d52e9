"""On the card: the control at the cell's own size fails the committed
limit, a sound run passes it, and a traced run reports every per-layer
metric. Run on the card with

    python -m pytest -q -m gpu sealbench/tests/test_sealbench_gpu.py
"""
import time

import pytest

from sealbench import harness, spec


def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")


@pytest.mark.gpu
def test_control_fails_the_cell_limit():
    card()
    cell = spec.load_cell("internlm2-chat")
    res = harness.run(cell, 1618033988, 20.0, False, "cuda",
                      time.perf_counter(), control=True)
    limit = cell.check["widest_gap_limit"]
    assert res["correct"] is False
    assert res["check"]["widest_gap"]["value"] > limit
    assert res["program_gap"] <= limit


@pytest.mark.gpu
def test_traced_run_reports_every_metric():
    card()
    cell = spec.load_cell("internlm2-chat")
    res = harness.run(cell, 1414213562, 10.0, True, "cuda",
                      time.perf_counter())
    assert res["correct"] is True
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    for name, m in res["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, name
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
