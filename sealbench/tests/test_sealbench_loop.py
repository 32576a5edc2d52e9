"""The closed loop driving the program's ``ServeEngine`` on the CPU's
plain path, at a reduced configuration."""
import itertools

import numpy as np

from conftest import tiny_cell
from sealbench import harness, port
from sealbench.loop import ClosedLoop
from sealbench.reference import dense_gqa as R
from sealbench.traffic import Traffic


def ticking(step=0.01):
    counter = itertools.count()
    return lambda: next(counter) * step


def test_every_client_keeps_one_request_in_flight(small_threads):
    cell = tiny_cell()
    cfg = port.model_config(cell.config)
    w = R.make_weights(cell.config, 11, "cpu")
    eng = port.make_engine(cfg, port.params_tree(cell.config, w), cell.config, cell.mix,
                           bytes(32), "cpu")
    loop = ClosedLoop(eng, Traffic(cell.mix, 11, cfg.vocab_size), 4,
                      ticking())
    loop.open()
    firsts = list(loop.records)
    for _ in range(60):
        loop.step()
        assert len(loop.inflight) == 4
        assert sorted(r.client for r in loop.inflight.values()) == [0, 1, 2, 3]
    assert loop.ramped()
    done = [r for r in loop.records if r.t_done is not None]
    assert len(done) >= 6
    for r in loop.records:
        assert len(r.stamps) == len(r.req.out)
        assert r.stamps == sorted(r.stamps)
        assert all(r.t_submit < t for t in r.stamps)
    for r in done:
        assert len(r.req.out) == r.budget and r.stamps[-1] == r.t_done
        # the client's next request went in as this one completed
        nxt = [x for x in loop.records
               if x.client == r.client and x.t_submit >= r.t_done]
        assert nxt and nxt[0].t_submit - r.t_done < 0.05
    # first budgets are residual lives, never above the mix's longest
    assert all(1 <= r.budget <= cell.mix["output_tokens"]["max"]
               for r in firsts)


def test_a_run_on_the_cpu_reports_the_cell_metrics(small_threads):
    cell = tiny_cell()
    res = harness.run(cell, 2 ** 31 + 77, 6.0, False, "cpu", 0.0,
                      clock=ticking())
    assert res["correct"] is True
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "window", "check"]
    assert set(res["metrics"]) == {"output_tok_s", "ttft_p90_ms",
                                   "itl_p95_ms", "setup_s"}
    assert all(np.isfinite(m["value"]) and m["value"] > 0
               for m in res["metrics"].values())
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["check"]["widest_gap"]["value"] <= 0.25
    assert res["check"]["served_tokens_checked"]["value"] >= 40
