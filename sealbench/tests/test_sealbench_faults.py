"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a serving cell can have, and for the control: the run
is driven as on the card, at a reduced size on the CPU's plain path, with
the harness's look for a card skipped."""
import itertools

import pytest
import torch

from conftest import TINY_LIMIT, tiny_cell
from sealbench import harness


def ticking():
    counter = itertools.count()
    return lambda: next(counter) * 0.01


def run(workload="internlm2-chat", **kw):
    return harness.run(tiny_cell(workload), 4242, 6.0, False, "cpu", 0.0,
                       clock=ticking(), **kw)


def altered_token(mp):
    from repro_torch.serve import step

    orig = step.decode_tick

    def tick(cfg, *a, **kw):
        tok, cok, logits = orig(cfg, *a, **kw)
        return (tok + 1) % cfg.vocab_size, cok, logits
    mp.setattr(step, "decode_tick", tick)


def state_unchanged(mp):
    from repro_torch.models import paged

    mp.setattr(paged, "append_tokens", lambda *a, **kw: None)


def half_batch(mp):
    from repro_torch.models import paged

    orig = paged.decode_logits

    def logits_of_half(*a, **kw):
        logits, updates, ok = orig(*a, **kw)
        h = logits.shape[0] // 2
        logits = torch.cat([logits[:h], logits[:logits.shape[0] - h]])
        return logits, updates, ok
    mp.setattr(paged, "decode_logits", logits_of_half)


@pytest.mark.parametrize("workload", ["internlm2-chat", "granite-code"])
def test_a_sound_run_is_correct(workload, small_threads):
    """Granite's cell runs its published multipliers and epsilon through
    the weights folded for the program; internlm2's its epsilon."""
    res = run(workload)
    assert res["correct"] is True
    assert res["check"]["widest_gap"]["value"] <= TINY_LIMIT[workload]


@pytest.mark.parametrize("workload", ["internlm2-chat", "granite-code"])
@pytest.mark.parametrize("fault", [altered_token, state_unchanged,
                                   half_batch])
def test_a_fault_is_not_correct(fault, workload, monkeypatch, small_threads):
    fault(monkeypatch)
    res = run(workload)
    assert res["correct"] is False
    assert res["check"]["widest_gap"]["value"] > TINY_LIMIT[workload]


def test_the_float8_control_is_not_correct(small_threads):
    """The control in the program's place fails the same comparison."""
    res = run(control=True)
    gap = res["check"]["widest_gap"]["value"]
    assert res["correct"] is False
    assert gap > res["check"]["widest_gap"]["limit"]
    assert gap >= 3 * res["program_gap"]
