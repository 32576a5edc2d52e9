"""Tests of the benchmark. Run from the root of the repository:

    python -m pytest -q sealbench/tests

The ``gpu``-marked tests decide inside the test whether a card is there.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


# the limit of the widest gap at the tiny size: granite's tied head under
# its logit scaling reads logits about 100 times flatter than internlm2's
TINY_LIMIT = {"internlm2-chat": 0.25, "granite-code": 0.02}


def tiny_cell(workload: str = "internlm2-chat", **mix):
    """A cell of the benchmark cut to a size the CPU runs in seconds: the
    same files, two layers of width 128, four slots."""
    from sealbench import spec

    cell = spec.load_cell(workload)
    c = dict(cell.config)
    c.update(name="tiny", hidden_size=128, intermediate_size=256,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, vocab_size=512)
    m = dict(cell.mix)
    m.update(clients=4, slots=4, max_len=96, chunk_tokens=32, admit_batch=2,
             prompt_tokens={"dist": "log_normal", "median": 22,
                            "sigma": 0.6, "min": 8, "max": 60},
             output_tokens={"dist": "log_normal", "median": 10,
                            "sigma": 0.6, "min": 4, "max": 24},
             check_tokens=40, check_requests=6, trace_steps=4)
    m.update(mix)
    cell.config, cell.mix = c, m
    cell.check = {"widest_gap_limit": TINY_LIMIT[workload]}
    return cell


@pytest.fixture
def small_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
