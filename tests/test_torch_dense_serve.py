"""The remaining dense token architectures (``granite_3_2b``,
``deepseek_coder_33b``, also with ``pad_heads_to=6``, and ``gemma2_2b``)
served by the port's continuous engine, held against the JAX package's on
the CPU at their reduced configs on the reference's weights.

Greedy streams and the scheduler's stats compare exactly, in f32 (XLA and
PyTorch sum in different orders, so bf16 roundings could flip an argmax
between the packages).
"""
import numpy as np
import pytest
import torch

from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config import SealConfig
from repro_torch.serve.engine import ServeEngine
from test_torch_dense_families import CASES, SCHED, _model

LENS = (5, 12, 19, 33, 8, 14)
KW = dict(batch_slots=4, max_len=64, chunk_tokens=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: intra-op threads only contend under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab):
    rng = np.random.RandomState(2)
    return [rng.randint(0, vocab, n) for n in LENS]


def _staggered(eng, prompts):
    """One arrival per scheduler step, then drain."""
    handles = []
    for i, p in enumerate(prompts):
        handles.append(eng.submit(p, max_tokens=4 + i % 3))
        eng.step()
    while eng.busy:
        eng.step()
    assert all(h.done for h in handles)
    return [h.out for h in handles]


_REFERENCE = {}


def _reference(case):
    """The reference's plaintext continuous run (streams, stats), once."""
    if case not in _REFERENCE:
        cfg_j, cfg_t, pj, _ = _model(case)
        eng = JServeEngine(cfg_j, pj, seal=None, seal_cache=False, **KW)
        _REFERENCE[case] = (_staggered(eng, _prompts(cfg_t.vocab_size)),
                            eng.stats)
    return _REFERENCE[case]


RUNS = {"plaintext": dict(seal=None),
        "coloe": dict(seal=SealConfig()),
        "coloe-verified": dict(seal=SealConfig(), verify=True),
        "direct": dict(seal=SealConfig(mode="direct"))}


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("case", list(CASES))
def test_serve_engine_streams_match_reference(case, run):
    """Staggered streams under plaintext, ColoE (sealed cache), ColoE with
    ``verify`` and Direct equal the reference plaintext engine's, with its
    scheduler stats (a sealed cache has no plaintext KV bytes; a verified
    run counts a cache check a chunk row and a decode token, plus one
    weight sweep)."""
    _, cfg_t, _, pt = _model(case)
    want, ref = _reference(case)
    prompts = _prompts(cfg_t.vocab_size)
    eng = ServeEngine(cfg_t, pt, device="cpu", **RUNS[run], **KW)
    assert _staggered(eng, prompts) == want
    exp = dict(ref)
    if eng.seal_cache:
        exp["kv_plaintext_bytes_per_step"] = 0
    if eng.verify:
        exp["mac_checks"] = 1 + ref["prefill_chunks"] + ref["tokens"] - \
            len(prompts)
    for key in SCHED:
        assert eng.stats[key] == exp[key], key
    eng.check_device_mirror()
    assert len(eng._free) == eng.num_blocks - 1
