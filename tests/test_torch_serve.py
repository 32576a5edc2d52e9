"""The port's continuous-batching engine (``serve/engine.py``,
``serve/step.py``, ``serve/sampling.py``) held against the JAX package's
plaintext ``ServeEngine`` on the CPU.

The reference's own fused sealed engine is only ever traced on the CPU
(tests/test_sealed_tensor.py), so the sealed runs of the port are held to
the reference's *plaintext* token streams, and to the port's plaintext
streams, exactly. Greedy tokens compare exactly; the models run in f32 for
the cross-framework comparison (XLA and PyTorch sum in different orders, so
bf16 roundings could flip a near-tied argmax), and in bf16 for sealed vs
plaintext inside the port, where the arithmetic is the same by construction.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config import SealConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.device import resolve_device
from repro_torch.serve import step as ST
from repro_torch.serve.engine import ServeEngine

LENS = (5, 12, 19, 40, 8, 33)       # several need more than one chunk
KW = dict(batch_slots=2, max_len=64, chunk_tokens=8)


@pytest.fixture(scope="module")
def f32_model():
    cfg_j = jget_reduced("internlm2_1_8b").with_(dtype="float32")
    cfg_t = get_reduced("internlm2_1_8b").with_(dtype="float32")
    pj = JT.init_params(cfg_j, jax.random.key(1))
    return cfg_j, cfg_t, pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def _prompts(vocab, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n) for n in LENS]


def _staggered(eng, prompts):
    """One arrival per scheduler step, then drain."""
    handles = []
    for i, p in enumerate(prompts):
        handles.append(eng.submit(p, max_tokens=4 + i))
        eng.step()
    while eng.busy:
        eng.step()
    assert all(h.done for h in handles)
    return [h.out for h in handles]


def test_greedy_streams_match_reference(f32_model):
    cfg_j, cfg_t, pj, pt = f32_model
    prompts = _prompts(cfg_t.vocab_size)
    ref = JServeEngine(cfg_j, pj, seal=None, seal_cache=False, **KW)
    want = _staggered(ref, prompts)
    runs = {
        "plaintext": ServeEngine(cfg_t, pt, device="cpu", **KW),
        "sealed cache": ServeEngine(cfg_t, pt, seal_cache=True,
                                    device="cpu", **KW),
        "sealed weights + cache": ServeEngine(cfg_t, pt, seal=SealConfig(),
                                              device="cpu", **KW),
    }
    for name, eng in runs.items():
        assert _staggered(eng, prompts) == want, name
        for key in ("prefills", "prefill_chunks", "decode_steps", "tokens"):
            assert eng.stats[key] == ref.stats[key], (name, key)
        # counters bump on the same blocks in the same order
        np.testing.assert_array_equal(eng._state.wc.numpy().view(np.uint32),
                                      np.asarray(ref._state.wc))
        eng.check_device_mirror()
        assert len(eng._free) == eng.num_blocks - 1
    sealed = runs["sealed weights + cache"]
    assert set(sealed.stats) == set(ref.stats)
    assert sealed.stats["kv_plaintext_bytes_per_step"] == 0
    assert sealed.stats["fused_matmul_leaves"] == 8
    assert 0 < sealed.stats["weights_plaintext_bytes_per_step"] < \
        runs["plaintext"].stats["weights_plaintext_bytes_per_step"]


@pytest.mark.parametrize("mode", ["coloe", "counter"])
def test_bf16_sealed_streams_equal_plaintext(mode):
    cfg_j = jget_reduced("internlm2_1_8b")
    cfg_t = get_reduced("internlm2_1_8b")
    pt = params_from_numpy(jax.tree.map(
        np.asarray, JT.init_params(cfg_j, jax.random.key(2))))
    prompts = _prompts(cfg_t.vocab_size, seed=1)
    plain = _staggered(ServeEngine(cfg_t, pt, device="cpu", **KW), prompts)
    sealed = _staggered(ServeEngine(cfg_t, pt, seal=SealConfig(mode=mode),
                                    device="cpu", **KW), prompts)
    assert sealed == plain


def test_decode_tick_reads_nothing_from_the_host(f32_model, monkeypatch):
    """Port of the reference's host-free tick check: with every way a tensor
    can be read on the host blocked, a sealed decode tick still runs."""
    _, cfg_t, _, pt = f32_model
    eng = ServeEngine(cfg_t, pt, seal=SealConfig(), device="cpu", **KW)
    for p in _prompts(cfg_t.vocab_size)[:2]:
        eng.submit(p, max_tokens=8)
    while any(r is None or eng._pending[i] is not None
              for i, r in enumerate(eng._active)):
        eng.step()

    def blocked(*_a, **_k):
        raise AssertionError("a decode tick read a tensor on the host")

    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, blocked)
    tok, cok, logits = ST.decode_tick(cfg_t, eng.params(), eng._pools,
                                      eng._state, eng.cache_seal)
    monkeypatch.undo()
    assert tok.shape == (2,) and logits.shape == (2, cfg_t.vocab_size)
    assert bool(cok.all())


def test_unported_options_raise(f32_model):
    """No option is refused any more: sampling settings, prefix sharing,
    verification (over the cache and over sealed weights), fault hooks and
    the Direct engine (AES-128), the last one that was, build and run."""
    _, cfg_t, _, pt = f32_model
    eng = ServeEngine(cfg_t, pt, device="cpu", **KW)
    reqs = [eng.submit([1, 2, 3], max_tokens=2, **kw)
            for kw in (dict(temperature=0.7), dict(top_k=5),
                       dict(top_p=0.9))]
    eng.run()
    assert all(len(r.out) == 2 for r in reqs)
    hook = object()
    shared = ServeEngine(cfg_t, pt, device="cpu", prefix_share=True, **KW)
    assert shared._registry is not None and shared._registry.bs == 16
    verified = ServeEngine(cfg_t, pt, seal_cache=True, verify=True,
                           device="cpu", fault_hooks=(hook,), **KW)
    assert verified.cache_seal.mac is not None
    assert verified.fault_hooks == (hook,)
    sealed = ServeEngine(cfg_t, pt, seal=SealConfig(), verify=True,
                         device="cpu", **KW)
    assert sealed.seal.verify and sealed.cache_seal.mac is not None
    direct = ServeEngine(cfg_t, pt, seal=SealConfig(mode="direct"),
                         device="cpu", **KW)
    assert direct.sealed.fused_paths() == [] and all(
        st.meta.scheme == "direct" for st in direct.sealed.tensors.values())
    assert direct.stats["fused_matmul_leaves"] == 0


def test_entry_points_default_to_the_card():
    """``device=None`` means CUDA; without a card that raises instead of
    quietly running on the CPU."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("engine", ["continuous", "group"])
@pytest.mark.parametrize("bad", [-1, "vocab"])
def test_submit_rejects_out_of_range_ids(f32_model, engine, bad):
    """A prompt id outside [0, vocab) is refused at ``submit``, before
    anything reaches the device (the reference embeds a NaN row or wraps
    the id; on the card an id past the table would fault the context)."""
    from repro_torch.serve.engine import GroupServeEngine
    _, cfg_t, _, pt = f32_model
    cls = ServeEngine if engine == "continuous" else GroupServeEngine
    eng = cls(cfg_t, pt, batch_slots=2, max_len=64, device="cpu")
    bad = cfg_t.vocab_size if bad == "vocab" else bad
    with pytest.raises(ValueError, match="token ids"):
        eng.submit([1, bad, 2], max_tokens=2)
    assert not eng.queue
    eng.submit([0, cfg_t.vocab_size - 1], max_tokens=2)   # the edges pass
    assert len(eng.queue) == 1
