"""MoE serving in the port (``serve/engine.py`` ``ServeEngine`` and
``GroupServeEngine``, ``serve/step.py::chunk_step``'s padding rows, the
launcher) held against the JAX package on the CPU, at the reduced
``qwen3_moe_30b_a3b`` and ``dbrx_132b`` on the reference's weights.

The chunk pass of an MoE model runs the reference's whole (admit width,
chunk) batch, padding rows included: an expert's capacity counts every
token of the dispatch, so the padding rows' tokens decide which real
tokens keep their experts. At 8 slots the admit width is 2 and staggered
arrivals leave dispatches with one pending slot.

Greedy token streams and the scheduler's stats compare exactly, in f32
across the two packages (XLA and PyTorch sum in different orders, so bf16
roundings could flip a near-tied route or argmax between them) and in bf16
for sealed against plaintext inside the port, where the arithmetic is the
same by construction.
"""
import ast
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro.serve.engine import GroupServeEngine as JGroupServeEngine
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config import SealConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.mac import SealedIntegrityError
from repro_torch.launch import serve as LS
from repro_torch.serve import engine as EM
from repro_torch.serve.engine import GroupServeEngine, ServeEngine

ARCHS = ("qwen3_moe_30b_a3b", "dbrx_132b")
LENS = (5, 12, 19, 33, 8, 14)
KW = dict(max_len=80, chunk_tokens=8)
# the scheduler's stats, which the weights do not change
SCHED = ("prefills", "prefill_chunks", "decode_steps", "tokens", "cow_copies",
         "mac_checks", "mac_failures", "retries", "shared_prefix_blocks",
         "shared_prefix_tokens", "kv_plaintext_bytes_per_step")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These reduced models gain nothing from intra-op threads, and under
    pytest-xdist each worker's threads contend with every other worker's:
    one thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32"):
    return (jget_reduced(arch).with_(dtype=dtype),
            get_reduced(arch).with_(dtype=dtype))


_MODELS = {}


def _model(arch):
    """(cfg_j, cfg_t, params_j, params_t) of the reduced config in f32, the
    reference's weights in both packages; built once a module."""
    if arch not in _MODELS:
        cfg_j, cfg_t = _cfgs(arch)
        pj = JT.init_params(cfg_j, jax.random.key(3))
        _MODELS[arch] = (cfg_j, cfg_t, pj,
                         params_from_numpy(jax.tree.map(np.asarray, pj)))
    return _MODELS[arch]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


def _prompts(vocab, seed=0, lens=LENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n) for n in lens]


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


def _reference(arch, slots):
    """The reference's plaintext continuous run (streams, stats); run once
    a module."""
    key = (arch, slots)
    if key not in _REFERENCE:
        cfg_j, cfg_t, pj, _ = _model(arch)
        eng = JServeEngine(cfg_j, pj, seal=None, seal_cache=False,
                           batch_slots=slots, **KW)
        _REFERENCE[key] = (_staggered(eng, _prompts(cfg_t.vocab_size)),
                           eng.stats)
    return _REFERENCE[key]


def _count_padded(monkeypatch):
    """Records each chunk dispatch's padding rows."""
    pads = []
    orig = EM.ST.chunk_step

    def counted(*a, **k):
        pads.append(k.get("pad_rows", 0))
        return orig(*a, **k)

    monkeypatch.setattr(EM.ST, "chunk_step", counted)
    return pads


@pytest.mark.parametrize("arch,slots", [("qwen3_moe_30b_a3b", 4),
                                        ("qwen3_moe_30b_a3b", 8),
                                        ("dbrx_132b", 8)])
def test_continuous_streams_match_reference(arch, slots, monkeypatch):
    """Plaintext and verified sealed (ColoE, SE 0.5, sealed cache) engines,
    and at 8 slots an unverified sealed one, emit the reference's streams
    with its scheduler stats. The verified run counts what the reference's
    verified engine counts (a cache check a chunk row and a decode token;
    ``test_launcher_line_matches_reference`` holds that to the reference's
    own count) plus the weight sweep. At 8 slots some chunk dispatches
    carry a padding row, at 4 none."""
    _, cfg_t, _, pt = _model(arch)
    want, ref_stats = _reference(arch, slots)
    prompts = _prompts(cfg_t.vocab_size)
    decode_tokens = ref_stats["tokens"] - len(prompts)
    ref_v = dict(ref_stats, mac_checks=ref_stats["prefill_chunks"]
                 + decode_tokens, kv_plaintext_bytes_per_step=0)
    pads = _count_padded(monkeypatch)
    runs = {
        "plaintext": ServeEngine(cfg_t, pt, batch_slots=slots, device="cpu",
                                 **KW),
        "verified": ServeEngine(cfg_t, pt, batch_slots=slots,
                                seal=SealConfig(), verify=True, device="cpu",
                                **KW),
    }
    if slots == 8:      # the verified streams equal the unverified ones
        runs["sealed"] = ServeEngine(cfg_t, pt, batch_slots=slots,
                                     seal=SealConfig(), device="cpu", **KW)
    for name, eng in runs.items():
        pads.clear()
        assert _staggered(eng, prompts) == want, name
        ref = ref_v if name == "verified" else ref_stats
        for key in SCHED:
            extra = 1 if (name, key) == ("verified", "mac_checks") else 0
            if name == "sealed" and key == "kv_plaintext_bytes_per_step":
                assert eng.stats[key] == 0
                continue
            assert eng.stats[key] == ref[key] + extra, (name, key)
        assert (eng.stats["mac_checks"] > 0) == (name == "verified")
        assert set(eng.stats) == set(ref_stats)
        eng.check_device_mirror()
        assert len(eng._free) == eng.num_blocks - 1
        padded = sum(p > 0 for p in pads)
        assert (padded > 0) == (slots == 8), (name, pads)
    assert runs["verified"].stats["fused_matmul_leaves"] == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_unpadded_chunks_route_differently(arch, monkeypatch):
    """Why the padding rows: the same engine given only the real rows of
    each chunk dispatch routes some tokens to other experts (capacity
    differs), and its streams leave the reference's."""
    _, cfg_t, _, pt = _model(arch)
    orig = EM.ST.chunk_step
    monkeypatch.setattr(EM.ST, "chunk_step",
                        lambda *a, **k: orig(*a, **dict(k, pad_rows=0)))
    eng = ServeEngine(cfg_t, pt, batch_slots=8, device="cpu", **KW)
    assert _staggered(eng, _prompts(cfg_t.vocab_size)) != \
        _reference(arch, 8)[0]


def test_padding_rows_write_nothing(model):
    """A padded chunk dispatch (one pending slot at admit width 2) leaves
    the pools' written words, the counters and the state as the real row
    alone does: the padding row reads the last slot's cache and writes
    nothing."""
    _, cfg_t, _, pt = model
    orig = EM.ST.chunk_step
    seen = []

    def unpadded(*a, **k):
        seen.append(k["pad_rows"])
        return orig(*a, **dict(k, pad_rows=0))

    engs = []
    for pad in (True, False):
        eng = ServeEngine(cfg_t, pt, batch_slots=8, seal_cache=True,
                          device="cpu", **KW)
        eng.submit(_prompts(cfg_t.vocab_size)[3], max_tokens=3)
        with pytest.MonkeyPatch.context() as mp:
            if not pad:
                mp.setattr(EM.ST, "chunk_step", unpadded)
            eng.step()
        engs.append(eng)
    assert seen == [1]
    a, b = engs
    for pa, pb in zip(a._pools, b._pools):
        for key in ("k", "v"):
            assert torch.equal(pa[key] != 0, pb[key] != 0), key
    for name in ("lengths", "wc", "run", "counts", "tables"):
        assert torch.equal(getattr(a._state, name), getattr(b._state, name))
    a.check_device_mirror()


def _serve_group(eng, prompts):
    hs = [eng.submit(p, max_tokens=3 + i) for i, p in enumerate(prompts)]
    eng.run()
    return [h.out for h in hs]


_GROUP_REFERENCE = {}


@pytest.mark.parametrize("seal", [None, "coloe", "counter"])
def test_group_streams_match_reference(model, seal):
    """Left-padded groups prefill through the capacity path (``prefill``
    mode), decode through the dense one: the reference's streams."""
    cfg_j, cfg_t, pj, pt = model
    prompts = _prompts(cfg_t.vocab_size, seed=1, lens=(5, 12, 12, 9, 16, 7))
    if cfg_t.name not in _GROUP_REFERENCE:
        ref = JGroupServeEngine(cfg_j, pj, seal=None, batch_slots=2,
                                max_len=40)
        _GROUP_REFERENCE[cfg_t.name] = (_serve_group(ref, prompts),
                                        ref.stats)
    want, ref_stats = _GROUP_REFERENCE[cfg_t.name]
    eng = GroupServeEngine(cfg_t, pt, batch_slots=2, max_len=40,
                           seal=seal and SealConfig(mode=seal), device="cpu")
    assert _serve_group(eng, prompts) == want
    for key in ("prefills", "decode_steps", "tokens",
                "kv_plaintext_bytes_per_step"):
        assert eng.stats[key] == ref_stats[key], key


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_sealed_streams_equal_plaintext(arch):
    """In bf16 the sealed engines (fused attention and head, experts and
    router unsealed each dispatch) emit the plaintext engines' streams."""
    cfg_j, cfg_t = _cfgs(arch, "bfloat16")
    pt = params_from_numpy(jax.tree.map(
        np.asarray, JT.init_params(cfg_j, jax.random.key(2))))
    prompts = _prompts(cfg_t.vocab_size, seed=4)
    for cls, kw in ((ServeEngine, dict(batch_slots=8, **KW)),
                    (GroupServeEngine, dict(batch_slots=4, max_len=80))):
        streams = []
        for seal in (None, SealConfig()):
            eng = cls(cfg_t, pt, seal=seal, device="cpu", **kw)
            if cls is ServeEngine:
                streams.append(_staggered(eng, prompts))
            else:
                hs = [eng.submit(p, max_tokens=5) for p in prompts]
                eng.run()
                streams.append([h.out for h in hs])
        assert streams[0] == streams[1], cls.__name__


def test_expert_weight_tamper_is_fail_stop(model):
    """A flipped word in an enciphered line of a stacked expert leaf stops
    a verified engine at the weight sweep, before any token."""
    _, cfg_t, _, pt = model
    eng = ServeEngine(cfg_t, pt, batch_slots=8, seal=SealConfig(),
                      verify=True, device="cpu", **KW)
    st = eng.sealed.tensors["blocks/0/mlp/wi"]
    assert st.meta.layout == "lines"
    line = int(torch.nonzero(st.payload[:, 33] & 1)[-1])   # enciphered
    st.payload[line, 7] ^= 1 << 9
    reqs = [eng.submit(p, max_tokens=4)
            for p in _prompts(cfg_t.vocab_size)[:3]]
    with pytest.raises(SealedIntegrityError) as err:
        eng.step()
    assert err.value.scope == "weights"
    assert all(r.out == [] for r in reqs) and eng.stats["tokens"] == 0
    st.payload[line, 7] ^= 1 << 9
    assert len(eng.run()) == 3


def _stats(out: str) -> dict:
    return ast.literal_eval(out.split("stats=", 1)[1].splitlines()[0])


LAUNCH = ["--arch", "qwen3_moe_30b_a3b", "--slots", "8", "--verify",
          "--requests", "6", "--max-tokens", "6", "--stagger", "1",
          "--check"]


def test_launcher_line_matches_reference(capsys, monkeypatch):
    """``--arch qwen3_moe_30b_a3b --slots 8 --verify`` (ColoE, SE 0.5) on
    the port's launcher with ``--device cpu`` exits 0 with the reference
    launcher's scheduler stats on the same line, which the weights do not
    change. The reference serves plaintext weights over the verified sealed
    cache (``--seal none --seal-cache on``; its fused ColoE graphs compile
    for minutes on the CPU): the same trace and cache checks, and the
    port's one weight sweep on top."""
    from repro.launch import serve as JLS
    assert LS.main(["--device", "cpu"] + LAUNCH) == 0
    out = capsys.readouterr().out
    assert "[continuous] completed 6/6 requests" in out
    got = _stats(out)
    monkeypatch.setattr(sys, "argv", ["serve"] + LAUNCH + [
        "--seal", "none", "--seal-cache", "on"])
    JLS.main()
    want = _stats(capsys.readouterr().out)
    for key in SCHED:
        extra = 1 if key == "mac_checks" else 0
        assert got[key] == want[key] + extra, key
    assert got["fused_matmul_leaves"] == 5 and got["mac_checks"] > 1
    # admit width 2: fewer chunk rows than twice the dispatches means padding
    assert got["prefill_chunks"] < 2 * got["prefills"]
    assert LS.main(["--device", "cpu", "--arch", "dbrx_132b", "--engine",
                    "group", "--check"]) == 0
    assert "[group] completed 8/8" in capsys.readouterr().out
