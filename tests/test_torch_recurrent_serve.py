"""Serving the RG-LRU and SSD families in the port (``GroupServeEngine``,
``ServeEngine``'s refusal, the plaintext engine's rounded leaves, the
launcher) held against the JAX package on the CPU, at the reduced
``recurrentgemma_9b`` and ``mamba2_130m`` on the reference's weights.

The reference serves these families only through its group engine. Its
sealed ColoE group run of RecurrentGemma compiles fused Pallas graphs in
interpret mode for over a minute, so the streams are held to the
reference's **plaintext** engine: sealed serving equals plaintext serving
(ROADMAP, reference invariants), and the tile leaves' kernels are held to
the reference elsewhere. The reference's sealed engines are still built
(sealing is eager and cheap) so that their stats, which are fixed at
construction, compare in full. Greedy streams and stats compare exactly in
f32; in bf16 sealed against plaintext inside the port.
"""
import ast
import sys

import jax
import numpy as np
import pytest
import torch

from repro.config import SealConfig as JSealConfig
from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro.serve.engine import GroupServeEngine as JGroupServeEngine
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config import SealConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as LS
from repro_torch.models import transformer as T
from repro_torch.serve import engine as EM
from repro_torch.serve.engine import GroupServeEngine, ServeEngine
from repro_torch.tree import flatten_with_path

ARCHS = ("recurrentgemma_9b", "mamba2_130m")
LENS = (5, 12, 12, 9, 16, 7)      # groups of 2: plen 12, 12, 16
KW = dict(batch_slots=2, max_len=40)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: intra-op threads only contend under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_chacha():
    """The reference seals eagerly, and its ``fori_loop`` ChaCha recompiles
    at every call; the same function under ``jax.jit`` is cached per shape.
    Integer-only, so the reference's words are unchanged."""
    from repro.core import cipher as JC
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "chacha20_block", jax.jit(JC.chacha20_block))
        yield


_MODELS = {}


def _model(arch, dtype="float32"):
    key = (arch, dtype)
    if key not in _MODELS:
        cfg_j = jget_reduced(arch).with_(dtype=dtype)
        cfg_t = get_reduced(arch).with_(dtype=dtype)
        pj = JT.init_params(cfg_j, jax.random.key(7))
        _MODELS[key] = (cfg_j, cfg_t, pj,
                        params_from_numpy(jax.tree.map(np.asarray, pj)))
    return _MODELS[key]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


def _prompts(vocab, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n) for n in LENS]


def _serve_group(eng, prompts):
    hs = [eng.submit(p, max_tokens=3 + i) for i, p in enumerate(prompts)]
    eng.run()
    assert all(h.done for h in hs)
    return [h.out for h in hs]


_REFERENCE = {}


def _reference(arch):
    """The reference's plaintext group run (streams, stats), once."""
    if arch not in _REFERENCE:
        cfg_j, cfg_t, pj, _ = _model(arch)
        eng = JGroupServeEngine(cfg_j, pj, seal=None, **KW)
        _REFERENCE[arch] = (_serve_group(eng, _prompts(cfg_t.vocab_size)),
                            eng.stats)
    return _REFERENCE[arch]


SEALS = {"plaintext": None, "coloe": "coloe", "counter": "counter",
         "direct": "direct", "verified": "coloe"}

_SEALED_STATS = {}


def _reference_stats(arch, mode):
    """The reference's group-engine stats under ``mode``; they are fixed at
    construction (sealing is eager), so no sealed run is needed. Counter
    takes ColoE's (the two share every leaf's layout: ``tile_geometry``
    admits both), and Direct the plaintext engine's (every leaf a decrypted
    line leaf: the whole image as plaintext bytes a step, no fused leaf;
    ``test_torch_direct.py`` holds this for the reference's own Direct
    engine)."""
    if mode is None or mode == "direct":
        return _reference(arch)[1]
    if arch not in _SEALED_STATS:
        cfg_j, _, pj, _ = _model(arch)
        _SEALED_STATS[arch] = JGroupServeEngine(
            cfg_j, pj, seal=JSealConfig(), **KW).stats
    return _SEALED_STATS[arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("run", list(SEALS))
def test_group_streams_and_stats_match_reference(arch, run):
    """Plaintext, ColoE, Counter, Direct and verified ColoE weights: the
    reference plaintext engine's streams, and every stat of the reference's
    engine under the same seal (its ``kv_plaintext_bytes_per_step`` counts
    each pattern position as an attention layer of ``max_len`` slots, as
    the port keeps; a verifying engine adds its sweep's ``mac_checks``)."""
    cfg_j, cfg_t, pj, pt = _model(arch)
    want, plain_stats = _reference(arch)
    mode = SEALS[run]
    eng = GroupServeEngine(cfg_t, pt, seal=mode and SealConfig(mode=mode),
                           verify=run == "verified", device="cpu", **KW)
    assert _serve_group(eng, _prompts(cfg_t.vocab_size)) == want
    got = dict(eng.stats)
    if run == "verified":
        assert (got.pop("mac_checks"), got.pop("mac_failures")) == (1, 0)
    assert got == dict(_reference_stats(arch, mode),
                       prefills=plain_stats["prefills"],
                       decode_steps=plain_stats["decode_steps"],
                       tokens=plain_stats["tokens"])
    # RecurrentGemma: 4 attention and 9 MLP leaves; Mamba2 has none
    assert got["fused_matmul_leaves"] == (
        {"recurrentgemma_9b": 13, "mamba2_130m": 0}[arch]
        if mode in ("coloe", "counter") else 0)


def test_kv_plaintext_bytes_are_the_references():
    """The reference's formula for recurrent patterns, kept: at max_len 32,
    RecurrentGemma-reduced reports 3 positions of 32 slots (2 of them
    RG-LRU layers, the window ignored), Mamba2 none (head_dim 0)."""
    for arch, want in (("recurrentgemma_9b", 24_576), ("mamba2_130m", 0)):
        cfg_j, cfg_t, pj, pt = _model(arch)
        eng = GroupServeEngine(cfg_t, pt, batch_slots=2, max_len=32,
                               device="cpu")
        ref = JGroupServeEngine(cfg_j, pj, batch_slots=2, max_len=32)
        assert eng.stats["kv_plaintext_bytes_per_step"] == want == \
            ref.stats["kv_plaintext_bytes_per_step"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_refuses_as_the_reference(arch):
    cfg_j, cfg_t, pj, pt = _model(arch)
    with pytest.raises(ValueError) as ref:
        JServeEngine(cfg_j, pj)
    with pytest.raises(ValueError) as mine:
        ServeEngine(cfg_t, pt, device="cpu")
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_rounded_leaves_keep_f32_results(arch):
    """The plaintext engine stores the leaves in ``_ROUNDED_LEAVES`` in the
    compute dtype and the rest (``lam``, ``A_log``, ``D``, ``dt_bias``,
    ``norm_scale``, the norms) in f32: prefill and decode logits and caches
    are bit for bit those of the all-f32 tree."""
    cfg_j, cfg_t, pj, pt = _model(arch)
    cfg = cfg_t.with_(dtype="bfloat16")
    plain = EM._plain_weights(cfg, pt)
    for path, t in flatten_with_path(plain):
        want = torch.bfloat16 if path[-1] in EM._ROUNDED_LEAVES else \
            torch.float32
        assert t.dtype == want, path
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 9)))
    outs = []
    for p in (pt, plain):
        logits, cache = T.prefill(cfg, p, toks, 16)
        step, cache, _ = T.decode_step(cfg, p, cache, toks[:, :1], 9)
        outs.append((logits, step, cache))
    (l0, s0, c0), (l1, s1, c1) = outs
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    for a, b in zip(c0, c1):
        for key in a:
            assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_sealed_streams_equal_plaintext(arch):
    """In bf16, ColoE and Direct group engines emit the plaintext engine's
    streams: the line leaves decrypt exactly, the fused leaves compute
    the plaintext products."""
    _, cfg_t, _, pt = _model(arch, "bfloat16")
    prompts = _prompts(cfg_t.vocab_size, seed=3)
    streams = [_serve_group(GroupServeEngine(
        cfg_t, pt, seal=seal, device="cpu", **KW), prompts)
        for seal in (None, SealConfig(), SealConfig(mode="direct"))]
    assert streams[0] == streams[1] == streams[2]


def _stats(out: str) -> dict:
    return ast.literal_eval(out.split("stats=", 1)[1].splitlines()[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_line_matches_reference(arch, capsys, monkeypatch):
    """``--arch <arch> --verify --check`` (engine auto, ColoE) on the
    port's launcher picks the group engine, as the reference's does, and
    exits 0 with the reference launcher's scheduler stats on the same line
    (the reference run plaintext: its fused ColoE graphs compile for over a
    minute here), plus the port's one weight sweep, printed on the line; with
nothing sealed, ``--verify`` fails with exit code 2."""
    from repro.launch import serve as JLS
    line = ["--arch", arch, "--requests", "4", "--max-tokens", "5",
            "--check"]
    assert LS.main(["--device", "cpu", "--verify"] + line) == 0
    out = capsys.readouterr().out
    assert "[group] completed 4/4 requests" in out
    assert " mac_checks=1 mac_failures=0 " in out
    got = _stats(out)
    monkeypatch.setattr(sys, "argv", ["serve"] + line + ["--seal", "none"])
    JLS.main()
    jout = capsys.readouterr().out
    assert "[group] completed 4/4 requests" in jout
    want = _stats(jout)
    for key in ("prefills", "decode_steps", "tokens",
                "kv_plaintext_bytes_per_step"):
        assert got[key] == want[key], key
    assert (got["mac_checks"], got["mac_failures"]) == (1, 0)
    assert LS.main(["--device", "cpu", "--seal", "direct"] + line) == 0
    assert "[group] completed 4/4" in capsys.readouterr().out
    with pytest.raises(SystemExit) as stop:     # nothing to verify
        LS.main(["--device", "cpu", "--seal", "none", "--verify"] + line)
    assert stop.value.code == 2
    assert "FAIL: --verify needs sealed weights" in capsys.readouterr().err
