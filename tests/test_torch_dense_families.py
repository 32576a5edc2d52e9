"""The remaining dense token architectures in the port (``configs/``
``granite_3_2b``, ``deepseek_coder_33b``, ``gemma2_2b``) held against the
JAX package on the CPU, at their reduced configs on the reference's
weights: the registry, the one-shot prefill and decode, and the
launcher's line (``test_torch_dense_serve.py`` has the continuous engine).
They need no model code of their own; what they
exercise is tied embeddings (granite, gemma2), the sliding window with its
ring cache, attention and logit softcaps and gelu (gemma2), and zero-padded
query heads (deepseek with ``pad_heads_to``).

Logits compare in f32 at 1e-5 of their scale (XLA and PyTorch sum in
different orders); next tokens, cache positions and the launcher's
scheduler stats exactly.
"""
import ast
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as LS
from repro_torch.models import transformer as T

# (arch, config changes): deepseek also with query heads padded 4 -> 6
CASES = {"granite_3_2b": {}, "deepseek_coder_33b": {},
         "deepseek_pad6": {"pad_heads_to": 6}, "gemma2_2b": {}}
SCHED = ("prefills", "prefill_chunks", "decode_steps", "tokens",
         "cow_copies", "mac_checks", "mac_failures", "retries",
         "kv_plaintext_bytes_per_step")
NEW = ("granite_3_2b", "deepseek_coder_33b", "gemma2_2b",
       "recurrentgemma_9b", "mamba2_130m")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: intra-op threads only contend under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arch(case):
    return "deepseek_coder_33b" if case == "deepseek_pad6" else case


_MODELS = {}


def _model(case):
    """(cfg_j, cfg_t, params_j, params_t) in f32, the reference's weights
    in both packages; built once a module."""
    if case not in _MODELS:
        kw = dict(CASES[case], dtype="float32")
        cfg_j = JC.get_reduced(_arch(case)).with_(**kw)
        cfg_t = TC.get_reduced(_arch(case)).with_(**kw)
        pj = JT.init_params(cfg_j, jax.random.key(9))
        _MODELS[case] = (cfg_j, cfg_t, pj,
                         params_from_numpy(jax.tree.map(np.asarray, pj)))
    return _MODELS[case]


@pytest.fixture(scope="module", params=list(CASES))
def model(request):
    return _model(request.param)


def test_registry_holds_the_served_architectures_in_order():
    """The reference's token architectures in the reference's order; the
    served ones are every one but the two frontend-stub configs, which are
    only trained."""
    served = [a for a in JC.ARCH_IDS
              if JC.get_config(a).frontend is None]
    assert TC.ARCH_IDS == JC.ARCH_IDS
    assert [a for a in TC.ARCH_IDS
            if TC.get_config(a).frontend is None] == served
    for arch in TC.ARCH_IDS:
        assert TC.get_config(arch.replace("_", "-")) == TC.get_config(arch)


@pytest.mark.parametrize("arch", NEW)
def test_configs_match_reference(arch):
    """``config()`` and ``reduced()`` field for field, and the SSM
    properties."""
    for fn in ("get_config", "get_reduced"):
        mine, ref = getattr(TC, fn)(arch), getattr(JC, fn)(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref), fn
        assert (mine.ssm_d_inner, mine.ssm_heads, mine.heads_eff) == \
            (ref.ssm_d_inner, ref.ssm_heads, ref.heads_eff)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float64)
    got = got.double().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, err


@pytest.mark.parametrize("plen,cache_len", [(13, 48), (40, 48)],
                         ids=["short", "past-window"])
def test_prefill_and_decode_steps_match_reference(model, plen, cache_len):
    """Prefill, then 6 greedy decode steps: logits, next tokens and every
    cache leaf against the reference's. At 40 tokens gemma2's local layer
    (window 32) holds a wrapped ring."""
    cfg_j, cfg_t, pj, pt = model
    toks = np.random.RandomState(plen).randint(0, cfg_t.vocab_size,
                                               (2, plen))
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks, jnp.int32)},
                        cache_len)
    lt, ct = T.prefill(cfg_t, pt, torch.from_numpy(toks), cache_len)
    _close(lt, lj)
    for step in range(6):
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)[:, None]
        lj, cj, nj = JT.decode_step(cfg_j, pj, cj,
                                    {"tokens": jnp.asarray(tok)}, plen + step)
        lt, ct, nt = T.decode_step(cfg_t, pt, ct, torch.from_numpy(tok),
                                   plen + step)
        _close(lt, lj)
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    for a, b in zip(ct, cj):
        for key in ("k", "v"):
            _close(a[key], b[key])
        np.testing.assert_array_equal(a["pos"].numpy(), np.asarray(b["pos"]))


def _stats(out: str) -> dict:
    return ast.literal_eval(out.split("stats=", 1)[1].splitlines()[0])


@pytest.mark.parametrize("arch", ["granite_3_2b", "deepseek_coder_33b",
                                  "gemma2_2b"])
def test_launcher_line_matches_reference(arch, capsys, monkeypatch):
    """``--arch <arch> --stagger 1 --check`` (engine auto: continuous;
    ColoE, sealed cache) on the port's launcher exits 0 with the reference
    launcher's scheduler stats on the same line, run plaintext over a
    sealed cache (``--seal none --seal-cache on``: its fused ColoE graphs
    compile for minutes here)."""
    from repro.launch import serve as JLS
    line = ["--arch", arch, "--requests", "4", "--max-tokens", "5",
            "--stagger", "1", "--check"]
    assert LS.main(["--device", "cpu"] + line) == 0
    out = capsys.readouterr().out
    assert "[continuous] completed 4/4 requests" in out
    got = _stats(out)
    monkeypatch.setattr(sys, "argv", ["serve"] + line + [
        "--seal", "none", "--seal-cache", "on"])
    JLS.main()
    want = _stats(capsys.readouterr().out)
    for key in SCHED:
        assert got[key] == want[key], key
