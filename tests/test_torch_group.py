"""The port's one-shot prefill, contiguous-cache decode and group-drain
engine (``models/cache.py``, ``models/blocks.py`` prefill mode,
``models/transformer.py``, ``serve/engine.py::GroupServeEngine``) and its
launcher (``launch/serve.py``), held against the JAX package on the CPU.

Cross-framework checks run in f32 (XLA and PyTorch sum in different orders,
and the reference's ``_sdpa`` rounds probabilities to bf16 where the flash
contract does not): logits allclose at 1e-5 of their scale, caches allclose,
positions and greedy streams exact. Inside the port, sealed and plaintext
engines emit the same streams in bf16 exactly, as the arithmetic is the
same by construction.
"""
import ast
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import cache as JMC
from repro.models import transformer as JT
from repro.serve.engine import GroupServeEngine as JGroupServeEngine
from repro_torch.config import SealConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as LS
from repro_torch.models import cache as TMC
from repro_torch.models import transformer as T
from repro_torch.serve.engine import GroupServeEngine, ServeEngine

LENS = (5, 12, 12, 9, 16, 7)      # groups of 2: plen 12, 12, 16
KW = dict(batch_slots=2, max_len=40)


def _cfgs(variant, dtype="float32"):
    kw = dict(dtype=dtype)
    if variant == "local":        # a sliding-window layer: its ring cache
        kw.update(pattern=("attn", "local_attn"), window=6)
    return (jget_reduced("internlm2_1_8b").with_(**kw),
            get_reduced("internlm2_1_8b").with_(**kw))


@pytest.fixture(scope="module", params=["dense", "local"])
def model(request):
    cfg_j, cfg_t = _cfgs(request.param)
    pj = JT.init_params(cfg_j, jax.random.key(4))
    return cfg_j, cfg_t, pj, params_from_numpy(jax.tree.map(np.asarray, pj))


@pytest.fixture(scope="module")
def f32_dense():
    cfg_j, cfg_t = _cfgs("dense")
    pj = JT.init_params(cfg_j, jax.random.key(1))
    return cfg_j, cfg_t, pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * scale)


def _assert_cache_matches(ct, cj):
    for lt, lj in zip(ct, cj):
        assert set(lt) == set(lj)
        for key in ("k", "v"):
            assert lt[key].dtype == torch.float32
            _close(lt[key], lj[key])
        np.testing.assert_array_equal(lt["pos"].numpy(), np.asarray(lj["pos"]))


def test_model_cache_init_matches_reference(model):
    cfg_j, cfg_t, _, _ = model
    cj = JMC.model_cache_init(cfg_j, 3, 10)
    ct = TMC.model_cache_init(cfg_t, 3, 10, "cpu")
    for lt, lj in zip(ct, cj):
        for key in ("k", "v", "pos"):
            assert tuple(lt[key].shape) == lj[key].shape
            assert str(lt[key].dtype).replace("torch.", "") == \
                str(lj[key].dtype)
            np.testing.assert_array_equal(lt[key].numpy(),
                                          np.asarray(lj[key]))
    # a recurrent layer's cache is its state and conv tail, the reference's
    for kind in ("rglru", "ssd"):
        jc = JMC.block_cache_init(cfg_j, kind, 1, 4)
        tc = TMC.block_cache_init(cfg_t, kind, 1, 4)
        assert {k: tuple(t.shape) for k, t in tc.items()} == \
            {k: t.shape for k, t in jc.items()}
    with pytest.raises(ValueError):
        TMC.block_cache_init(cfg_t, "conv", 1, 4)


@pytest.mark.parametrize("cache_len", [20, 9], ids=["pad", "ring"])
def test_prefill_and_decode_steps_match_reference(model, cache_len):
    """Prefill 13 tokens into ``cache_len`` slots (padded, or the ring's
    last entries when shorter), then three greedy decode steps: logits,
    caches, positions and next tokens match the reference's."""
    cfg_j, cfg_t, pj, pt = model
    toks = np.random.RandomState(cache_len).randint(
        0, cfg_t.vocab_size, (2, 13))
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks, jnp.int32)},
                        cache_len)
    lt, ct = T.prefill(cfg_t, pt, torch.from_numpy(toks), cache_len)
    assert lt.shape == (2, cfg_t.vocab_size)
    _close(lt, lj)
    _assert_cache_matches(ct, cj)
    nxt = np.asarray(jnp.argmax(lj, -1))
    for pos in range(13, 16):
        lj, cj, tj = JT.decode_step(cfg_j, pj, cj,
                                    {"tokens": jnp.asarray(nxt[:, None])},
                                    jnp.int32(pos))
        lt, ct, tt = T.decode_step(cfg_t, pt, ct,
                                   torch.from_numpy(nxt[:, None].copy()), pos)
        _close(lt, lj)
        _assert_cache_matches(ct, cj)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        nxt = np.asarray(tj)


def _prompts(vocab, seed=0, lens=LENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n) for n in lens]


def _serve(eng, prompts):
    handles = [eng.submit(p, max_tokens=3 + i) for i, p in enumerate(prompts)]
    done = eng.run()
    assert len(done) == len(prompts) and all(h.done for h in handles)
    return [h.out for h in handles]


def test_group_streams_match_reference(f32_dense):
    """Plaintext, sealed ColoE and sealed counter engines of the port emit
    the reference plaintext group engine's greedy streams (left-padded
    groups, two group lengths), with the same stats."""
    cfg_j, cfg_t, pj, pt = f32_dense
    prompts = _prompts(cfg_t.vocab_size)
    ref = JGroupServeEngine(cfg_j, pj, seal=None, **KW)
    want = _serve(ref, prompts)
    runs = {"plaintext": GroupServeEngine(cfg_t, pt, device="cpu", **KW)}
    for mode in ("coloe", "counter"):
        runs[mode] = GroupServeEngine(cfg_t, pt, seal=SealConfig(mode=mode),
                                      device="cpu", **KW)
    for name, eng in runs.items():
        assert _serve(eng, prompts) == want, name
        assert set(eng.stats) == set(ref.stats), name
        for key in ("prefills", "decode_steps", "tokens",
                    "kv_plaintext_bytes_per_step"):
            assert eng.stats[key] == ref.stats[key], (name, key)
    assert runs["plaintext"].stats == ref.stats
    assert runs["coloe"].stats["fused_matmul_leaves"] == 8
    assert 0 < runs["coloe"].stats["weights_plaintext_bytes_per_step"] < \
        runs["plaintext"].stats["weights_plaintext_bytes_per_step"]


@pytest.mark.parametrize("mode", ["coloe", "counter"])
def test_bf16_sealed_group_streams_equal_plaintext(mode):
    cfg_j, cfg_t = _cfgs("dense", "bfloat16")
    pt = params_from_numpy(jax.tree.map(
        np.asarray, JT.init_params(cfg_j, jax.random.key(2))))
    prompts = _prompts(cfg_t.vocab_size, seed=1)
    plain = _serve(GroupServeEngine(cfg_t, pt, device="cpu", **KW), prompts)
    sealed = _serve(GroupServeEngine(cfg_t, pt, seal=SealConfig(mode=mode),
                                     device="cpu", **KW), prompts)
    assert sealed == plain


def test_one_shot_prefill_equals_chunked(f32_dense):
    """One unpadded prompt per group: the group engine (one-shot prefill,
    flash attention) and the continuous engine (chunked prefill over the
    paged view, ``_sdpa``) emit the same tokens."""
    _, cfg_t, _, pt = f32_dense
    prompts = _prompts(cfg_t.vocab_size, seed=3, lens=(11, 23, 6))
    group = GroupServeEngine(cfg_t, pt, batch_slots=1, max_len=48,
                             device="cpu")
    cont = ServeEngine(cfg_t, pt, batch_slots=2, max_len=48, chunk_tokens=8,
                       device="cpu")
    assert _serve(group, prompts) == _serve(cont, prompts)


@pytest.mark.parametrize("engine", ["group", "continuous"])
def test_launcher_serves_on_the_cpu(engine, capsys):
    rc = LS.main(["--device", "cpu", "--engine", engine, "--check",
                  "--requests", "3", "--slots", "2", "--prompt-len", "8",
                  "--max-tokens", "3", "--stagger", "1"])
    assert rc == 0
    assert f"[{engine}] completed 3/3 requests" in capsys.readouterr().out


def _stats(out: str) -> dict:
    """The ``stats={...}`` dict a launcher run printed."""
    return ast.literal_eval(out.split("stats=", 1)[1].splitlines()[0])


SMALL = ["--device", "cpu", "--requests", "3", "--slots", "2",
         "--prompt-len", "12", "--max-tokens", "6"]
PLAIN_CACHE = ["--seal", "none", "--seal-cache", "on"]


@pytest.mark.parametrize("flag,rc,effect", [
    (["--prefix-share", "--shared-prefix", "20"], 0,
     lambda st, out: st["shared_prefix_blocks"] > 0 and st["cow_copies"] > 0),
    (["--shared-prefix", "20"], 0,
     lambda st, out: st["shared_prefix_blocks"] == 0
     and st["tokens"] == 18),
    (["--expect-shared"], 1,
     lambda st, out: st["shared_prefix_blocks"] == 0),
    (["--compare-sealed"], 0,
     lambda st, out: "token streams equal" in out),
    (["--verify"] + PLAIN_CACHE, 0,
     lambda st, out: st["mac_checks"] > 0 and st["mac_failures"] == 0),
    (["--inject-tamper", "bitflip"] + PLAIN_CACHE, 0,
     lambda st, out: st["mac_failures"] == 1 and st["retries"] == 1
     and "tamper[bitflip]" in out),
], ids=lambda v: v[0] if isinstance(v, list) else "")
def test_launcher_runs_ported_flags(flag, rc, effect, capsys):
    """The flags of the prefix-sharing and integrity slices run at reduced
    size on the CPU, each with its effect on the run's stats."""
    assert LS.main(SMALL + flag) == rc
    out = capsys.readouterr().out
    assert "[continuous] completed 3/3 requests" in out
    assert effect(_stats(out), out)


@pytest.mark.parametrize("flag", [["--seal", "direct"]],
                         ids=lambda f: " ".join(f))
def test_launcher_refuses_unported_flags(flag, capsys, monkeypatch):
    """No flag is refused any more: ``--seal direct``, the last one that
    was, serves through the Direct engine, and the run's stats equal the
    reference launcher's on the same line (the weight-independent ones, as
    in ``test_reference_ci_command_lines``, and the plaintext bytes: the
    whole image, every leaf decrypted each dispatch)."""
    from repro.launch import serve as JLS
    argv = SMALL[2:] + flag + ["--check"]
    assert LS.main(["--device", "cpu"] + argv) == 0
    out = capsys.readouterr()
    assert "[continuous] completed 3/3 requests" in out.out and not out.err
    got = _stats(out.out)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    JLS.main()
    want = _stats(capsys.readouterr().out)
    for key in ("prefills", "prefill_chunks", "decode_steps", "tokens",
                "fused_matmul_leaves", "weights_plaintext_bytes_per_step",
                "kv_plaintext_bytes_per_step"):
        assert got[key] == want[key], key
    assert got["fused_matmul_leaves"] == 0


SAMPLED = ["--arch", "internlm2_1_8b", "--requests", "4", "--slots", "2",
           "--prompt-len", "12", "--max-tokens", "6", "--stagger", "1",
           "--seal", "none", "--seal-cache", "on", "--check"]

# the reference's CI command lines (.github/workflows/ci.yml): serve-smoke's
# prefix sharing + chunked prefill line at 8 slots and 6 requests, and
# tamper-smoke's four fault classes; then the lines of the sampling and
# weight-integrity slices: each sampling knob on a staggered trace, and
# verification over sealed weights with the cache's tamper kinds
CI_LINES = {
    "temperature": SAMPLED + ["--temperature", "0.7"],
    "top-k": SAMPLED + ["--temperature", "1.0", "--top-k", "5"],
    "top-p": SAMPLED + ["--temperature", "0.9", "--top-p", "0.9"],
    "verify-sealed-weights": [
        "--arch", "internlm2_1_8b", "--requests", "3", "--slots", "2",
        "--prompt-len", "20", "--max-tokens", "6", "--seal", "coloe",
        "--verify", "--inject-tamper", "bitflip", "--temperature", "0.8",
        "--check"],
    "serve-smoke": ["--arch", "internlm2_1_8b", "--requests", "6",
                    "--slots", "8", "--prompt-len", "12", "--max-tokens",
                    "6", "--stagger", "1", "--seal", "none", "--seal-cache",
                    "on", "--prefix-share", "--chunked-prefill",
                    "--shared-prefix", "24", "--expect-shared",
                    "--compare-sealed", "--check"],
    "tamper-smoke": ["--arch", "internlm2_1_8b", "--requests", "4",
                     "--slots", "2", "--prompt-len", "20", "--max-tokens",
                     "10", "--seal", "none", "--seal-cache", "on",
                     "--verify", "--inject-tamper",
                     "bitflip,replay,rollback,relocate", "--check"],
}


@pytest.mark.parametrize("name", sorted(CI_LINES))
def test_reference_ci_command_lines(name, capsys, monkeypatch):
    """The reference's CI command lines run through the port's launcher
    (``--device cpu``) and exit 0; the scheduler's stats equal the reference
    launcher's on the same line (the prompts are the same numpy draws; the
    weights differ, and no stat compared here depends on them). The
    verified sealed-weights line runs the reference with ``--seal direct``,
    the engine its own tests verify sealed weights with (its fused ColoE
    graphs compile for many minutes on the CPU): the same trace, one weight
    sweep, the same stats."""
    from repro.launch import serve as JLS
    argv = CI_LINES[name]
    assert LS.main(["--device", "cpu"] + argv) == 0
    got = _stats(capsys.readouterr().out)
    if "--verify" in argv and "coloe" in argv:
        argv = [("direct" if a == "coloe" else a) for a in argv]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    JLS.main()                         # exits non-zero on a failed check
    want = _stats(capsys.readouterr().out)
    for key in ("prefills", "prefill_chunks", "decode_steps", "tokens",
                "cow_copies", "mac_checks", "mac_failures", "retries",
                "shared_prefix_blocks", "shared_prefix_tokens",
                "kv_plaintext_bytes_per_step"):
        assert got[key] == want[key], (name, key)
