"""The port's Direct engine end to end (``seal_params`` with
``SealConfig(mode="direct")``, ``verify_params``, the serving views, and
``ServeEngine`` / ``GroupServeEngine`` over Direct-sealed weights) held
against the JAX package on the CPU.

Tolerances: none. The sealed image (payload, flags, masks, metadata, stored
bytes, tags) compares bitwise and the unsealed params bit for bit; token
streams and stats exactly, in f32 (XLA and PyTorch sum in different orders,
so bf16 roundings could flip a near-tied argmax between the two
frameworks). Inside the port, Direct and plaintext serve the same weights
through the same arithmetic, so their streams are equal in bf16 too.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import SealConfig as JSealConfig
from repro.configs import get_reduced as jget_reduced
from repro.core import sealed_store as JSS
from repro.models import transformer as JT
from repro.serve.engine import GroupServeEngine as JGroupServeEngine
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import u32
from repro_torch.config import SealConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import sealed_store as TSS
from repro_torch.core.mac import SealedIntegrityError
from repro_torch.core.sealed_tensor import SealedTensor
from repro_torch.kernels import ops
from repro_torch.serve.engine import GroupServeEngine, ServeEngine
from repro_torch.tree import flatten_with_path
from test_torch_store import check_sealed_image

KEY = bytes(range(32))
DIRECT = dict(mode="direct", smart_ratio=0.5)


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_chacha():
    """The reference's MAC pads use its ``fori_loop`` ChaCha, which
    recompiles at every eager call; the same function under ``jax.jit`` is
    cached per shape. Integer-only, so the reference's words are
    unchanged."""
    from repro.core import cipher as JC
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "chacha20_block", jax.jit(JC.chacha20_block))
        yield


@pytest.fixture(scope="module")
def params():
    """Reduced internlm2 of four layers (at two, the boundary layers are
    forced fully encrypted and no leaf has an SE bypass line), from the
    reference, and the same numbers in the port's tree."""
    cfg = jget_reduced("internlm2_1_8b").with_(num_layers=4)
    pj = JT.init_params(cfg, jax.random.key(0))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj))


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_direct_image_word_for_word(params, ratio, monkeypatch):
    """Every leaf in lines (no fused leaf), payloads, flags, masks, meta and
    stored bytes equal to the reference's, and the unsealed params bit for
    bit (``check_sealed_image``)."""
    check_sealed_image(params, "direct", ratio, monkeypatch)
    _, pt = params
    sp = TSS.seal_params(pt, SealConfig(mode="direct", smart_ratio=ratio),
                         KEY)
    assert sp.fused_paths() == []
    for path, st in sp.tensors.items():
        m = st.meta
        assert (m.scheme, m.layout, m.nonce) == ("direct", "lines", (0, 0))
        assert st.payload.shape == (st.counters.shape[0], 32), path
    flags = torch.cat([st.counters for st in sp.tensors.values()])
    assert bool((flags == 1).any()) and \
        bool((flags == 0).any()) == (ratio < 1)


def test_direct_serving_view_is_the_whole_image(params):
    """Direct's AES lines have no row gather: the serving view decrypts
    every leaf, the embedding too, one AES launch a leaf, and counts the
    whole image as the reference's ``plaintext_bytes_materialized``."""
    pj, pt = params
    spj = JSS.seal_params(pj, JSealConfig(**DIRECT), KEY)
    spt = TSS.seal_params(pt, SealConfig(**DIRECT), KEY)
    ops.reset_launch_counts()
    view = TSS.serving_params(spt, KEY)
    assert ops.launch_counts()["aes128_lines_decrypt"] == 0   # on the CPU
    for (p, a), (_, b) in zip(flatten_with_path(view),
                              flatten_with_path(pt)):
        assert not isinstance(a, SealedTensor) and torch.equal(a, b), p
    assert spt.serving_plaintext_bytes(4, torch.float32) == \
        spt.plaintext_bytes_materialized() == \
        spj.plaintext_bytes_materialized()


@pytest.fixture(scope="module")
def image(params):
    pj, pt = params
    return (JSS.seal_params(pj, JSealConfig(**DIRECT, verify=True), KEY),
            TSS.seal_params(pt, SealConfig(**DIRECT, verify=True), KEY))


def test_direct_verify_params_like_the_reference(image):
    """Tags bitwise the reference's; ``verify_params`` False after one
    flipped bit in an enciphered line, in a bypass line and in a flag word
    (line tags cover every stored record), each verdict the reference's;
    True once restored."""
    import jax.numpy as jnp
    spj, spt = image
    for path, stj in spj.tensors.items():
        np.testing.assert_array_equal(u32.to_numpy(spt.tensors[path].macs),
                                      np.asarray(stj.macs), err_msg=path)
    assert TSS.n_macs(spt) == JSS.n_macs(spj) > 0
    assert bool(TSS.verify_params(spt, KEY))
    wi = spt.tensors["blocks/0/mlp/wi"].counters
    enc, byp = int(torch.nonzero(wi == 1)[0]), int(torch.nonzero(wi == 0)[0])
    for what, path, field, index in (
            ("enciphered line", "blocks/0/mlp/wi", "payload", 32 * enc + 5),
            ("bypass line", "blocks/0/mlp/wi", "payload", 32 * byp + 7),
            ("flag word", "blocks/0/mlp/wi", "counters", byp),
            ("embedding line", "embed/w", "payload", 40)):
        stt, stj = spt.tensors[path], spj.tensors[path]
        getattr(stt, field).view(-1)[index] ^= 1 << 4
        arr = np.array(getattr(stj, field))
        arr.reshape(-1)[index] ^= np.uint32(1 << 4)
        setattr(stj, field, jnp.asarray(arr))
        got = bool(TSS.verify_params(spt, KEY))
        assert not got and got == bool(JSS.verify_params(spj, KEY)), what
        getattr(stt, field).view(-1)[index] ^= 1 << 4
        arr.reshape(-1)[index] ^= np.uint32(1 << 4)
        setattr(stj, field, jnp.asarray(arr))
        assert bool(TSS.verify_params(spt, KEY)), what


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

PROMPT_LENS = (11, 7, 9)
MAX_TOK = 8
STATS = ("prefills", "prefill_chunks", "decode_steps", "tokens",
         "mac_checks", "mac_failures", "retries", "fused_matmul_leaves",
         "weights_plaintext_bytes_per_step", "kv_plaintext_bytes_per_step")


@pytest.fixture(scope="module")
def model():
    cfg_j = jget_reduced("internlm2_1_8b").with_(dtype="float32")
    cfg_t = get_reduced("internlm2_1_8b").with_(dtype="float32")
    pj = JT.init_params(cfg_j, jax.random.key(3))
    return cfg_j, cfg_t, pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def _prompts(vocab):
    rng = np.random.RandomState(11)
    return [rng.randint(1, vocab, (n,)).astype(np.int32) for n in PROMPT_LENS]


def _serve(cls, cfg, params, seal, **kw):
    dev = {} if cls in (JServeEngine, JGroupServeEngine) else {"device": "cpu"}
    eng = cls(cfg, params, batch_slots=2, max_len=48, seal=seal, **dev, **kw)
    reqs = [eng.submit(p, max_tokens=MAX_TOK)
            for p in _prompts(cfg.vocab_size)]
    eng.run()
    assert all(r.done and len(r.out) == MAX_TOK for r in reqs)
    return eng, [r.out for r in reqs]


@pytest.fixture(scope="module")
def reference_direct(model):
    """The reference's Direct engine on the sealed cache, verified."""
    cfg_j, _, pj, _ = model
    return _serve(JServeEngine, cfg_j, pj, JSealConfig(**DIRECT),
                  seal_cache=True, verify=True)


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("seal_cache", [True, False])
def test_direct_serve_engine_matches_reference(model, reference_direct,
                                               verify, seal_cache):
    """``ServeEngine(seal=direct)`` with and without a sealed cache and
    ``verify``: the reference Direct engine's tokens and the port's
    plaintext tokens; with both on, the reference's stats (one weight sweep
    counted beside the cache's checks, as the reference counts it)."""
    cfg_j, cfg_t, pj, pt = model
    ref, want = reference_direct
    eng, got = _serve(ServeEngine, cfg_t, pt, SealConfig(**DIRECT),
                      seal_cache=seal_cache, verify=verify)
    _, plain = _serve(ServeEngine, cfg_t, pt, None)
    assert got == want == plain
    assert eng.seal_cache == seal_cache and eng.seal.verify == verify
    assert eng.stats["fused_matmul_leaves"] == 0
    assert eng.stats["weights_plaintext_bytes_per_step"] == \
        eng.sealed.plaintext_bytes_materialized()
    if verify and seal_cache:
        for key in STATS:
            assert eng.stats[key] == ref.stats[key], key
    assert eng.stats["mac_failures"] == 0 and eng.stats["retries"] == 0


@pytest.mark.parametrize("field", ["payload", "counters"])
def test_direct_weight_tamper_is_fail_stop(model, field):
    """A flipped bit in a Direct line or in its flag word stops the
    verified engine at its sweep, before any token; restored, it serves."""
    _, cfg_t, _, pt = model
    eng = ServeEngine(cfg_t, pt, batch_slots=2, max_len=48,
                      seal=SealConfig(**DIRECT), verify=True, device="cpu")
    word = getattr(eng.sealed.tensors["blocks/0/mlp/wi"], field).view(-1)
    word[3] ^= 1 << 20
    reqs = [eng.submit(p, max_tokens=4) for p in _prompts(cfg_t.vocab_size)]
    with pytest.raises(SealedIntegrityError) as err:
        eng.run()
    assert err.value.scope == "weights" and eng.stats["tokens"] == 0
    assert all(r.out == [] for r in reqs)
    word[3] ^= 1 << 20
    assert len(eng.run()) == 3


def test_direct_group_engine_matches_reference(model):
    """``GroupServeEngine(seal=direct)``: the reference group engine's
    tokens and stats, and the port's plaintext tokens. The reference's
    plaintext run stands for its Direct one (whose AES graphs take half a
    minute to compile here): Direct decrypts every leaf exactly before use
    and materializes the whole image, so the two runs' streams and stats
    are the same by construction, as ``test_direct_serve_engine_matches_
    reference`` shows for the continuous engine."""
    cfg_j, cfg_t, pj, pt = model
    ref, want = _serve(JGroupServeEngine, cfg_j, pj, None)
    eng, got = _serve(GroupServeEngine, cfg_t, pt, SealConfig(**DIRECT))
    _, plain = _serve(GroupServeEngine, cfg_t, pt, None)
    assert got == want == plain
    assert eng.stats == ref.stats


def test_bf16_direct_streams_equal_plaintext():
    """In bf16 the Direct view is the plaintext weights bit for bit, so the
    streams are the plaintext engine's exactly."""
    cfg = get_reduced("internlm2_1_8b")
    from repro_torch.models import transformer as T
    pt = T.init_params(cfg, seed=1, device="cpu")
    _, plain = _serve(ServeEngine, cfg, pt, None)
    _, direct = _serve(ServeEngine, cfg, pt, SealConfig(**DIRECT))
    assert direct == plain
