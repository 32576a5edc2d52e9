"""The RG-LRU and SSD families' sealed weights in the port
(``core/sealed_store.py``: the recurrent projections take the line layout,
with SE row masks, and ``serving_params`` unseals them each dispatch) held
against the JAX package on the CPU, on the reference's weights of the
reduced ``recurrentgemma_9b`` and ``mamba2_130m``; and a verifying group
engine stopping at a flipped recurrent word.

Ciphertext, counters, flags and masks compare bitwise, unsealed weights bit
for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro_torch.config import SealConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import sealed_store as TSS
from repro_torch.core.mac import SealedIntegrityError
from repro_torch.serve.engine import GroupServeEngine
from repro_torch.tree import flatten_with_path
from test_torch_store import check_sealed_image

ARCHS = ("recurrentgemma_9b", "mamba2_130m")
KEY = bytes(range(32))
# each recurrent family's line-sealed projections
REC_LEAVES = {"recurrentgemma_9b": ("rec", ("w_x", "w_gate", "w_rg", "w_ig",
                                            "w_out")),
              "mamba2_130m": ("ssd", ("w_in", "w_out"))}


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


def _model(arch):
    """The reduced config in f32 and its reference params in the port's
    tree."""
    cfg_t = get_reduced(arch).with_(dtype="float32")
    pj = JT.init_params(jget_reduced(arch).with_(dtype="float32"),
                        jax.random.key(7))
    return cfg_t, params_from_numpy(jax.tree.map(np.asarray, pj))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


def _prompts(vocab, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n) for n in (5, 12, 9)]


@pytest.fixture(scope="module", params=ARCHS)
def deep_params(request):
    """Three super-blocks, so that SE leaves the middle one a bypass (the
    first and last are forced fully encrypted); the reference's numbers in
    both trees."""
    arch = request.param
    cfg = jget_reduced(arch).with_(num_layers=3 * len(
        jget_reduced(arch).pattern))
    pj = JT.init_params(cfg, jax.random.key(8))
    return arch, (pj, params_from_numpy(jax.tree.map(np.asarray, pj)))


@pytest.mark.parametrize("mode", ["coloe", "direct"])
def test_sealed_image_word_for_word(deep_params, mode, monkeypatch):
    """The whole image, recurrent leaves included, equals the reference's
    word for word and unseals bit for bit (``check_sealed_image``); the
    recurrent projections take the line layout, with SE row masks."""
    arch, params = deep_params
    check_sealed_image(params, mode, 0.5, monkeypatch)
    sub, names = REC_LEAVES[arch]
    sp = TSS.seal_params(params[1], SealConfig(mode=mode), KEY)
    for name in names:
        path = f"blocks/0/{sub}/{name}"
        assert sp.tensors[path].meta.layout == "lines", path
        mask = sp.plans[path].mask
        assert mask[0].all() and mask[-1].all() and not mask[1].all(), path


def test_serving_view_unseals_recurrent_leaves(model):
    """``serving_params`` hands the blocks every recurrent leaf decrypted
    (tied embedding: the whole embedding too), equal to the params."""
    cfg_t, pt = model
    sp = TSS.seal_params(pt, SealConfig(), KEY)
    view = TSS.serving_params(sp, KEY, cfg_t.tie_embeddings)
    for (path, got), (_, want) in zip(flatten_with_path(view),
                                      flatten_with_path(pt)):
        if "/".join(path) in sp.fused_paths():
            continue
        assert isinstance(got, torch.Tensor) and torch.equal(got, want), path


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_word_tamper_is_fail_stop(arch):
    """A flipped word in an enciphered line of a recurrent projection stops
    a verifying group engine at its sweep, before any token; restored, the
    engine serves."""
    cfg_t, pt = _model(arch)
    sub, names = REC_LEAVES[arch]
    eng = GroupServeEngine(cfg_t, pt, seal=SealConfig(), verify=True,
                           batch_slots=2, max_len=40, device="cpu")
    st = eng.sealed.tensors[f"blocks/0/{sub}/{names[-1]}"]
    line = int(torch.nonzero(st.payload[:, 33] & 1)[-1])   # enciphered
    st.payload[line, 5] ^= 1 << 17
    reqs = [eng.submit(p, max_tokens=3)
            for p in _prompts(cfg_t.vocab_size)]
    with pytest.raises(SealedIntegrityError) as err:
        eng.run()
    assert err.value.scope == "weights"
    assert eng.stats["tokens"] == 0 and eng.stats["mac_failures"] == 1
    assert all(r.out == [] for r in reqs)
    st.payload[line, 5] ^= 1 << 17
    assert len(eng.run()) == 3
