"""The port's MoE layers and their sealing (``configs/qwen3_moe_30b_a3b.py``,
``configs/dbrx_132b.py``, the MoE leaves of ``models/transformer.py::
init_params``, ``models/layers.py`` ``moe_router``/``moe_apply_dense``/
``moe_apply``/``capacity_slots``, the MoE branch of ``models/blocks.py``,
SE masks and line images of the 4-D expert leaves) held against the JAX
package on the CPU, at the reduced configs, on the reference's weights.

Tolerances: routes (expert indices, the capacity-kept set, slots) exactly;
gate values and the aux loss at 1e-6, MoE outputs at 1e-5 of their scale,
logits at 1e-5 (f32: XLA and PyTorch sum in different orders). Masks,
ciphertext and counters bitwise.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SealConfig as JSealConfig
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.core import plan as JP
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import u32
from repro_torch.config import SealConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import engine as TE
from repro_torch.core import plan as TP
from repro_torch.core import sealed_store as TSS
from repro_torch.kernels import chacha20 as CC
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import flatten_with_path
from test_torch_store import _masks_with_ties, check_sealed_image

ARCHS = ("qwen3_moe_30b_a3b", "dbrx_132b")
KEY = bytes(range(32))
EXPERT_LEAVES = ("router", "wi", "wg", "wo")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These reduced models gain nothing from intra-op threads, and under
    pytest-xdist each worker's threads contend with every other worker's:
    one thread while this module runs."""
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


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(cfg_j, cfg_t, params_j, params_t): the reduced config in f32 and the
    reference's weights in both packages."""
    cfg_j = jget_reduced(request.param).with_(dtype="float32")
    cfg_t = get_reduced(request.param).with_(dtype="float32")
    pj = JT.init_params(cfg_j, jax.random.key(0))
    return cfg_j, cfg_t, pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def _mlp(model, layer=0):
    _, _, pj, pt = model
    return (jax.tree.map(lambda a: a[layer], pj["blocks"][0]["mlp"]),
            {k: v[layer] for k, v in pt["blocks"][0]["mlp"].items()})


def _x(cfg, b, s, seed=0):
    return np.random.RandomState(seed).randn(b, s, cfg.d_model).astype(
        np.float32)


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * scale)


# --------------------------------------------------------------------------
# configs and params
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for jget, tget in ((jget_config, get_config),
                       (jget_reduced, get_reduced)):
        cj, ct = jget(arch), tget(arch)
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        assert ct.moe.capacity_factor == 1.25
        assert ct.moe.aux_loss_weight == 0.01


def test_init_params_tree_matches_reference(model):
    """``init_params`` makes the reference's paths and shapes (router
    (n, d, e), wi/wg (n, e, d, f), wo (n, e, f, d)) at its scales."""
    cfg_j, cfg_t, pj, _ = model
    mine = T.init_params(cfg_t, seed=0, device="cpu")
    want = [("/".join(JP._path_tuple(k)), tuple(v.shape))
            for k, v in jax.tree_util.tree_flatten_with_path(pj)[0]]
    got = [("/".join(p), tuple(v.shape)) for p, v in flatten_with_path(mine)]
    assert got == want
    mlp = mine["blocks"][0]["mlp"]
    n, d, e, f = (cfg_t.num_layers, cfg_t.d_model, cfg_t.moe.num_experts,
                  cfg_t.d_ff)
    assert tuple(mlp["router"].shape) == (n, d, e)
    assert tuple(mlp["wo"].shape) == (n, e, f, d)
    for name, fan_in in (("router", d), ("wi", d), ("wg", d), ("wo", f)):
        assert float(mlp[name].std()) == pytest.approx(fan_in ** -0.5,
                                                       rel=0.1)


def test_other_patterns_still_refused():
    """A block kind the reference does not know is refused; the recurrent
    kinds, ported since, build the reference's subtrees (an SSD block has
    no MLP)."""
    cfg = get_reduced("qwen3_moe_30b_a3b")
    with pytest.raises(ValueError):
        T.init_params(cfg.with_(pattern=("attn", "conv")), device="cpu")
    blocks = T.init_params(cfg.with_(pattern=("attn", "rglru")),
                           device="cpu")["blocks"]
    assert set(blocks[1]) == {"norm1", "rec", "norm2", "mlp"}
    blocks = T.init_params(cfg.with_(pattern=("ssd", "attn"), ssm_state=8,
                                     ssm_head_dim=16), device="cpu")["blocks"]
    assert set(blocks[0]) == {"norm1", "ssd"}


# --------------------------------------------------------------------------
# routing and the MoE layers
# --------------------------------------------------------------------------

def test_moe_router_matches_reference(model):
    cfg_j, cfg_t, _, _ = model
    mj, mt = _mlp(model)
    x = _x(cfg_t, 3, 20).reshape(-1, cfg_t.d_model)
    vj, ij, aj = JL.moe_router(cfg_j, mj, jnp.asarray(x))
    vt, it, at = L.moe_router(cfg_t, mt, torch.from_numpy(x))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-6)
    assert float(at) == pytest.approx(float(aj), abs=1e-6)


def test_router_ties_take_the_lower_expert_first(model):
    """Tied probabilities (a router with equal columns) order as
    ``lax.top_k`` orders them: lower expert index first."""
    cfg_j, cfg_t, _, _ = model
    mj, mt = _mlp(model)
    e = cfg_t.moe.num_experts
    w = np.asarray(mt["router"].numpy())
    tied = np.repeat(w[:, :1], e, axis=1)          # every expert equal
    tied[:, e - 1] = w[:, e - 1]                   # ... but the last
    xs = jnp.asarray(_x(cfg_t, 1, 12).reshape(-1, cfg_t.d_model))
    _, ij, _ = JL.moe_router(cfg_j, dict(mj, router=jnp.asarray(tied)), xs)
    _, it, _ = L.moe_router(cfg_t, dict(mt, router=torch.from_numpy(tied)),
                            torch.from_numpy(np.array(xs)))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    for row in it.numpy().tolist():
        tied_picks = [i for i in row if i != e - 1]
        assert tied_picks == list(range(len(tied_picks)))


def test_moe_apply_dense_matches_reference(model):
    cfg_j, cfg_t, _, _ = model
    mj, mt = _mlp(model, layer=1)
    x = _x(cfg_t, 4, 1, seed=1)
    oj, aj = JL.moe_apply_dense(cfg_j, mj, jnp.asarray(x))
    ot, at = L.moe_apply_dense(cfg_t, mt, torch.from_numpy(x))
    _close(ot, oj, 1e-5)
    assert float(at) == pytest.approx(float(aj), abs=1e-6)


def _reference_slots(cfg, gate_idx, cap):
    """The reference's dispatch positions (the lines of
    ``_moe_apply_block`` that place each (token, choice) entry)."""
    e = cfg.moe.num_experts
    flat = gate_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - onehot,
                              flat[:, None], axis=1)[:, 0]
    keep = pos < cap
    return np.asarray(keep), np.asarray(flat * cap + jnp.where(keep, pos, 0))


def test_moe_apply_matches_reference_with_drops(model):
    """The capacity path at the default capacity factor on an input where
    entries are dropped: the same kept set and slots, outputs at 1e-5."""
    cfg_j, cfg_t, _, _ = model
    mj, mt = _mlp(model)
    # tokens leaning towards expert 0, so that its buffer overflows
    w0 = mt["router"][:, 0].numpy()
    x = _x(cfg_t, 3, 20, seed=2) + 2.0 * w0 / np.linalg.norm(w0)
    x = x.astype(np.float32)
    t, k, e = 60, cfg_t.moe.top_k, cfg_t.moe.num_experts
    cap = int(t * k / e * cfg_t.moe.capacity_factor + 0.999)
    _, ij, _ = JL.moe_router(cfg_j, mj, jnp.asarray(x.reshape(t, -1)))
    keep_j, slot_j = _reference_slots(cfg_j, ij, cap)
    _, it, _ = L.moe_router(cfg_t, mt, torch.from_numpy(x.reshape(t, -1)))
    keep_t, slot_t = L.capacity_slots(it, e, cap)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    np.testing.assert_array_equal(slot_t.numpy(), slot_j)
    assert not keep_j.all(), "the input must drop entries"
    oj, aj = JL.moe_apply(cfg_j, mj, jnp.asarray(x))
    ot, at = L.moe_apply(cfg_t, mt, torch.from_numpy(x))
    _close(ot, oj, 1e-5)
    assert float(at) == pytest.approx(float(aj), abs=1e-6)
    # a dropped entry adds nothing: at capacity 1 most tokens lose experts
    oj, _ = JL.moe_apply(cfg_j, mj, jnp.asarray(x), capacity_factor=0.05)
    ot, _ = L.moe_apply(cfg_t, mt, torch.from_numpy(x), capacity_factor=0.05)
    _close(ot, oj, 1e-5)


@pytest.mark.parametrize("chunk,s", [(8, 16), (8, 12), (16, 16)],
                         ids=["chunked", "indivisible", "one-chunk"])
def test_moe_apply_token_chunks_match_reference(model, monkeypatch, chunk, s):
    """``MOE_TOKEN_CHUNK`` set small in both packages: 32 tokens in chunks
    of 8 (four capacity buffers), 24 tokens (not a multiple: one block),
    and 32 in chunks of 16 (two)."""
    cfg_j, cfg_t, _, _ = model
    mj, mt = _mlp(model)
    monkeypatch.setattr(JL, "MOE_TOKEN_CHUNK", chunk)
    monkeypatch.setattr(L, "MOE_TOKEN_CHUNK", chunk)
    x = _x(cfg_t, 2, s, seed=3)
    oj, aj = JL.moe_apply(cfg_j, mj, jnp.asarray(x))
    ot, at = L.moe_apply(cfg_t, mt, torch.from_numpy(x))
    _close(ot, oj, 1e-5)
    assert float(at) == pytest.approx(float(aj), abs=1e-6)
    whole, _ = L._moe_apply_block(cfg_t, mt, torch.from_numpy(x))
    if 2 * s > chunk and (2 * s) % chunk == 0:
        # per-chunk capacity changes the result against one block
        assert not torch.equal(ot, whole)


@pytest.mark.parametrize("mode", ["prefill", "chunk", "decode"])
def test_block_routes_by_mode(model, mode, monkeypatch):
    """``block_apply`` takes the dense path at decode and the capacity path
    in the other modes, and returns the aux loss."""
    _, cfg_t, _, _ = model
    calls = []
    for name in ("moe_apply", "moe_apply_dense"):
        fn = getattr(L, name)
        monkeypatch.setattr(L, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg_t.vocab_size, (2, 6)))
    pt = model[3]
    if mode == "prefill":
        T.prefill(cfg_t, pt, toks, 8)
    else:
        _, cache = T.prefill(cfg_t, pt, toks, 8)
        calls.clear()
        if mode == "decode":
            T.decode_step(cfg_t, pt, cache, toks[:, :1], 6)
        else:
            p = T.layer_params(pt, 0, 0)
            c = {k: v[0] for k, v in cache[0].items()}
            c["cl"] = torch.tensor([6, 6])
            x = torch.randn(2, 6, cfg_t.d_model)
            _, _, aux = B.block_apply(cfg_t, "attn", p, x,
                                      torch.arange(6)[None].repeat(2, 1),
                                      "chunk", c)
            assert float(aux) > 0
    want = "moe_apply_dense" if mode == "decode" else "moe_apply"
    assert calls and set(calls) == {want}


def test_prefill_and_decode_logits_match_reference(model):
    cfg_j, cfg_t, pj, pt = model
    toks = np.random.RandomState(5).randint(0, cfg_t.vocab_size, (2, 13))
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks, jnp.int32)},
                        20)
    lt, ct = T.prefill(cfg_t, pt, torch.from_numpy(toks), 20)
    _close(lt, lj, 1e-5)
    nxt = np.asarray(jnp.argmax(lj, -1))
    for pos in (13, 14):
        lj, cj, tj = JT.decode_step(cfg_j, pj, cj,
                                    {"tokens": jnp.asarray(nxt[:, None])},
                                    jnp.int32(pos))
        lt, ct, tt = T.decode_step(cfg_t, pt, ct,
                                   torch.from_numpy(nxt[:, None].copy()), pos)
        _close(lt, lj, 1e-5)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        nxt = np.asarray(tj)


# --------------------------------------------------------------------------
# sealing the expert leaves
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def params(request):
    """Four-layer reduced params (so SE leaves middle layers a bypass), the
    reference's numbers in both trees."""
    cfg = jget_reduced(request.param).with_(num_layers=4)
    pj = JT.init_params(cfg, jax.random.key(1))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def test_se_masks_on_expert_leaves_match_reference(params):
    """Row masks per (layer, expert) over d_in, the boundary layers fully
    encrypted, the middle ones at the ratio, each the reference's."""
    pj, pt = params
    plans_j = JP.make_plan(pj, JSealConfig())
    plans_t = TP.make_plan(pt, SealConfig())
    assert not _masks_with_ties(plans_j, plans_t)
    for name in EXPERT_LEAVES:
        path = f"blocks/0/mlp/{name}"
        pl = plans_t[path]
        leaf = pt["blocks"][0]["mlp"][name]
        if name == "router":
            assert (pl.batch_axes, pl.row_axes) == ((0,), (1,))
        else:
            assert (pl.batch_axes, pl.row_axes) == ((0, 1), (2,))
            assert tuple(pl.mask.shape) == tuple(leaf.shape[:3])
        m = pl.mask.numpy()
        assert m[0].all() and m[-1].all() and not m[1:-1].all()
        np.testing.assert_array_equal(m, np.asarray(plans_j[path].mask))
        full = TP.expand_mask(pl, tuple(leaf.shape))
        np.testing.assert_array_equal(
            full.numpy(), np.asarray(JP.expand_mask(plans_j[path],
                                                    leaf.shape)))


def _expert_tree(p):
    """The experts and routers alone, at their paths in the model's tree
    (so under the model's nonces and SE boundary rule)."""
    return {"blocks": tuple({"mlp": b["mlp"]} for b in p["blocks"])}


@pytest.mark.parametrize("mode", ["coloe", "counter", "direct"])
def test_sealed_moe_image_word_for_word(params, mode, monkeypatch):
    """The expert and router leaves' image under each engine equals the
    reference's word for word and unseals to the params bit for bit; they
    take the line layout (``tile_geometry`` None)."""
    pj, pt = params
    check_sealed_image((_expert_tree(pj), _expert_tree(pt)), mode, 0.5,
                       monkeypatch)
    for name in EXPERT_LEAVES:
        leaf = pt["blocks"][0]["mlp"][name]
        path = ("blocks", "0", "mlp", name)
        assert TSS.tile_geometry(path, tuple(leaf.shape), leaf.dtype,
                                 SealConfig(mode=mode)) is None


def test_sealing_in_runs_equals_one_pass(params, monkeypatch):
    """Sealing a leaf run by run (``engine.SEAL_LINES`` lines a pass, here
    301) gives the one-pass words: the line addresses carry across runs."""
    _, pt = params
    leaf = pt["blocks"][0]["mlp"]["wi"]
    for mode in ("coloe", "counter"):
        eng = TE.make_engine(mode, KEY)
        n = -(-leaf.numel() // 32)
        flags = torch.from_numpy((np.arange(n) % 3 != 1).astype(np.int32))
        one = eng.encrypt(leaf, nonce2=(3, 4), enc_flags=flags)
        monkeypatch.setattr(TE, "SEAL_LINES", 301)
        runs = eng.encrypt(leaf, nonce2=(3, 4), enc_flags=flags)
        monkeypatch.undo()
        assert torch.equal(runs.payload, one.payload), mode
        if mode == "counter":
            assert torch.equal(runs.counters, one.counters)
        assert torch.equal(eng.decrypt(runs), leaf)


def test_serving_view_unseals_experts_each_dispatch(params):
    """``serving_params`` hands the layers the experts and the router in
    plaintext (one line unseal a leaf), the attention and head leaves still
    tile-sealed, and counts the experts in the plaintext bytes."""
    _, pt = params
    sp = TSS.seal_params(pt, SealConfig(), KEY)
    view = TSS.serving_params(sp, KEY)
    for name in EXPERT_LEAVES:
        assert torch.equal(view["blocks"][0]["mlp"][name],
                           pt["blocks"][0]["mlp"][name])
    expert_bytes = sum(pt["blocks"][0]["mlp"][n].numel() * 4
                       for n in EXPERT_LEAVES)
    assert sp.serving_plaintext_bytes(4, torch.float32) > expert_bytes
    assert len(sp.fused_paths()) == 5          # wq, wk, wv, wo, head


def test_serving_view_is_freed_with_its_dispatch(params):
    """A dispatch's view (the unsealed experts) is freed when the dispatch
    drops it, without waiting for the cyclic garbage collector: at full
    width each view is 13.5 GiB, and views kept alive by a reference cycle
    pile up across dispatches until the card runs out of memory."""
    _, pt = params
    sp = TSS.seal_params(pt, SealConfig(), KEY)
    gc.collect()
    gc.disable()
    try:
        view = TSS.serving_params(sp, KEY)
        refs = [weakref.ref(view["blocks"][0]["mlp"][n])
                for n in EXPERT_LEAVES]
        layer = T.layer_params(view, 0, 1)   # as every layer of a dispatch
        assert torch.equal(layer["mlp"]["wi"], pt["blocks"][0]["mlp"]["wi"][1])
        del view, layer
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_lines_unseal_plain_at_an_offset(params):
    """A run of an expert leaf's lines unsealed at its own addresses
    (``line0``) equals the same lines of the whole leaf's unseal."""
    _, pt = params
    sp = TSS.seal_params(pt, SealConfig(), KEY)
    st = sp.tensors["blocks/0/mlp/wg"]
    eng = sp.engine(KEY)
    whole = CC.lines_unseal_plain(eng.key_words, st.payload, None,
                                  st.meta.orig_len, st.meta.nonce)
    a, n = 37, 50
    part = CC.lines_unseal_plain(eng.key_words, st.payload[a:a + n], None,
                                 32 * n, st.meta.nonce, line0=a)
    assert torch.equal(part, whole[32 * a:32 * (a + n)])
    assert not torch.equal(part, whole[:32 * n])
    np.testing.assert_array_equal(
        u32.to_numpy(whole),
        np.asarray(pt["blocks"][0]["mlp"]["wg"].numpy()).reshape(-1).view(
            np.uint32))
