"""The port's RG-LRU and SSD blocks (``models/blocks.py``: the causal
depthwise conv, ``rglru_*``, ``_segsum``/``ssd_*``), their caches
(``models/cache.py``) and the recurrent paths of ``models/transformer.py``
held against the JAX package on the CPU, at the reduced
``recurrentgemma_9b`` and ``mamba2_130m`` on the reference's weights.

Everything is f32. The reference's ``lax.associative_scan`` and the port's
doubling scan sum in different orders, as do XLA's and PyTorch's einsums,
so functions compare at 1e-5 of their scale and the model's logits and
caches at 1e-5 relative (the reference's own oracles: ``ssd_chunked``
against repeated ``ssd_step``, ``rglru_scan`` against repeated
``rglru_step``, ``tests/test_models.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import blocks as JB
from repro.models import cache as JMC
from repro.models import transformer as JT
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import blocks as B
from repro_torch.models import cache as TMC
from repro_torch.models import transformer as T
from repro_torch.tree import flatten_with_path

ARCHS = ("recurrentgemma_9b", "mamba2_130m")
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: intra-op threads only contend under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(arch):
    """(cfg_j, cfg_t, params_j, params_t), f32, the reference's weights in
    both packages; built once a module."""
    if arch not in _MODELS:
        cfg_j = jget_reduced(arch).with_(dtype="float32")
        cfg_t = get_reduced(arch).with_(dtype="float32")
        pj = JT.init_params(cfg_j, jax.random.key(5))
        _MODELS[arch] = (cfg_j, cfg_t, pj,
                         params_from_numpy(jax.tree.map(np.asarray, pj)))
    return _MODELS[arch]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float64)
    got = got.double().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, err


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _layer(tree, i=0):
    """Super-block ``i``'s slice of a stacked leaf tree (numpy)."""
    return jax.tree.map(lambda a: np.asarray(a)[i], tree)


# --------------------------------------------------------------------------
# the causal depthwise conv
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 3, 9])
def test_causal_conv1d_matches_reference(s):
    x, w, b = _rand((2, s, 24), 0), _rand((4, 24), 1), _rand((24,), 2)
    want = JB.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = B.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b))
    _close(got, want)


def test_causal_conv1d_step_matches_reference_and_the_full_conv():
    """A step over the cached K-1 rows equals the reference's step and the
    full conv's output at the same position; the new tail is the last K-1
    rows of the input."""
    x, w, b = _rand((2, 7, 24), 3), _rand((4, 24), 4), _rand((24,), 5)
    tail = x[:, 3:6]
    yj, cj = JB.causal_conv1d_step(jnp.asarray(x[:, 6:7]), jnp.asarray(tail),
                                   jnp.asarray(w), jnp.asarray(b))
    yt, ct = B.causal_conv1d_step(torch.from_numpy(x[:, 6:7]),
                                  torch.from_numpy(tail),
                                  torch.from_numpy(w), torch.from_numpy(b))
    _close(yt, yj)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    full = B.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b))
    assert torch.equal(yt[:, 0], full[:, 6])


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------

def _rec(arch="recurrentgemma_9b"):
    _, _, pj, pt = _model(arch)
    pos = next(j for j, b in enumerate(pj["blocks"]) if "rec" in b)
    return _layer(pj["blocks"][pos]["rec"]), \
        {k: v[0] for k, v in pt["blocks"][pos]["rec"].items()}


@pytest.mark.parametrize("s", [1, 2, 5, 16, 37])
def test_linear_scan_against_a_sequential_loop(s):
    """The doubling scan at lengths on and off powers of two equals the
    recurrence step by step."""
    a = torch.from_numpy(np.random.RandomState(s).uniform(
        0.5, 1.0, (2, s, 8)).astype(np.float32))
    b = torch.from_numpy(_rand((2, s, 8), s + 1))
    h, want = torch.zeros(2, 8), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(B.linear_scan(a, b), torch.stack(want, 1))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(with_h0):
    pj, pt = _rec()
    w = pt["lam"].shape[0]
    xa = _rand((2, 19, w), 6)
    h0 = _rand((2, w), 7) if with_h0 else None
    hj, lj = JB.rglru_scan(pj, jnp.asarray(xa),
                           None if h0 is None else jnp.asarray(h0))
    ht, lt = B.rglru_scan(pt, torch.from_numpy(xa),
                          None if h0 is None else torch.from_numpy(h0))
    _close(ht, hj)
    _close(lt, lj)
    # the reference's oracle: the scan equals rglru_step repeated
    h = torch.from_numpy(h0) if with_h0 else torch.zeros(2, w)
    for t in range(xa.shape[1]):
        _, h = B.rglru_step(pt, torch.from_numpy(xa[:, t:t + 1]), h)
    _close(lt, h)


def test_rglru_step_matches_reference():
    pj, pt = _rec()
    w = pt["lam"].shape[0]
    xa, h = _rand((3, 1, w), 8), _rand((3, w), 9)
    yj, hj = JB.rglru_step(pj, jnp.asarray(xa), jnp.asarray(h))
    yt, ht = B.rglru_step(pt, torch.from_numpy(xa), torch.from_numpy(h))
    _close(yt, yj)
    _close(ht, hj)


def test_softplus_is_the_reference_logaddexp():
    """``lam`` and ``dt_bias`` go through jax's softplus, logaddexp(x, 0),
    also beyond torch's softplus threshold."""
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 25.0, 80.0], np.float32)
    np.testing.assert_array_equal(
        B._softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))))


# --------------------------------------------------------------------------
# SSD
# --------------------------------------------------------------------------

def test_segsum_matches_reference():
    x = _rand((2, 3, 9), 10, 0.3)
    want = np.asarray(JB._segsum(jnp.asarray(x)))
    got = B._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def _ssd_inputs(s, seed, b=2, h=3, p=4, n=5):
    rng = np.random.RandomState(seed)
    xh = rng.randn(b, s, h, p).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    Bm = rng.randn(b, s, n).astype(np.float32)
    Cm = rng.randn(b, s, n).astype(np.float32)
    return xh, dt, A, Bm, Cm


@pytest.mark.parametrize("s,chunk,init", [(16, 128, False), (24, 8, False),
                                          (32, 8, True), (256, 128, True)])
def test_ssd_chunked_matches_reference_and_steps(s, chunk, init):
    """One chunk and several (the inter-chunk recurrence), with and without
    an initial state: the reference's outputs and final state, and
    ``ssd_step`` repeated (the reference's oracle)."""
    args = _ssd_inputs(s, s + chunk)
    st0 = _rand((2, 3, 4, 5), 11) if init else None
    yj, fj = JB.ssd_chunked(*map(jnp.asarray, args),
                            initial_state=None if st0 is None
                            else jnp.asarray(st0), chunk=chunk)
    targs = [torch.from_numpy(a) for a in args]
    yt, ft = B.ssd_chunked(*targs, initial_state=None if st0 is None
                           else torch.from_numpy(st0), chunk=chunk)
    _close(yt, yj)
    _close(ft, fj)
    xh, dt, A, Bm, Cm = targs
    state = torch.from_numpy(st0) if init else torch.zeros(2, 3, 4, 5)
    ys = []
    for t in range(s):
        y, state = B.ssd_step(xh[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                              state)
        ys.append(y)
    _close(yt, torch.stack(ys, 1), 1e-4)
    _close(ft, state, 1e-4)


def test_ssd_step_matches_reference():
    xh, dt, A, Bm, Cm = _ssd_inputs(1, 12)
    st = _rand((2, 3, 4, 5), 13)
    args = (xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], st)
    yj, sj = JB.ssd_step(*map(jnp.asarray, args))
    yt, stt = B.ssd_step(*[torch.from_numpy(a) for a in args])
    _close(yt, yj)
    _close(stt, sj)


def test_ssd_chunked_refuses_what_the_reference_refuses():
    """Longer than a chunk and not a multiple of it: the reference's
    assertion, word for word."""
    args = _ssd_inputs(200, 14, b=1)
    with pytest.raises(AssertionError, match="seq 200 % chunk 128"):
        JB.ssd_chunked(*map(jnp.asarray, args))
    with pytest.raises(AssertionError, match=r"^seq 200 % chunk 128$"):
        B.ssd_chunked(*[torch.from_numpy(a) for a in args])


# --------------------------------------------------------------------------
# block applies, params and caches
# --------------------------------------------------------------------------

def _cache_close(got, want, rel=REL):
    """Leaf by leaf: the same keys, shapes and dtypes, values allclose."""
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).replace("torch.", "") == \
            str(want[key].dtype), key
        _close(got[key], want[key], rel)


@pytest.mark.parametrize("arch,kind", [("recurrentgemma_9b", "rglru"),
                                       ("mamba2_130m", "ssd")])
def test_block_apply_prefill_then_decode_matches_reference(arch, kind):
    """A whole block (norms, the recurrent sub-block, the MLP where there
    is one) in prefill over 11 tokens, then two decode steps from the cache
    it filled: outputs and caches against the reference's."""
    cfg_j, cfg_t, pj, pt = _model(arch)
    j = cfg_t.pattern.index(kind)
    bj = _layer(pj["blocks"][j])
    bt = {k: {n: v[0] for n, v in sub.items()}
          for k, sub in pt["blocks"][j].items()}
    x = _rand((2, 11, cfg_t.d_model), 15)
    pos = np.arange(11, dtype=np.int32)
    cj0 = JMC.block_cache_init(cfg_j, kind, 2, 16)
    ct0 = TMC.block_cache_init(cfg_t, kind, 2, 16)
    yj, cj, _ = JB.block_apply(cfg_j, kind, bj, jnp.asarray(x),
                               jnp.asarray(pos), "prefill", cj0)
    yt, ct, _ = B.block_apply(cfg_t, kind, bt, torch.from_numpy(x),
                              torch.from_numpy(pos), "prefill", ct0)
    _close(yt, yj)
    _cache_close(ct, cj)
    for step in range(2):
        xs = _rand((2, 1, cfg_t.d_model), 16 + step)
        p1 = np.array([11 + step], np.int32)
        yj, cj, _ = JB.block_apply(cfg_j, kind, bj, jnp.asarray(xs),
                                   jnp.asarray(p1), "decode", cj)
        yt, ct, _ = B.block_apply(cfg_t, kind, bt, torch.from_numpy(xs),
                                  torch.from_numpy(p1), "decode", ct)
        _close(yt, yj)
        _cache_close(ct, cj)


def test_short_prompt_pads_the_conv_tail():
    """A 2-token prompt leaves a 3-row conv tail led by a zero row in both
    packages."""
    cfg_j, cfg_t, pj, pt = _model("recurrentgemma_9b")
    bj = _layer(pj["blocks"][0]["rec"])
    bt = {k: v[0] for k, v in pt["blocks"][0]["rec"].items()}
    x = _rand((1, 2, cfg_t.d_model), 17)
    _, cj = JB.rglru_block_apply(cfg_j, bj, jnp.asarray(x), "prefill", None)
    _, ct = B.rglru_block_apply(cfg_t, bt, torch.from_numpy(x), "prefill",
                                None)
    assert tuple(ct["conv"].shape) == (1, 3, cfg_t.rglru_block_width)
    assert not ct["conv"][:, 0].any()
    _cache_close(ct, cj)


def test_init_params_tree_matches_reference(model):
    """The port's own init: the reference's paths, shapes and dtypes, and
    its constants (``lam``, ``A_log``, ``D``, zero biases and norms; ``lam``
    to 1e-5, as torch's and jnp's ``linspace`` and power round apart)."""
    cfg_j, cfg_t, pj, _ = model
    mine = T.init_params(cfg_t, seed=0, device="cpu")
    got = [("/".join(p), tuple(t.shape), t.dtype) for p, t in
           flatten_with_path(mine)]
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in p), tuple(a.shape), torch.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(pj)[0]]
    assert got == want
    ref = dict(flatten_with_path(params_from_numpy(
        jax.tree.map(np.asarray, pj))))
    for path, t in flatten_with_path(mine):
        name = path[-1]
        if name in ("lam", "A_log", "D", "conv_b", "b_rg", "b_ig",
                    "norm_scale", "scale"):
            np.testing.assert_allclose(t.numpy(), ref[path].numpy(),
                                       rtol=1e-5, err_msg="/".join(path))
    if cfg_t.pattern[0] == "ssd":
        dt_bias = mine["blocks"][0]["ssd"]["dt_bias"]
        sp = torch.nn.functional.softplus(dt_bias)
        assert float(sp.min()) >= 1e-3 * 0.999 and float(sp.max()) <= 0.1001


def test_model_cache_init_matches_reference(model):
    cfg_j, cfg_t, _, _ = model
    cj = JMC.model_cache_init(cfg_j, 3, 10)
    ct = TMC.model_cache_init(cfg_t, 3, 10, "cpu")
    for kind, lt, lj in zip(cfg_t.pattern, ct, cj):
        spec = TMC.block_cache_spec(cfg_t, kind, 3, 10)
        jspec = JMC.block_cache_spec(cfg_j, kind, 3, 10)
        assert set(spec) == set(jspec) == set(lt)
        for key in lj:
            assert spec[key][0] == jspec[key].shape
            assert tuple(lt[key].shape) == lj[key].shape
            assert str(lt[key].dtype).replace("torch.", "") == \
                str(lj[key].dtype)
            np.testing.assert_array_equal(lt[key].numpy(),
                                          np.asarray(lj[key]))


# --------------------------------------------------------------------------
# the model: prefill and decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("plen,cache_len", [(13, 24), (21, 16)],
                         ids=["pad", "ring"])
def test_prefill_and_decode_steps_match_reference(model, plen, cache_len):
    """Prefill, then 6 greedy decode steps: logits and every cache leaf
    (recurrent state, conv tails, and RecurrentGemma's local-attention
    ring, padded or wrapped) against the reference's."""
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
    for lt_, lj_ in zip(ct, cj):
        _cache_close(lt_, lj_)


def test_mamba2_prompt_of_200_refused_by_both():
    """A 200-token prompt (over one 128-token chunk, not a multiple of it)
    is refused by both packages' prefill; 128 and 256 are served."""
    cfg_j, cfg_t, pj, pt = _model("mamba2_130m")
    toks = np.random.RandomState(0).randint(0, cfg_t.vocab_size, (1, 200))
    with pytest.raises(AssertionError, match="seq 200 % chunk 128"):
        JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks, jnp.int32)}, 256)
    with pytest.raises(AssertionError, match="seq 200 % chunk 128"):
        T.prefill(cfg_t, pt, torch.from_numpy(toks), 256)
    longer = np.tile(toks, 2)
    for n in (128, 256):
        logits, _ = T.prefill(cfg_t, pt, torch.from_numpy(longer[:, :n]), n)
        assert bool(torch.isfinite(logits).all())
