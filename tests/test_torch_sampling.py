"""Per-request sampling in the port (``repro_torch/prng.py``,
``serve/sampling.py``, the sampling state of ``serve/step.py`` and
``ServeEngine``) held against jax and the JAX package on the CPU.

Tolerances: threefry words, key data, fold-ins, random bits and uniforms
compare bitwise. Gumbel noise compares to 2e-6 absolute: ``torch.log`` and
XLA's ``log`` may differ by an ulp (measured over 200 keys x 92,544 draws:
about one value in seven differs, by at most 9.5e-7), so noise that is
``-log(-log(u))`` of bitwise-equal uniforms can differ in its last bits.
Tokens compare exactly on the same logits. The top-p rows are drawn on
logits whose sorted cumulative mass lies at least 1e-6 away from top_p at
every rank (checked in the test with the reference's own probabilities):
the two frameworks may sum the f32 cumulative mass in another order, which
could move a cut that sat on the boundary. Served streams compare exactly
across frameworks in f32 (as the greedy ones in ``test_torch_serve.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro.serve import sampling as JS
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import prng, u32
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.security.tamper import TamperInjector
from repro_torch.serve import sampling as SM
from repro_torch.serve.engine import ServeEngine

V = 64


def _u32(rng, shape):
    return rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _i64(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


# --------------------------------------------------------------------------
# repro_torch/prng.py against jax.random
# --------------------------------------------------------------------------

def test_threefry_matches_jax():
    rng = np.random.RandomState(0)
    k = _u32(rng, (2,))
    x = _u32(rng, (2, 1000))
    x[:, :3] = [[0, 0xFFFFFFFF, 1], [0, 0xFFFFFFFF, 2**31]]
    want = np.asarray(jprng.threefry_2x32(
        (jnp.uint32(k[0]), jnp.uint32(k[1])), jnp.asarray(x.reshape(-1))))
    h1, h2 = prng.threefry2x32(_i64(k[0]), _i64(k[1]), _i64(x[0]),
                               _i64(x[1]))
    got = torch.cat([h1, h2]).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1, -1, -7, 2**32 - 1])
def test_key_fold_in_and_key_data_match_jax(seed):
    kj = jax.random.key(seed)
    kt = prng.key(seed)
    np.testing.assert_array_equal(u32.to_numpy(prng.key_data(kt)),
                                  np.asarray(jax.random.key_data(kj)))
    for d in (0, 1, 7, 2**31, 2**32 - 1):
        want = jax.random.key_data(jax.random.fold_in(kj, d))
        np.testing.assert_array_equal(u32.to_numpy(prng.fold_in(kt, d)),
                                      np.asarray(want))
    with pytest.raises(OverflowError):
        prng.key(2**32)


def _keys(n, seed=3):
    """n keys of distinct requests, folded at distinct counts: (jax typed
    keys, port key data)."""
    kd = np.stack([np.asarray(JS.request_key_data(seed, r)) for r in range(n)])
    counts = np.arange(n, dtype=np.int32) * 3
    kj = JS.fold_token_keys(kd, jnp.asarray(counts))
    kt = SM.fold_token_keys(torch.stack([SM.request_key_data(seed, r)
                                         for r in range(n)]),
                            torch.from_numpy(counts.astype(np.int64)))
    np.testing.assert_array_equal(u32.to_numpy(kt),
                                  np.asarray(jax.random.key_data(kj)))
    return kj, kt


@pytest.mark.parametrize("n", [1, 7, 92544])
def test_random_bits_and_uniform_bitwise(n):
    kj, kt = _keys(3)
    bits = jax.vmap(lambda k: jax.random.bits(k, (n,)))(kj)
    np.testing.assert_array_equal(
        prng.random_bits(kt, n).numpy().astype(np.uint32), np.asarray(bits))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0)):       # the ranges gumbel uses
        want = jax.vmap(lambda k: jax.random.uniform(
            k, (n,), minval=lo, maxval=hi))(kj)
        got = prng.uniform(kt, n, lo, hi)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))


def test_gumbel_within_2e6():
    kj, kt = _keys(8)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (92544,)))(kj))
    got = prng.gumbel(kt, 92544).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# --------------------------------------------------------------------------
# serve/sampling.py against the reference's
# --------------------------------------------------------------------------

def _top_p_margin(logits, temperature, top_p):
    """The least distance between top_p and the mass before any rank, in
    the reference's own f32 probabilities, over the rows that cut (top_p <
    1; at top_p = 1 only ranks whose mass before them rounds to 1, so that
    together they hold less than 1e-6, can fall on the boundary)."""
    t = np.maximum(temperature, 1e-6)[:, None]
    srt = -np.sort(-logits, axis=1)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(srt / t), axis=-1))
    before = np.cumsum(probs, axis=1) - probs
    cut = top_p < 1
    return np.abs(before[cut] - top_p[cut, None]).min()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_logits_matches_reference_mixed_rows(seed):
    """Greedy, top-k, top-p and plain-temperature rows in one call, with
    ties in the logits: the reference's tokens exactly."""
    rng = np.random.RandomState(seed)
    b, v = 12, 512
    logits = (rng.randn(b, v) * 3).astype(np.float32)
    logits[:, 7] = logits[:, 3]                          # ties: stable order
    temp = np.array([0, 1.0, 0.7, 1.3, 0.5, 1.0, 2.0, 0.9, 1.0, 0, 0.6, 1e-5],
                    np.float32)
    topk = np.array([0, 1, 5, 0, 50, 0, 3, 0, 0, 5, 0, 0], np.int32)
    topp = np.array([1, 1, 1, 0.9, 1, 0.5, 0.8, 1, 0.3, 0.9, 0.95, 1],
                    np.float32)
    assert _top_p_margin(logits, temp, topp) > 1e-6
    kd = np.stack([np.asarray(JS.request_key_data(11 + seed, r))
                   for r in range(b)])
    counts = rng.randint(0, 100, b).astype(np.int32)
    want = JS.sample_logits(jnp.asarray(logits),
                            JS.fold_token_keys(kd, jnp.asarray(counts)),
                            jnp.asarray(temp), jnp.asarray(topk),
                            jnp.asarray(topp))
    keys = SM.fold_token_keys(u32.words(kd),
                              torch.from_numpy(counts.astype(np.int64)))
    got = SM.sample_logits(torch.from_numpy(logits), keys,
                           torch.from_numpy(temp),
                           torch.from_numpy(topk.astype(np.int64)),
                           torch.from_numpy(topp), greedy=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the all-greedy short-circuit is the full path at temperature 0
    zero = torch.zeros(b)
    full = SM.sample_logits(torch.from_numpy(logits), keys, zero,
                            torch.from_numpy(topk.astype(np.int64)),
                            torch.from_numpy(topp), greedy=False)
    assert torch.equal(SM.sample_logits(torch.from_numpy(logits)), full)


# the reference's own property tests (tests/test_sampling.py), ported

def _logits(b, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(b, V).astype(np.float32))


def _draw_keys(b, seed=7, counts=None):
    kd = torch.stack([SM.request_key_data(seed, r) for r in range(b)])
    return SM.fold_token_keys(kd, torch.zeros(b, dtype=torch.int64)
                              if counts is None else counts)


def _sample(logits, keys, temp, topk, topp):
    b = logits.shape[0]
    full = lambda v, dt: torch.full((b,), v, dtype=dt) if not torch.is_tensor(
        v) else v
    return SM.sample_logits(logits, keys, full(temp, torch.float32),
                            full(topk, torch.int64), full(topp, torch.float32),
                            greedy=False)


def test_temperature_zero_is_exact_argmax():
    logits = _logits(8)
    tok = _sample(logits, _draw_keys(8), 0.0, 0, 1.0)
    assert torch.equal(tok, torch.argmax(logits, -1))


def test_temperature_to_zero_limit_matches_greedy():
    logits = _logits(8, seed=1)
    tok = _sample(logits, _draw_keys(8), 1e-5, 0, 1.0)
    assert torch.equal(tok, torch.argmax(logits, -1))


@pytest.mark.parametrize("k", [1, 4])
def test_top_k_mass_stays_in_top_k(k):
    logits = _logits(1, seed=2).expand(64, V).contiguous()
    tok = _sample(logits, _draw_keys(64, seed=0), 1.0, k, 1.0)
    allowed = set(torch.argsort(-logits[0])[:k].tolist())
    assert set(tok.tolist()) <= allowed
    if k > 1:
        assert len(set(tok.tolist())) > 1


def test_top_p_nucleus_cut():
    probs = np.full((V,), 1e-4)
    probs[:4] = [0.55, 0.25, 0.12, 0.05]
    row = torch.from_numpy(np.log(probs / probs.sum()).astype(np.float32))
    logits = row[None].expand(128, V).contiguous()
    keys = _draw_keys(128, seed=3)
    tok = _sample(logits, keys, 1.0, 0, 0.9)
    assert set(tok.tolist()) <= {0, 1, 2, 3}
    tok = _sample(logits, keys, 1.0, 0, 0.1)
    assert set(tok.tolist()) == {0}


def test_mixed_rows_one_call():
    logits = _logits(3, seed=4)
    tok = _sample(logits, _draw_keys(3), torch.tensor([0.0, 1.0, 1.0]),
                  torch.tensor([0, 2, 0]), torch.tensor([1.0, 1.0, 0.5]))
    assert tok[0] == torch.argmax(logits[0])
    assert tok[1] in torch.argsort(-logits[1])[:2]


def test_bit_reproducible_streams():
    logits = _logits(4, seed=5)
    kd = torch.stack([SM.request_key_data(11, r) for r in [3, 1, 4, 1]])
    counts = torch.tensor([0, 2, 5, 2])
    args = (torch.ones(4), torch.full((4,), 8), torch.full((4,), 0.95))
    t1 = _sample(logits, SM.fold_token_keys(kd, counts), *args)
    t2 = _sample(logits, SM.fold_token_keys(kd, counts), *args)
    assert torch.equal(t1, t2)
    perm = [2, 0, 3, 1]
    t3 = _sample(logits[perm], SM.fold_token_keys(kd[perm], counts[perm]),
                 *(a[perm] for a in args))
    assert torch.equal(t3, t1[perm])


def test_request_key_data_deterministic_and_distinct():
    a, b = SM.request_key_data(0, 1), SM.request_key_data(0, 1)
    c, d = SM.request_key_data(0, 2), SM.request_key_data(1, 1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    np.testing.assert_array_equal(u32.to_numpy(a),
                                  np.asarray(JS.request_key_data(0, 1)))


# --------------------------------------------------------------------------
# sampled serving: the reference's traces through both engines
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_model():
    cfg_j = jget_reduced("internlm2_1_8b").with_(dtype="float32")
    cfg_t = get_reduced("internlm2_1_8b").with_(dtype="float32")
    pj = JT.init_params(cfg_j, jax.random.key(1))
    return cfg_j, cfg_t, pj, params_from_numpy(jax.tree.map(np.asarray, pj))


def _mixed_requests(vocab):
    """tests/test_serve_paged.py's sealed-cache trace: mixed lengths and
    sampling settings."""
    rng = np.random.RandomState(0)
    return [
        (rng.randint(0, vocab, 5), dict(max_tokens=6)),
        (rng.randint(0, vocab, 12),
         dict(max_tokens=8, temperature=0.8, top_k=5)),
        (rng.randint(0, vocab, 19),
         dict(max_tokens=5, temperature=1.0, top_p=0.9)),
        (rng.randint(0, vocab, 8), dict(max_tokens=7, temperature=0.6)),
    ]


def _run(cls, cfg, params, reqs, **kw):
    dev = {} if cls is JServeEngine else {"device": "cpu"}
    eng = cls(cfg, params, batch_slots=2, max_len=48, seal=None,
              sample_seed=5, **dev, **kw)
    for prompt, skw in reqs:
        eng.submit(prompt, **skw)
    done = eng.run()
    assert all(r.done for r in done) and len(done) == len(reqs)
    return eng, {r.rid: r.out for r in done}


def test_sampled_streams_match_reference_plain_and_sealed_cache(f32_model):
    cfg_j, cfg_t, pj, pt = f32_model
    reqs = _mixed_requests(cfg_t.vocab_size)
    _, want = _run(JServeEngine, cfg_j, pj, reqs, seal_cache=False)
    for seal_cache in (False, True):
        eng, got = _run(ServeEngine, cfg_t, pt, reqs, seal_cache=seal_cache)
        assert got == want, seal_cache
        eng.check_device_mirror()
    assert any(got[1][i] != got[1][0] for i in range(1, len(got[1])))


@pytest.mark.parametrize("seal_cache", [False, True])
def test_prefix_sharing_sampled_streams_match_reference(f32_model,
                                                        seal_cache):
    """tests/test_serve_paged.py's prefix-sharing trace (the clone samples
    at temperature 0.7, top-k 8): the port's shared and unshared streams
    equal the reference's."""
    cfg_j, cfg_t, pj, pt = f32_model

    def run(cls, cfg, params, prefix_share):
        dev = {} if cls is JServeEngine else {"device": "cpu"}
        eng = cls(cfg, params, batch_slots=2, max_len=48, seal=None,
                  seal_cache=seal_cache, sample_seed=5,
                  prefix_share=prefix_share, **dev)
        rng = np.random.RandomState(7)
        base = rng.randint(0, cfg.vocab_size, 27)
        fork = np.concatenate([base[:20], rng.randint(0, cfg.vocab_size, 7)])
        r0 = eng.submit(base.copy(), max_tokens=6)
        for _ in range(3):
            eng.step()
        r1 = eng.submit(base.copy(), max_tokens=6, temperature=0.7, top_k=8)
        r2 = eng.submit(fork.copy(), max_tokens=5)
        eng.run()
        return eng, (r0.out, r1.out, r2.out)

    _, want = run(JServeEngine, cfg_j, pj, True)
    eng, got = run(ServeEngine, cfg_t, pt, True)
    _, unshared = run(ServeEngine, cfg_t, pt, False)
    assert got == want and unshared == want
    assert eng.stats["cow_copies"] >= 1
    eng.check_device_mirror()


def test_retried_victim_sampled_stream_equals_clean_run(f32_model):
    """A tampered request is re-prefilled with its counts reset, so its
    sampled stream is the clean run's (and the reference's)."""
    cfg_j, cfg_t, pj, pt = f32_model
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(1, cfg_t.vocab_size, n),
             dict(max_tokens=10, temperature=t, top_k=k))
            for n, t, k in ((11, 0.9, 0), (7, 0.7, 6), (9, 1.2, 0))]
    _, want = _run(JServeEngine, cfg_j, pj, reqs, seal_cache=True)
    _, clean = _run(ServeEngine, cfg_t, pt, reqs, seal_cache=True,
                    verify=True)
    inj = TamperInjector("bitflip", slot=0, start_step=3)
    eng, got = _run(ServeEngine, cfg_t, pt, reqs, seal_cache=True,
                    verify=True, fault_hooks=(inj,))
    assert inj.fired and eng.stats["retries"] == 1
    assert clean == want and got == clean
    assert eng._alloc.free_count == eng.num_blocks - 1


def test_all_greedy_dispatches_draw_nothing(f32_model, monkeypatch):
    """An all-greedy run launches nothing of the sampler (the host knows
    every slot's settings); one sampled request makes its dispatches
    draw."""
    _, cfg_t, _, pt = f32_model
    calls = []
    real = prng.threefry2x32
    monkeypatch.setattr(prng, "threefry2x32",
                        lambda *a: calls.append(1) or real(*a))
    prompts = [np.arange(1, 9), np.arange(3, 15)]
    eng = ServeEngine(cfg_t, pt, batch_slots=2, max_len=48, device="cpu")
    for p in prompts:
        eng.submit(p, max_tokens=4)
    eng.run()
    assert len(calls) == 2            # fold_in(rid): the base keys, on admit
    eng.submit(prompts[0], max_tokens=4, temperature=0.8)
    eng.run()
    # its base key, then a fold-in and the draws' bits for each of 4 tokens
    assert len(calls) == 2 + 1 + 2 * 4
