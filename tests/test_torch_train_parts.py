"""The training slice's parts held against the JAX package on the CPU:
configs, ``param_spec``, the engines' refusal of a frontend config,
the attention oracles, the recurrences' gradients, the optimizer, the
schedule, gradient compression, the data, the loader and the metrics
logger; and that training never reaches a CUDA kernel without a backward.

Tolerances:

* configs, ``TrainConfig``, ``param_spec`` shapes and dtypes, the data,
  gradient compression, the loader's order and the logger's records and
  line: equal;
* ``blockwise_attention`` against ``_sdpa`` at 2e-4 relative and 2e-5
  absolute (the reference's oracle, ``tests/test_models.py:112``) and
  against the reference's blockwise at 1e-5 of scale; chunked ``_sdpa``
  against unchunked at 1e-5 absolute (``tests/test_models.py:129``), its
  gradient and the recurrences' gradients against ``jax.grad`` at 1e-5 of
  scale;
* AdamW within 2e-7 of each tensor's scale (a couple of f32 ulp:
  ``b ** step``, ``sqrt`` and the divisions may round differently), the
  global norm within 2e-7 relative, ``lr_at`` within 1e-6 relative.
"""
import dataclasses
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as JC
from repro import configs as JCS
from repro.data import loader as JL
from repro.data import synthetic as JS
from repro.models import blocks as JB
from repro.models import layers as JLY
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import grad_compress as JG
from repro.optim import schedule as JSC
from repro.runtime import metrics as JM
from repro_torch import config as TC
from repro_torch import configs as TCS
from repro_torch.convert import params_from_numpy
from repro_torch.data import loader as TL
from repro_torch.data import synthetic as TS
from repro_torch.kernels import ops
from repro_torch.launch import serve as TLS
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TLY
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TA
from repro_torch.optim import grad_compress as TG
from repro_torch.optim import schedule as TSC
from repro_torch.runtime import metrics as TM
from repro_torch.serve.engine import GroupServeEngine, ServeEngine
from repro_torch.tree import flatten_with_path, leaves


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: intra-op threads only contend under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, want, tol):
    """``got`` within ``tol`` of ``want``'s scale (its largest magnitude)."""
    want = np.asarray(want, np.float64)
    got = (got.detach().double().numpy() if torch.is_tensor(got)
           else np.asarray(got, np.float64))
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


# ---------------- configs ----------------

@pytest.mark.parametrize("arch", ["internvl2_1b", "musicgen_medium"])
def test_frontend_configs_match_reference(arch):
    for fn in ("get_config", "get_reduced"):
        mine, ref = getattr(TCS, fn)(arch), getattr(JCS, fn)(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref), fn
        assert mine.heads_eff == ref.heads_eff


def test_registry_and_train_config_match_reference():
    assert TCS.ARCH_IDS == JCS.ARCH_IDS
    mine, ref = TCS.all_configs(), JCS.all_configs()
    assert list(mine) == list(ref)
    for arch in ref:
        assert dataclasses.asdict(mine[arch]) == dataclasses.asdict(ref[arch])
    assert dataclasses.asdict(TC.TrainConfig()) == \
        dataclasses.asdict(JC.TrainConfig())


@pytest.mark.parametrize("arch", JCS.ARCH_IDS)
def test_param_spec_matches_reference_at_published_widths(arch):
    """Paths, shapes and dtypes of the published config's params, on the
    ``meta`` device: nothing allocated."""
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): (tuple(s.shape), str(s.dtype))
            for kp, s in jax.tree_util.tree_flatten_with_path(
                JT.param_spec(JCS.get_config(arch)))[0]}
    spec = flatten_with_path(TT.param_spec(TCS.get_config(arch)))
    got = {"/".join(p): (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in spec}
    assert list(got) == list(want)
    assert got == want
    assert all(t.device.type == "meta" for _, t in spec)


def test_padded_heads_start_as_the_references_zeros():
    """``pad_heads_to``: the padded heads of each GQA group have zero wq
    and wo, where the reference's ``init_attention`` puts them."""
    cfg_j = JCS.get_reduced("internlm2_1_8b").with_(num_heads=6,
                                                    pad_heads_to=8)
    cfg_t = TCS.get_reduced("internlm2_1_8b").with_(num_heads=6,
                                                    pad_heads_to=8)
    pj = JLY.init_attention(cfg_j, jax.random.key(0))
    pt = TT.init_params(cfg_t, 0, "cpu")["blocks"][0]["attn"]
    for name, axis in (("wq", 2), ("wo", 1)):
        zj = np.all(np.asarray(pj[name]) == 0,
                    axis=tuple(a for a in range(3) if a != axis - 1))
        zt = (pt[name] == 0).all(dim=tuple(a for a in range(4)
                                           if a != axis)).numpy()
        assert zj.tolist() == zt.tolist() == [False, False, False, True] * 2


@pytest.mark.parametrize("arch", ["internvl2_1b", "musicgen_medium"])
def test_serving_refuses_a_frontend_config_as_the_reference(arch):
    cfg = TCS.get_reduced(arch)
    params = TT.init_params(cfg, 0, "cpu")
    for engine in (ServeEngine, GroupServeEngine):
        with pytest.raises(AssertionError,
                           match="serving demo targets token archs"):
            engine(cfg, params, device="cpu")
    with pytest.raises(AssertionError,
                       match="serving demo targets token archs"):
        TLS.main(["--arch", arch, "--device", "cpu"])
    with pytest.raises(AssertionError,
                       match="serving demo targets token archs"):
        from repro.serve.engine import ServeEngine as JServeEngine
        cj = JCS.get_reduced(arch)
        JServeEngine(cj, JT.init_params(cj, jax.random.key(0)))


# ---------------- attention ----------------

@pytest.mark.parametrize("b,s,hq,hkv,dh,win,cap", [
    (2, 256, 4, 2, 16, 0, 0.0), (1, 512, 8, 1, 32, 64, 50.0)])
def test_blockwise_attention_matches_sdpa_and_reference(b, s, hq, hkv, dh,
                                                       win, cap):
    q, k, v = (_rand((b, s, h, dh), i) for i, h in enumerate((hq, hkv, hkv)))
    pos = np.arange(s, dtype=np.int32)
    tq, tk, tv, tp = (torch.from_numpy(a) for a in (q, k, v, pos))
    ref = TLY._sdpa(tq, tk, tv, TLY._attn_mask(tp, tp, win), cap, dh ** -0.5)
    out = TLY.blockwise_attention(tq, tk, tv, tp, tp, win, cap, dh ** -0.5,
                                  q_block=64, kv_block=128)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-5)
    jq, jk, jv, jp = (jnp.asarray(a) for a in (q, k, v, pos))
    want = JLY.blockwise_attention(jq, jk, jv, jp, jp, win, cap, dh ** -0.5,
                                   q_block=64, kv_block=128)
    _close(out, want, 1e-5)


def test_chunked_sdpa_matches_and_its_gradient_is_the_references():
    b, s, h, dh = 2, 512, 4, 16
    q, k, v = (_rand((b, s, h, dh), 10 + i) for i in range(3))
    w = _rand((b, s, h, dh), 13)
    tq = torch.from_numpy(q).requires_grad_(True)
    tk, tv, tw = (torch.from_numpy(a) for a in (k, v, w))
    tp = torch.arange(s, dtype=torch.int32)
    mask = TLY._attn_mask(tp, tp, 0)
    ref = TLY._sdpa(tq, tk, tv, mask, 0.0, dh ** -0.5)
    out = TLY._sdpa(tq, tk, tv, mask, 0.0, dh ** -0.5, q_chunk=128)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=1e-5)
    (g,) = torch.autograd.grad((out * tw).sum(), tq)
    jp = jnp.arange(s, dtype=jnp.int32)
    jmask = JLY._attn_mask(jp, jp, 0)
    gj = jax.grad(lambda q_: jnp.sum(JLY._sdpa(
        q_, jnp.asarray(k), jnp.asarray(v), jmask, 0.0, dh ** -0.5,
        q_chunk=128) * w))(jnp.asarray(q))
    _close(g, gj, 1e-5)


def test_train_mode_never_reaches_the_flash_kernel(monkeypatch):
    """Mode ``"train"`` runs self-attention through ``_sdpa``: the flash
    kernel (no backward) is never called, and its CUDA route refuses
    inputs that require grad."""
    def refuse(*a, **k):
        raise AssertionError("train mode reached ops.flash_attention")
    monkeypatch.setattr(ops, "flash_attention", refuse)
    cfg = TCS.get_reduced("gemma2_2b").with_(dtype="float32")
    params = TT.init_params(cfg, 0, "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in TS.lm_batch(cfg, 2, 16, 0).items()}
    loss, _ = TT.forward(cfg, params, batch)
    assert torch.isfinite(loss)
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="differentiable route"):
        ops._refuse_autograd("flash_attention", "_sdpa", x)
    with torch.no_grad():
        ops._refuse_autograd("flash_attention", "_sdpa", x)


# ---------------- recurrences: gradients ----------------

def test_linear_scan_and_rglru_gradients_match_jax_grad():
    """The doubling scan against ``lax.associative_scan``, both through
    ``rglru_scan``: gradients with respect to the input and every param."""
    cfg = JCS.get_reduced("recurrentgemma_9b")
    pj = JB.init_rglru(cfg, jax.random.key(0))
    pn = jax.tree.map(np.asarray, pj)
    w = pn["lam"].shape[0]
    xa, wt = _rand((2, 19, w), 1), _rand((2, 19, w), 2)

    def jloss(p, x):
        h, last = JB.rglru_scan(p, x, None)
        return jnp.sum(h * wt) + jnp.sum(last)
    gpj, gxj = jax.jit(jax.grad(jloss, argnums=(0, 1)))(pj, jnp.asarray(xa))
    used = ("b_ig", "b_rg", "lam", "w_ig", "w_rg")     # the gates' params
    pt = {k: torch.from_numpy(pn[k].copy()).requires_grad_(True)
          for k in used}
    xt = torch.from_numpy(xa).requires_grad_(True)
    h, last = TB.rglru_scan(pt, xt, None)
    loss = (h * torch.from_numpy(wt)).sum() + last.sum()
    gs = torch.autograd.grad(loss, [xt] + [pt[k] for k in used])
    _close(gs[0], gxj, 1e-5)
    for k, g in zip(used, gs[1:]):
        _close(g, gpj[k], 1e-5)


@pytest.mark.parametrize("s,chunk", [(16, 128), (32, 8)])
def test_ssd_chunked_gradients_match_jax_grad(s, chunk):
    """The chunked dual form over one chunk and over four (the inter-chunk
    recurrence): gradients with respect to every input."""
    rng = np.random.RandomState(s)
    b, h, p, n = 2, 3, 4, 5
    args = [rng.randn(b, s, h, p), rng.uniform(0.01, 0.2, (b, s, h)),
            -rng.uniform(0.5, 2.0, (h,)), rng.randn(b, s, n),
            rng.randn(b, s, n)]
    args = [a.astype(np.float32) for a in args]
    wy, ws = _rand((b, s, h, p), 3), _rand((b, h, p, n), 4)

    def jloss(*a):
        y, st = JB.ssd_chunked(*a, chunk=chunk)
        return jnp.sum(y * wy) + jnp.sum(st * ws)
    gj = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        *(jnp.asarray(a) for a in args))
    ta = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, st = TB.ssd_chunked(*ta, chunk=chunk)
    loss = (y * torch.from_numpy(wy)).sum() + (st * torch.from_numpy(ws)).sum()
    for g, want in zip(torch.autograd.grad(loss, ta), gj):
        _close(g, want, 1e-5)


# ---------------- optimizer, schedule, compression ----------------

def _opt_case():
    """Params, grads and a state one step in (nonzero m and v, step 1),
    made with the reference."""
    params = {"a": {"w": _rand((33, 17), 0)}, "b": (_rand((5,), 1),
                                                    _rand((4, 4, 3), 2))}
    grads = jax.tree.map(lambda p: p * 0 + _rand(p.shape, p.size, 0.5),
                         params)
    tc = JC.TrainConfig()
    jp = jax.tree.map(jnp.asarray, params)
    jg = jax.tree.map(jnp.asarray, grads)
    _, opt, _ = JA.update(jp, JA.init(jp), jax.tree.map(lambda g: g * 3, jg),
                          jnp.float32(1e-3), tc)
    return params, grads, jax.tree.map(np.asarray, opt)


def test_adamw_matches_reference():
    params, grads, opt = _opt_case()
    jp, jg = (jax.tree.map(jnp.asarray, t) for t in (params, grads))
    tp, tg = params_from_numpy(params), params_from_numpy(grads)
    to = params_from_numpy(opt)
    z = TA.init(tp)
    # flatten order sorts the keys: m, step, v
    assert [t.dtype for t in leaves(z)] == \
        [torch.float32] * 3 + [torch.int32] + [torch.float32] * 3
    assert int(z["step"]) == 0 and all(not t.any() for t in leaves(z))
    nj, nt = float(JA.global_norm(jg)), float(TA.global_norm(tg))
    assert abs(nt - nj) <= 2e-7 * nj
    for max_norm in (0.5, 100.0):
        cj, _ = JA.clip_by_global_norm(jg, max_norm)
        ct, _ = TA.clip_by_global_norm(tg, max_norm)
        for a, b in zip(leaves(ct), jax.tree.leaves(cj)):
            _close(a, b, 2e-7)
    pj2, oj2, gn_j = JA.update(jp, jax.tree.map(jnp.asarray, opt), jg,
                               jnp.float32(3e-4),
                               JC.TrainConfig(grad_clip=0.5))
    pt2, ot2, gn_t = TA.update(tp, to, tg, torch.tensor(3e-4),
                               TC.TrainConfig(grad_clip=0.5))
    assert pt2 is tp and ot2 is to              # updated in place
    assert int(ot2["step"]) == int(oj2["step"]) == 2
    assert ot2["step"].dtype == torch.int32
    assert abs(float(gn_t) - float(gn_j)) <= 2e-7 * float(gn_j)
    for tree_t, tree_j in ((pt2, pj2), (ot2["m"], oj2["m"]),
                           (ot2["v"], oj2["v"])):
        for a, b in zip(leaves(tree_t), jax.tree.leaves(tree_j)):
            _close(a, b, 2e-7)


def test_lr_schedule_matches_reference():
    tc = JC.TrainConfig(learning_rate=3e-4, warmup_steps=10, total_steps=100)
    tt = TC.TrainConfig(learning_rate=3e-4, warmup_steps=10, total_steps=100)
    for s in range(121):
        want = float(JSC.lr_at(jnp.int32(s), tc))
        got = TSC.lr_at(torch.tensor(s, dtype=torch.int32), tt)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * want, s
    assert abs(float(TSC.lr_at(7, tt)) - float(JSC.lr_at(7, tc))) <= \
        1e-6 * float(JSC.lr_at(7, tc))


def test_grad_compress_bitwise():
    g = _rand((64, 33), 5, 0.1)
    g[0, :4] = [0.5 / 127 * 0.1 * 7, -1e-9, 0.0, 3.0]   # a clean max, ties
    err = _rand((64, 33), 6, 0.001)
    cj, sj = JG.compress(jnp.asarray(g))
    ct, st = TG.compress(torch.from_numpy(g))
    assert ct.dtype == torch.int8
    assert np.array_equal(ct.numpy(), np.asarray(cj))
    assert np.float32(st) == np.asarray(sj)
    assert np.array_equal(TG.decompress(ct, st).numpy(),
                          np.asarray(JG.decompress(cj, sj)))
    hj, ej = JG.ef_step(jnp.asarray(g), jnp.asarray(err))
    ht, et = TG.ef_step(torch.from_numpy(g), torch.from_numpy(err))
    assert np.array_equal(ht.numpy(), np.asarray(hj))
    assert np.array_equal(et.numpy(), np.asarray(ej))
    zero = TG.ef_init({"w": torch.ones(3, dtype=torch.bfloat16)})
    assert zero["w"].dtype == torch.float32 and not zero["w"].any()
    # all zeros: the 1e-30 floor keeps the scale finite
    cz, sz = TG.compress(torch.zeros(5))
    assert not cz.any() and float(sz) == float(JG.compress(jnp.zeros(5))[1])


# ---------------- data, loader, logger ----------------

@pytest.mark.parametrize("arch", ["internlm2_1_8b", "internvl2_1b",
                                  "musicgen_medium", "qwen3_moe_30b_a3b"])
def test_lm_batch_bitwise(arch):
    cj, ct = JCS.get_reduced(arch), TCS.get_reduced(arch)
    for step in (0, 3, 17):
        want, got = JS.lm_batch(cj, 4, 16, step, seed=5), \
            TS.lm_batch(ct, 4, 16, step, seed=5)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k


def test_token_stream_bitwise_sharded():
    for shards, shard in ((1, 0), (2, 0), (2, 1)):
        want = JS.TokenStream(1000, 32, 8, seed=3, n_shards=shards,
                              shard=shard).batch_at(5)
        got = TS.TokenStream(1000, 32, 8, seed=3, n_shards=shards,
                             shard=shard).batch_at(5)
        for k in want:
            assert np.array_equal(got[k], want[k])


def test_prefetch_loader_order_from_start_step():
    for device in (None, torch.device("cpu")):
        seen = []
        loader = TL.PrefetchLoader(lambda s: {"x": np.full((2,), s)},
                                   start_step=3, device=device)
        for step, batch in loader:
            assert torch.is_tensor(batch["x"]) == (device is not None)
            seen.append((step, int(batch["x"][0])))
            if len(seen) >= 4:
                break
        loader.close()
        assert seen == [(3, 3), (4, 4), (5, 5), (6, 6)]
    ref = JL.PrefetchLoader(lambda s: {"x": np.full((2,), s)}, start_step=3)
    first = next(ref)
    ref.close()
    assert first[0] == 3


def test_metrics_logger_line_and_record(tmp_path, monkeypatch):
    out = {}
    for name, mod, val in (("ref", JM, jnp.float32(0.25)),
                           ("port", TM, torch.tensor(0.25))):
        err = io.StringIO()
        monkeypatch.setattr(sys, "stderr", err)
        log = mod.MetricsLogger(str(tmp_path / name / "m.jsonl"))
        log.log(3, loss=val, ce=np.float32(1.5), lr=3e-4, sec=0.125)
        log.log(4, event="resumed")
        log.close()
        recs = [json.loads(x) for x in
                (tmp_path / name / "m.jsonl").read_text().splitlines()]
        for r in recs:
            assert isinstance(r.pop("time"), float)
        out[name] = (err.getvalue(), recs)
    assert out["port"] == out["ref"]
    assert out["port"][0].splitlines()[0] == \
        "step=3 loss=0.25 ce=1.5 lr=0.0003 sec=0.125"
