"""The port's CNN configs, ``prng.normal``, ``image_dataset``, CNN masks and
``models/cnn.py`` held against the JAX package on the CPU: VGG-16,
ResNet-18 and ResNet-34 (the paper's evaluation networks), at their
reduced configs on the reference's weights.

Tolerances:
- bitwise: configs field for field, ``layer_traffic`` (full configs at 32
  and 224, and the reduced ones), conv counts, ``image_dataset``,
  ``cnn_channel_masks`` at ratios 0.2/0.5/0.8, a CNN tree through
  ``params_from_numpy``;
- ``cnn_channel_masks`` at the published widths, on the reference's
  weights: equal but for rows whose exact ℓ1 lies within the reference's
  own f32 rounding of the mask's edge (the port ranks by the exact sum;
  one swap of two rows in the nine mask sets tested);
- ``prng.normal`` against ``jax.random.normal`` within ``NORMAL_REL``
  (1e-6) relative, and at least 98% of values bitwise (XLA's ``log1p`` in
  ``erf_inv`` is its own; 8M draws measured 99.06% equal, at most 3 ulp
  apart); so ``init_cnn``'s weights too, its zeros and ones exactly;
- forward logits and the loss at ``FWD_REL`` (1e-5) of their scale (XLA's
  and PyTorch's convolutions sum in different orders), including an odd
  image size (15) for the stride-2 "SAME" conv and the -inf-padded pool;
  so too ``chip_smoke._plain_cnn``, the card's plain second witness;
  ``conv2d`` and ``max_pool`` alone against ``lax`` at 1e-5;
- gradients with respect to every parameter and to the input at
  ``GRAD_REL`` (1e-4) of each tensor's scale.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import CNN_IDS as J_CNN_IDS
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.core import criticality as JCR
from repro.data.synthetic import image_dataset as jimage_dataset
from repro.models import cnn as JC
from repro_torch import prng
from repro_torch.configs import CNN_IDS, get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import criticality as CR
from repro_torch.data.synthetic import image_dataset
from repro_torch.models import cnn as C
from repro_torch.tree import flatten_with_path

NORMAL_REL = 1e-6
FWD_REL = 1e-5
GRAD_REL = 1e-4
RATIOS = (0.2, 0.5, 0.8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: intra-op threads only contend under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(cid, img):
    """(cfg_j, cfg_t, params_j, params_t as numpy-carried tensors, x, y):
    the reference's weights at the reduced config and image size ``img``;
    built once a module."""
    if (cid, img) not in _MODELS:
        cfg_j = jget_reduced(cid).with_(img_size=img)
        cfg_t = get_reduced(cid).with_(img_size=img)
        pj = JC.init_cnn(cfg_j, jax.random.key(3))
        x, y = jimage_dataset(6, img=img, seed=11)
        _MODELS[cid, img] = (cfg_j, cfg_t, pj,
                             params_from_numpy(jax.tree.map(np.asarray, pj)),
                             x, y)
    return _MODELS[cid, img]


def _scale_close(got, want, rel):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, err


# --------------------------------------------------------------------------
# configs and the registry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cid", J_CNN_IDS)
def test_configs_match_reference(cid):
    for fn_t, fn_j in ((get_config, jget_config),
                       (get_reduced, jget_reduced)):
        mine, ref = fn_t(cid), fn_j(cid)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert fn_t(cid.replace("_", "-")) == mine
        assert mine.with_(img_size=224).img_size == 224


def test_registry_names_the_reference_cnns():
    assert CNN_IDS == J_CNN_IDS
    with pytest.raises(KeyError, match="unknown arch 'vgg19'; known:"):
        get_config("vgg19")


@pytest.mark.parametrize("cid,n_conv,n_pool,n_fc", [
    ("vgg16", 13, 5, 3), ("resnet18", 17, 0, 1), ("resnet34", 33, 0, 1)])
def test_conv_counts_match_paper(cid, n_conv, n_pool, n_fc):
    kinds = [t["kind"] for t in C.layer_traffic(get_config(cid))]
    assert (kinds.count("conv"), kinds.count("pool"), kinds.count("fc")) \
        == (n_conv, n_pool, n_fc)


@pytest.mark.parametrize("img", [32, 224, None])
@pytest.mark.parametrize("cid", J_CNN_IDS)
def test_layer_traffic_bitwise(cid, img):
    """Full configs at the CIFAR and Figure-4 geometries, and the reduced
    config at its own; dtype widths 4 and 2."""
    if img is None:
        cfg_t, cfg_j = get_reduced(cid), jget_reduced(cid)
    else:
        cfg_t = get_config(cid).with_(img_size=img)
        cfg_j = jget_config(cid).with_(img_size=img)
    for nbytes in (4, 2):
        assert C.layer_traffic(cfg_t, nbytes) == \
            JC.layer_traffic(cfg_j, nbytes)


# --------------------------------------------------------------------------
# data and random draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,img,seed,noise", [(17, 16, 0, 0.35),
                                              (40, 32, 3, 0.45),
                                              (5, 15, 9, 0.0)])
def test_image_dataset_bitwise(n, img, seed, noise):
    x, y = image_dataset(n, img=img, seed=seed, noise=noise)
    xr, yr = jimage_dataset(n, img=img, seed=seed, noise=noise)
    assert x.dtype == xr.dtype and y.dtype == yr.dtype
    assert np.array_equal(x, xr) and np.array_equal(y, yr)


def _normal_close(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    rel = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want),
                                                           1e-30)
    assert rel.max() <= NORMAL_REL, rel.max()
    return float(np.mean(got == want))


@pytest.mark.parametrize("seed,fold,shape", [(0, 0, (3, 3, 16, 32)),
                                             (7, 1000, (1 << 20,)),
                                             (2**31 + 5, 3, (64, 10)),
                                             (1, 12, (1, 1, 8, 8))])
def test_normal_matches_jax(seed, fold, shape):
    """Every draw within 1e-6 relative; at least 98% bitwise over a
    million draws (a few draws alone may all differ by an ulp)."""
    got = prng.normal(prng.fold_in(prng.key(seed), fold), shape)
    want = jax.random.normal(jax.random.fold_in(jax.random.key(seed), fold),
                             shape)
    equal = _normal_close(got, want)
    if got.numel() >= 1 << 20:
        assert equal >= 0.98


@pytest.mark.parametrize("cid", J_CNN_IDS)
def test_init_cnn_matches_reference(cid):
    cfg_j, cfg_t = jget_reduced(cid), get_reduced(cid)
    pj = jax.tree_util.tree_flatten_with_path(
        JC.init_cnn(cfg_j, jax.random.key(4)))[0]
    pt = flatten_with_path(C.init_cnn(cfg_t, prng.key(4), device="cpu"))
    assert [jax.tree_util.keystr(p) for p, _ in pj] == \
        [f"[{p[0]}]['{p[1]}']" for p, _ in pt]
    for (path, want), (_, got) in zip(pj, pt):
        if path[-1].key in ("w", "proj"):
            _normal_close(got, want)
        else:       # biases and norms: zeros and ones
            assert np.array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# layers, forward, loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size", [1, 7, 15, 16])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2), (1, 1)])
def test_conv2d_same_padding(size, k, stride):
    rng = np.random.RandomState(size * 10 + k + stride)
    x = rng.standard_normal((2, size, size + 1, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    want = lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                    dimension_numbers=("NHWC", "HWIO",
                                                       "NHWC"))
    got = C.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride)
    _scale_close(got.numpy(), want, FWD_REL)


@pytest.mark.parametrize("size", [1, 2, 7, 15, 16])
def test_max_pool_same_padding(size):
    x = np.random.RandomState(size).standard_normal(
        (2, size, size + 1, 3)).astype(np.float32)
    want = lax.reduce_window(x, -jnp.inf, lax.max, (1, 2, 2, 1),
                             (1, 2, 2, 1), "SAME")
    assert np.array_equal(C.max_pool(torch.from_numpy(x)).numpy(),
                          np.asarray(want))


@pytest.mark.parametrize("img", [16, 15])
@pytest.mark.parametrize("cid", J_CNN_IDS)
def test_forward_and_loss_match_reference(cid, img):
    cfg_j, cfg_t, pj, pt, x, y = _model(cid, img)
    want = JC.cnn_forward(cfg_j, pj, x)
    got = C.cnn_forward(cfg_t, pt, torch.from_numpy(x))
    _scale_close(got.numpy(), want, FWD_REL)
    lj, aj = JC.cnn_loss(cfg_j, pj, {"x": x, "y": jnp.asarray(y)})
    lt, at = C.cnn_loss(cfg_t, pt, {"x": torch.from_numpy(x),
                                    "y": torch.from_numpy(y)})
    _scale_close(lt.item(), float(lj), FWD_REL)
    assert at.item() == float(aj)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("img", [16, 15])
@pytest.mark.parametrize("cid", J_CNN_IDS)
def test_plain_witness_matches_reference(cid, img):
    """``chip_smoke._plain_cnn``, the card's second witness to the
    protocol's training (plain PyTorch in NCHW, independent of
    ``models/cnn.py``), computes the reference's logits and loss."""
    cfg_j, cfg_t, pj, pt, x, y = _model(cid, img)
    loss_fn, logits_fn, _ = _chip_smoke()._plain_cnn(torch, cfg_t, pt)
    xt = torch.from_numpy(x)
    _scale_close(logits_fn(xt).detach().numpy(),
                 JC.cnn_forward(cfg_j, pj, x), FWD_REL)
    lj, _ = JC.cnn_loss(cfg_j, pj, {"x": x, "y": jnp.asarray(y)})
    _scale_close(loss_fn(xt, torch.from_numpy(y).long()).item(), float(lj),
                 FWD_REL)


@pytest.mark.parametrize("img", [16, 15])
@pytest.mark.parametrize("cid", J_CNN_IDS)
def test_gradients_match_reference(cid, img):
    """d loss / d params and d loss / d x at 1e-4 of each tensor's scale."""
    cfg_j, cfg_t, pj, pt, x, y = _model(cid, img)
    gp, gx = jax.grad(
        lambda p, bx: JC.cnn_loss(cfg_j, p, {"x": bx, "y": jnp.asarray(y)})[0],
        argnums=(0, 1))(pj, x)
    params = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
              for p in pt]
    leaves = [t for _, t in flatten_with_path(params)]
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = C.cnn_loss(cfg_t, params, {"x": xt, "y": torch.from_numpy(y)})[0]
    grads = torch.autograd.grad(loss, leaves + [xt])
    want = jax.tree.leaves(gp) + [gx]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        _scale_close(g.numpy(), w, GRAD_REL)


# --------------------------------------------------------------------------
# SE masks and the numpy boundary
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("cid", J_CNN_IDS)
def test_channel_masks_bitwise(cid, ratio):
    cfg_j, cfg_t, pj, pt, _, _ = _model(cid, 16)
    want = JCR.cnn_channel_masks(cfg_j, pj, ratio)
    got = CR.cnn_channel_masks(cfg_t, pt, ratio)
    assert sorted(got) == sorted(want)
    for i, m in want.items():
        assert np.array_equal(got[i].numpy(), np.asarray(m)), i
    # boundary protection: first two convs, the last conv and the FCs whole
    conv = [i for i, sp in enumerate(cfg_t.stages) if sp.kind == "conv"]
    fc = [i for i, sp in enumerate(cfg_t.stages) if sp.kind == "fc"]
    for i in conv[:2] + conv[-1:] + fc:
        assert bool(got[i].all())
    _scale_close(CR.conv_row_importance(pt[conv[2]]["w"]).numpy(),
                 JCR.conv_row_importance(pj[conv[2]]["w"]), 1e-6)


_FULL = {}


def _full_weights(cid):
    """The reference's weights at the published widths (init only, no
    forward), carried across; built once a module."""
    if cid not in _FULL:
        _FULL.clear()
        cfg_j = jget_config(cid)
        pj = JC.init_cnn(cfg_j, jax.random.key(5))
        _FULL[cid] = (cfg_j, pj,
                      params_from_numpy(jax.tree.map(np.asarray, pj)))
    return _FULL[cid]


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("cid", J_CNN_IDS)
def test_channel_masks_at_published_width(cid, ratio):
    """At 64-512 channels two rows at a mask's edge can have exact ℓ1 sums
    closer than the reference's f32 sums' rounding: the port ranks by the
    exact sum (f64, rounded once), XLA's f32 order may rank the other way.
    So each mask equals the reference's but for rows whose exact ℓ1 lies
    within that layer's largest f32 rounding error (the reference's sums
    against the exact ones) of the k-th largest. With these weights that
    is one swap, 2 of ResNet-18's 3,907 rows at ratio 0.8 (stage 10); the
    other masks are equal."""
    cfg_j, pj, pt = _full_weights(cid)
    want = JCR.cnn_channel_masks(cfg_j, pj, ratio)
    got = CR.cnn_channel_masks(get_config(cid), pt, ratio)
    assert sorted(got) == sorted(want)
    differ = 0
    for i, m in want.items():
        m, g = np.asarray(m), got[i].numpy()
        assert g.sum() == m.sum(), i
        bad = np.nonzero(g != m)[0]
        differ += len(bad)
        if len(bad):          # an SE conv: the boundary layers are whole
            exact = np.abs(np.asarray(pj[i]["w"], np.float64)).sum(
                axis=(0, 1, 3))
            f32 = np.asarray(JCR.conv_row_importance(pj[i]["w"]))
            rounding = np.abs(f32 - exact).max()
            kth = np.sort(exact)[::-1][int(g.sum()) - 1]
            assert np.abs(exact[bad] - kth).max() <= rounding, (i, bad)
    swapped = {("resnet18", 0.8): 2}
    assert differ == swapped.get((cid, ratio), 0)


def test_cnn_tree_crosses_params_from_numpy():
    """A list of per-stage dicts, ``{}`` for a pool, crosses intact."""
    _, _, pj, pt, _, _ = _model("vgg16", 16)
    assert isinstance(pt, list) and len(pt) == len(pj)
    for a, b in zip(pj, pt):
        assert sorted(a) == sorted(b)
        for k in a:
            assert b[k].dtype == torch.float32
            assert np.array_equal(b[k].numpy(), np.asarray(a[k]))
    assert {} in pt
