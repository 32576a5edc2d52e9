"""The port's substitute-model attacks (``core/security/attacks.py``) and the
security protocol (``core/security/evaluate.py``) held against the JAX
package on the CPU, at the reduced VGG-16, ResNet-18 and ResNet-34 on the
reference's weights (``params_from_numpy``) and the same numpy data.

Tolerances:
- ``train_cnn``: params after three SGD-momentum steps (and after six
  epochs of one step, across the learning-rate halving) at ``PARAM_REL``
  (1e-4) of each tensor's scale, with and without ``freeze_masks``; the
  frozen rows bitwise unchanged. An epoch that drops a remainder is held
  at ``KINK_REL`` (1e-3) for ResNet-34: there, the second step's batch
  meets a ReLU input of 4.5e-7 (1.3e-7 of its layer's scale, the rounding
  noise of the two packages' sums) that is positive in the reference and
  not in the port, so one unit's gradient passes in one package only, and
  the params part by up to 6.2e-4 of a bias's scale. The reference's own
  gradient, taken at the port's params of that step, moves by 1e-6: the
  parting is the kink's, not a difference of arithmetic;
- ``se_substitute_init``: masks and plaintext rows bitwise, biases and
  norms exactly reset, the redrawn rows and ``proj`` within
  ``NORMAL_REL`` (1e-6) relative (``prng.normal``'s tolerance,
  ``tests/test_torch_cnn.py``);
- ``jacobian_augment``: labels agree on at least 99% of the query set; the
  first gradient round's images equal wherever the two gradients' signs
  agree, the jitter rounds bitwise, and at least 99% of all pixels equal;
- ``ifgsm``: I-FGSM takes the sign of the input gradient, so a component
  within rounding of zero can take the other sign in the other package,
  and the paths part there by a step of ``alpha``. One step is held equal
  wherever the two gradients' signs agree (at least 99.9% of pixels); ten
  steps at ``PARAM_REL`` (1e-4) on at least 99% of pixels, every pixel
  within ``eps`` of the input;
- ``accuracy`` and ``attack_success`` within one sample, ``otp_reuse_leak``
  bitwise;
- ``evaluate`` at a tiny size (``n_train`` 200, ``n_test`` 64, epochs 2 / 1,
  ratio 0.5): every field of the report within ``REPORT_TOL`` (0.05).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import criticality as JCR
from repro.core.security import attacks as JA
from repro.core.security import evaluate as JE
from repro.data.synthetic import image_dataset
from repro.models import cnn as JC
from repro_torch import prng, u32
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.security import attacks as A
from repro_torch.core.security import evaluate as E
from repro_torch.models import cnn as C

CNN_IDS = ("vgg16", "resnet18", "resnet34")
PARAM_REL = 1e-4
KINK_REL = 1e-3
NORMAL_REL = 1e-6
REPORT_TOL = 0.05
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: intra-op threads only contend under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(cid):
    """(cfg_j, cfg_t, params_j, params_t): the reference's weights in both
    packages at the reduced config; built once a module."""
    if cid not in _MODELS:
        cfg_j, cfg_t = jget_reduced(cid), get_reduced(cid)
        pj = JC.init_cnn(cfg_j, jax.random.key(2))
        _MODELS[cid] = (cfg_j, cfg_t, pj,
                        params_from_numpy(jax.tree.map(np.asarray, pj)))
    return _MODELS[cid]


def _data(n, cfg, seed=5):
    return image_dataset(n, img=cfg.img_size, seed=seed)


def _tree_close(got, want, rel):
    assert len(got) == len(want)
    for gp, wp in zip(got, want):
        assert sorted(gp) == sorted(wp)
        for k in wp:
            w = np.asarray(wp[k], np.float64)
            g = gp[k].detach().cpu().double().numpy()
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= rel, (k, err)


def _rows(m, w):
    return m[None, None, :, None] if w.ndim == 4 else m[:, None]


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _train_pair(cid, n, frozen):
    """(port params, reference params, port's initial params, port masks)
    after one epoch over ``n`` images at batch 16."""
    cfg_j, cfg_t, pj, pt = _model(cid)
    x, y = _data(n, cfg_t)
    fm_j = JCR.cnn_channel_masks(cfg_j, pj, 0.5) if frozen else None
    fm_t = ({i: torch.tensor(np.asarray(m)) for i, m in fm_j.items()}
            if frozen else None)
    want = JA.train_cnn(cfg_j, pj, x, y, epochs=1, batch=16, seed=3,
                        freeze_masks=fm_j)
    got = A.train_cnn(cfg_t, pt, x, y, epochs=1, batch=16, seed=3,
                      freeze_masks=fm_t, device=CPU)
    # the input params are left as they were
    _tree_close(pt, pj, 0.0)
    return got, want, pt, fm_t


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("cid", CNN_IDS)
def test_train_cnn_three_steps(cid, frozen):
    """48 images at batch 16: three steps."""
    got, want, pt, fm_t = _train_pair(cid, 48, frozen)
    _tree_close(got, want, PARAM_REL)
    if frozen:
        for i, m in fm_t.items():
            w0, w1 = pt[i]["w"], got[i]["w"]
            keep = ~_rows(m, w0).expand_as(w0)
            assert torch.equal(w1[keep], w0[keep])
            assert not torch.equal(w1[~keep], w0[~keep])


@pytest.mark.parametrize("cid,rel", [("vgg16", PARAM_REL),
                                     ("resnet18", PARAM_REL),
                                     ("resnet34", KINK_REL)])
def test_train_cnn_drops_the_remainder(cid, rel):
    """50 images at batch 16: three steps, the last 2 images of the
    permutation dropped, as in the reference (``n // batch`` steps)."""
    got, want, _, _ = _train_pair(cid, 50, False)
    _tree_close(got, want, rel)


def test_train_cnn_learning_rate_halves_at_epoch_five():
    cfg_j, cfg_t, pj, pt = _model("vgg16")
    x, y = _data(16, cfg_t)
    want = JA.train_cnn(cfg_j, pj, x, y, epochs=6, batch=16, lr=0.05)
    got = A.train_cnn(cfg_t, pt, x, y, epochs=6, batch=16, lr=0.05,
                      device=CPU)
    _tree_close(got, want, PARAM_REL)


@pytest.mark.parametrize("cid", CNN_IDS)
def test_accuracy_and_attack_success(cid):
    cfg_j, cfg_t, pj, pt = _model(cid)
    x, y = _data(300, cfg_t, seed=8)
    assert abs(A.accuracy(cfg_t, pt, x, y, device=CPU)
               - JA.accuracy(cfg_j, pj, x, y)) <= 1 / 300
    assert abs(A.attack_success(cfg_t, pt, x, y, device=CPU)
               - JA.attack_success(cfg_j, pj, x, y)) <= 1 / 300


# --------------------------------------------------------------------------
# substitutes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.2, 0.5, 0.8])
@pytest.mark.parametrize("cid", CNN_IDS)
def test_se_substitute_init(cid, ratio):
    cfg_j, cfg_t, pj, pt = _model(cid)
    want, wmasks = JA.se_substitute_init(cfg_j, pj, ratio, seed=4)
    got, masks = A.se_substitute_init(cfg_t, pt, ratio, seed=4, device=CPU)
    assert sorted(masks) == sorted(wmasks)
    for i, m in wmasks.items():
        assert np.array_equal(masks[i].numpy(), np.asarray(m))
    for i, (gp, wp, vp) in enumerate(zip(got, want, pt)):
        assert sorted(gp) == sorted(wp)
        if i not in masks:
            for k in wp:
                assert torch.equal(gp[k], vp[k])
            continue
        enc = _rows(masks[i], vp["w"]).expand_as(vp["w"])
        # plaintext rows: the victim's, bit for bit
        assert torch.equal(gp["w"][~enc], vp["w"][~enc])
        for k in wp:
            w, g = np.asarray(wp[k]), gp[k].numpy()
            if k in ("w", "proj"):
                rel = np.abs(g.astype(np.float64) - w) / np.maximum(
                    np.abs(w), 1e-30)
                assert rel.max() <= NORMAL_REL, (i, k, rel.max())
            else:
                assert np.array_equal(g, w), (i, k)


@pytest.mark.parametrize("rounds", [2, 3])
@pytest.mark.parametrize("cid", CNN_IDS)
def test_jacobian_augment(cid, rounds):
    cfg_j, cfg_t, pj, pt = _model(cid)
    x, _ = _data(40, cfg_t, seed=6)
    xq_j, yq_j = JA.jacobian_augment(cfg_j, pj, x, None, rounds=rounds,
                                     seed=1)
    xq, yq = A.jacobian_augment(cfg_t, pt, x, None, rounds=rounds, seed=1,
                                device=CPU)
    assert xq.shape == xq_j.shape and xq.dtype == xq_j.dtype
    assert yq.dtype == yq_j.dtype == np.int32
    assert np.mean(yq == yq_j) >= 0.99
    n = len(x)
    blocks = lambda a: [a[j * n:(j + 1) * n] for j in range(1 + 2 * rounds)]
    got, want = blocks(xq), blocks(xq_j)
    assert np.array_equal(got[0], want[0])
    for r in range(rounds):         # the jitter rounds depend on x alone
        assert np.array_equal(got[2 + 2 * r], want[2 + 2 * r])
    # the first gradient round: equal wherever the gradients' signs agree
    # (jitted as the reference's own gradient is: XLA's fusions round
    # differently from op-by-op dispatch)
    gj = np.asarray(jax.jit(jax.grad(lambda bx, by: JC.cnn_loss(
        cfg_j, pj, {"x": bx, "y": by})[0]))(x, jnp.asarray(yq_j[:n])))
    gt = A._input_grad(cfg_t, pt, torch.from_numpy(x),
                       torch.from_numpy(yq[:n]).long()).numpy()
    same = np.sign(gj) == np.sign(gt)
    assert np.array_equal(got[1][same], want[1][same])
    assert np.mean(xq == xq_j) >= 0.99


@pytest.mark.parametrize("cid", CNN_IDS)
def test_ifgsm(cid):
    cfg_j, cfg_t, pj, pt = _model(cid)
    x, y = _data(64, cfg_t, seed=9)
    one_j = JA.ifgsm(cfg_j, pj, x, y, iters=1)
    one = A.ifgsm(cfg_t, pt, x, y, iters=1, device=CPU)
    gj = np.asarray(jax.jit(jax.grad(lambda bx, by: JC.cnn_loss(
        cfg_j, pj, {"x": bx, "y": by})[0]))(x, jnp.asarray(y)))
    gt = A._input_grad(cfg_t, pt, torch.from_numpy(x),
                       torch.from_numpy(y).long()).numpy()
    same = np.sign(gj) == np.sign(gt)
    assert np.mean(same) >= 0.999
    assert np.array_equal(one[same], one_j[same])
    ten_j = JA.ifgsm(cfg_j, pj, x, y)
    ten = A.ifgsm(cfg_t, pt, x, y, device=CPU)
    assert ten.shape == x.shape and ten.dtype == np.float32
    assert np.mean(np.abs(ten - ten_j) <= PARAM_REL) >= 0.99
    assert np.abs(ten - x).max() <= 0.12 + 1e-6


@pytest.mark.parametrize("cid", CNN_IDS)
def test_transferability(cid):
    """(fool_victim, fool_sub), the reference's order, within one sample
    for a substitute at other weights."""
    cfg_j, cfg_t, pj, pt = _model(cid)
    sj = JC.init_cnn(cfg_j, jax.random.key(7))
    st = params_from_numpy(jax.tree.map(np.asarray, sj))
    x, y = _data(64, cfg_t, seed=10)
    got = A.transferability(cfg_t, st, pt, x, y, iters=1, device=CPU)
    want = JA.transferability(cfg_j, sj, pj, x, y, iters=1)
    assert len(got) == 2
    assert all(abs(g - w) <= 1 / 64 for g, w in zip(got, want))


def test_otp_reuse_leak_bitwise():
    rng = np.random.RandomState(0)
    words = [rng.randint(0, 2**32, size=(7, 33), dtype=np.uint64)
             .astype(np.uint32) for _ in range(3)]
    words[0][0, :3] = (0, 2**31, 2**32 - 1)
    want = np.asarray(JA.otp_reuse_leak(*words))
    assert np.array_equal(u32.to_numpy(A.otp_reuse_leak(*words)), want)
    tensors = [u32.words(w) for w in words]
    assert np.array_equal(u32.to_numpy(A.otp_reuse_leak(*tensors)), want)
    # the leak reconstructs the second plaintext
    pad, pt_a, pt_b = words
    assert np.array_equal(
        u32.to_numpy(A.otp_reuse_leak(pad ^ pt_a, pad ^ pt_b, pt_a)), pt_b)


# --------------------------------------------------------------------------
# the protocol
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cid", CNN_IDS)
def test_evaluate_tiny(cid):
    kw = dict(n_train=200, n_test=64, epochs=2, sub_epochs=1, ratios=(0.5,))
    want = dataclasses.asdict(JE.evaluate(cid, **kw))
    got = dataclasses.asdict(E.evaluate(cid, device=CPU, **kw))
    assert got["model"] == want["model"] == cid
    for k in ("victim_acc", "white_acc", "black_acc", "white_transfer",
              "black_transfer"):
        assert abs(got[k] - want[k]) <= REPORT_TOL, k
    for k in ("se_acc", "se_transfer"):
        assert sorted(got[k]) == sorted(want[k]) == [0.5]
        assert abs(got[k][0.5] - want[k][0.5]) <= REPORT_TOL, k


def test_evaluate_quick_and_record_on_cpu():
    """``quick`` keeps the reference's sizes; ``evaluate_config`` records
    the victim, each run's wall time and each SE substitute, whose
    plaintext rows stay the victim's through training."""
    cfg = get_reduced("vgg16")
    rec = {}
    rep = E.evaluate_config("vgg16", cfg, n_train=64, n_test=32, epochs=1,
                            sub_epochs=1, ratios=(0.5,), device=CPU,
                            record=rec)
    assert sorted(rec["train_s"]) == ["black", "se_0.5", "victim"]
    init, masks, sub = rec["se"][0.5]
    for i, m in masks.items():
        w = rec["victim"][i]["w"]
        plain = ~_rows(m, w).expand_as(w)
        assert torch.equal(init[i]["w"][plain], w[plain])
        assert torch.equal(sub[i]["w"][plain], w[plain])
    assert all(0.0 <= v <= 1.0 for v in (rep.victim_acc, rep.black_acc,
                                         rep.se_acc[0.5], rep.white_transfer,
                                         rep.black_transfer,
                                         rep.se_transfer[0.5]))


ENTRY_POINTS = {
    "init_cnn": lambda cfg, p, x, y: C.init_cnn(cfg, prng.key(0)),
    "train_cnn": lambda cfg, p, x, y: A.train_cnn(cfg, p, x, y, epochs=1),
    "accuracy": lambda cfg, p, x, y: A.accuracy(cfg, p, x, y),
    "jacobian_augment": lambda cfg, p, x, y: A.jacobian_augment(cfg, p, x, y),
    "se_substitute_init": lambda cfg, p, x, y: A.se_substitute_init(cfg, p,
                                                                    0.5),
    "ifgsm": lambda cfg, p, x, y: A.ifgsm(cfg, p, x, y),
    "attack_success": lambda cfg, p, x, y: A.attack_success(cfg, p, x, y),
    "transferability": lambda cfg, p, x, y: A.transferability(cfg, p, p, x,
                                                              y),
    "evaluate": lambda cfg, p, x, y: E.evaluate("vgg16", n_train=20,
                                                n_test=8),
    "evaluate_config": lambda cfg, p, x, y: E.evaluate_config(
        "vgg16", cfg, n_train=20, n_test=8),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_the_card_by_default(name):
    """``device=None`` means the card: without one every entry point
    raises before it computes anything on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    cfg_j, cfg_t, pj, pt = _model("vgg16")
    x, y = _data(4, cfg_t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](cfg_t, pt, x, y)
