"""Adversarial attacks + substitute-model construction (paper §3.4). Port of
``repro/core/security/attacks.py``.

Substitute models the adversary can build from bus-snooped data:
  * white-box — no encryption: the victim model verbatim;
  * black-box — full encryption: only the architecture is known; retrain
    from scratch on query data (Jacobian-augmented, paper cites [56]);
  * SE(r)     — smart encryption at ratio r: the (1-r) lowest-|w| rows of
    every SE layer are plaintext; the adversary fills the encrypted rows
    with He-normal noise and fine-tunes ONLY those rows on query data.

Attack: I-FGSM [37] targeted at the substitute, transferred to the victim.

Params are ``models.cnn``'s tree of tensors; images and labels numpy, as
in the reference. Every entry point takes ``device`` (``None``: the card,
through ``resolve_device``) and moves params and data there once; a
training run indexes its device-resident set with the host's permutation.
Gradients come from autograd.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import prng, u32
from repro_torch.config import CNNConfig
from repro_torch.core.criticality import cnn_channel_masks
from repro_torch.device import resolve_device
from repro_torch.models import cnn as CNN


def _on(params, dev, copy: bool = False):
    """The param tree on ``dev`` (detached; copied if ``copy``)."""
    return [{k: v.detach().to(dev, copy=copy) for k, v in p.items()}
            for p in params]


def _row_mask(m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row mask broadcast over a weight: conv (k,k,cin,cout) rows are
    cin, fc (in,out) rows are in."""
    return m[None, None, :, None] if w.ndim == 4 else m[:, None]


def _device_data(x, y, dev):
    return (torch.as_tensor(np.asarray(x, np.float32), device=dev),
            torch.as_tensor(np.asarray(y), device=dev).long())


# --------------------------------------------------------------------------
# training helper (plain SGD-momentum over CNN params, small scale)
# --------------------------------------------------------------------------

def sgd_step(cfg: CNNConfig, params, freeze_masks=None):
    """``train_cnn``'s optimiser: makes ``params``' tensors trainable leaves
    (in place) and returns ``step(bx, by, lr)``, which takes one
    SGD-momentum step on a device batch (``m <- 0.9 m + g; p <- p - lr m``,
    the ``"w"`` gradients of ``freeze_masks``' rows zeroed first) and
    returns the loss."""
    dev = next(v.device for p in params for v in p.values())
    leaves, keep = [], []
    for i, p in enumerate(params):
        for k in sorted(p):
            leaves.append(p[k].requires_grad_(True))
            m = None
            if freeze_masks is not None and i in freeze_masks and k == "w":
                m = _row_mask(freeze_masks[i].to(dev), p[k])
            keep.append(m)
    mom = [torch.zeros_like(t) for t in leaves]
    zero = torch.zeros((), device=dev)
    mu = 0.9

    def step(bx, by, lr):
        loss = CNN.cnn_loss(cfg, params, {"x": bx, "y": by})[0]
        grads = torch.autograd.grad(loss, leaves)
        grads = [g if m is None else torch.where(m, g, zero)
                 for g, m in zip(grads, keep)]
        with torch.no_grad():
            torch._foreach_mul_(mom, mu)
            torch._foreach_add_(mom, grads)
            torch._foreach_add_(leaves, torch._foreach_mul(mom, lr), alpha=-1)
        return loss.detach()

    return step


def train_cnn(cfg: CNNConfig, params, x, y, *, epochs: int = 12,
              batch: int = 128, lr: float = 2e-2, seed: int = 0,
              freeze_masks: Optional[Dict[int, torch.Tensor]] = None,
              device=None):
    """SGD-momentum training. ``freeze_masks``: per-layer input-row masks
    (True = trainable/encrypted rows; False rows keep their values —
    SE fine-tuning keeps the *known* plaintext rows fixed, paper §3.4.1).
    Only ``"w"`` gradients are masked; biases, norms and ``proj`` train.
    Returns new params on ``device``; ``params`` is left as it was."""
    dev = resolve_device(device)
    params = _on(params, dev, copy=True)
    xs, ys = _device_data(x, y, dev)
    n = x.shape[0]
    step = sgd_step(cfg, params, freeze_masks)
    rng = np.random.RandomState(seed)
    steps_per = max(1, n // batch)
    for ep in range(epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        cur_lr = lr * (0.5 ** (ep // 5))
        for s in range(steps_per):
            idx = perm[s * batch:(s + 1) * batch]
            step(xs[idx], ys[idx], cur_lr)
    return _on(params, dev)


def accuracy(cfg: CNNConfig, params, x, y, batch: int = 256,
             device=None) -> float:
    dev = resolve_device(device)
    params = _on(params, dev)
    xs, ys = _device_data(x, y, dev)
    correct = 0
    with torch.no_grad():
        for i in range(0, x.shape[0], batch):
            logits = CNN.cnn_forward(cfg, params, xs[i:i + batch])
            correct += int((logits.argmax(-1) == ys[i:i + batch]).sum())
    return correct / x.shape[0]


def _input_grad(cfg, params, bx, by):
    """d loss / d x of the mean cross-entropy at a device batch."""
    bx = bx.detach().requires_grad_(True)
    loss = CNN.cnn_loss(cfg, params, {"x": bx, "y": by})[0]
    return torch.autograd.grad(loss, bx)[0]


# --------------------------------------------------------------------------
# substitute construction
# --------------------------------------------------------------------------

def jacobian_augment(cfg, victim_params, x, y, rounds: int = 2,
                     lam: float = 0.08, seed: int = 0, device=None):
    """Papernot-style Jacobian-based dataset augmentation: gradient-sign
    perturbations (decision-boundary probing) + Gaussian jitter (on-manifold
    coverage), all labeled by querying the victim."""
    dev = resolve_device(device)
    params = _on(victim_params, dev)

    def fwd(bx):
        with torch.no_grad():
            logits = CNN.cnn_forward(cfg, params, torch.as_tensor(bx,
                                                                  device=dev))
        return logits.argmax(-1).to(torch.int32).cpu().numpy()

    rng = np.random.RandomState(seed)
    xs, ys = [x], [fwd(x)]
    cur = x
    for r in range(rounds):
        g = _input_grad(cfg, params, torch.as_tensor(cur, device=dev),
                        torch.as_tensor(ys[-1], device=dev).long())
        cur = np.clip(cur + lam * np.sign(g.cpu().numpy()),
                      -3, 3).astype(np.float32)
        xs.append(cur)
        ys.append(fwd(cur))
        jit = (x + rng.standard_normal(x.shape).astype(np.float32) *
               0.15 * (r + 1)).astype(np.float32)
        xs.append(jit)
        ys.append(fwd(jit))
    return np.concatenate(xs), np.concatenate(ys).astype(np.int32)


def se_substitute_init(cfg: CNNConfig, victim_params, ratio: float,
                       seed: int = 0, device=None):
    """Adversary's view under SE(ratio): plaintext (low-|w|) rows copied
    from the victim, encrypted rows re-initialized (He normal). Biases and
    norm parameters are always encrypted (tiny but statistics-revealing),
    so they reset to their defaults. Returns (init_params, freeze_masks:
    rows the adversary must LEARN — everything except plaintext rows)."""
    dev = resolve_device(device)
    victim_params = _on(victim_params, dev)
    masks = cnn_channel_masks(cfg, victim_params, ratio)
    key = prng.key(seed).to(dev)
    out = []
    for i, p in enumerate(victim_params):
        if i not in masks or "w" not in p:
            out.append({k: v.clone() for k, v in p.items()})
            continue
        w = p["w"]
        rnd = CNN.he_normal(prng.fold_in(key, i), tuple(w.shape))
        q = dict(p, w=torch.where(_row_mask(masks[i], w), rnd, w))
        # side params are ciphertext: reset to init defaults
        if "b" in q:
            q["b"] = torch.zeros_like(q["b"])
        if "ln_s" in q:
            q["ln_s"] = torch.ones_like(q["ln_s"])
            q["ln_b"] = torch.zeros_like(q["ln_b"])
        if "proj" in q:
            q["proj"] = CNN.he_normal(prng.fold_in(key, 1000 + i),
                                      tuple(q["proj"].shape))
        out.append(q)
    return out, masks


# --------------------------------------------------------------------------
# counter-rollback / OTP-reuse attack primitive
# --------------------------------------------------------------------------

def otp_reuse_leak(ct_a, ct_b, known_pt_a) -> torch.Tensor:
    """What a bus snooper recovers when two plaintexts were sealed under the
    SAME (key, nonce, counter) OTP — e.g. after a counter rollback made a
    re-seal reuse a keystream:

        ct_a ^ ct_b = pt_a ^ pt_b, so knowing pt_a yields pt_b exactly.

    Pure u32 XOR algebra on int64-held words. Takes u32 words as numpy or
    sequences, or as int32 bit-pattern tensors (``repro_torch.u32``);
    returns int32 bit patterns."""
    def as_i64(a):
        return u32.to_i64(a if isinstance(a, torch.Tensor) else u32.words(a))
    return u32.from_i64(as_i64(ct_a) ^ as_i64(ct_b) ^ as_i64(known_pt_a))


# --------------------------------------------------------------------------
# I-FGSM adversarial examples + transferability
# --------------------------------------------------------------------------

def ifgsm(cfg: CNNConfig, params, x, y_true, *, eps: float = 0.12,
          alpha: float = 0.02, iters: int = 10, device=None):
    """Untargeted I-FGSM against ``params``; returns adversarial x."""
    dev = resolve_device(device)
    params = _on(params, dev)
    x0, y = _device_data(x, y_true, dev)
    adv = x0
    for _ in range(iters):
        g = _input_grad(cfg, params, adv, y)
        adv = adv + alpha * torch.sign(g)
        adv = torch.minimum(torch.maximum(adv, x0 - eps), x0 + eps)
    return adv.cpu().numpy()


def attack_success(cfg: CNNConfig, params, adv_x, y_true,
                   device=None) -> float:
    dev = resolve_device(device)
    xs, ys = _device_data(adv_x, y_true, dev)
    with torch.no_grad():
        logits = CNN.cnn_forward(cfg, _on(params, dev), xs)
    return float((logits.argmax(-1) != ys).float().mean())


def transferability(cfg: CNNConfig, sub_params, victim_params, x, y,
                    device=None, **ifgsm_kw):
    """Fraction of substitute-crafted adversarial examples (that fool the
    substitute) which also fool the victim — paper Fig 9's metric. Returns
    (fool_victim, fool_sub), as the reference does."""
    adv = ifgsm(cfg, sub_params, x, y, device=device, **ifgsm_kw)
    fool_sub = attack_success(cfg, sub_params, adv, y, device=device)
    fool_victim = attack_success(cfg, victim_params, adv, y, device=device)
    return fool_victim, fool_sub
