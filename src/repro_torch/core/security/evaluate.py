"""End-to-end security evaluation (paper Figs 8 & 9). Port of
``repro/core/security/evaluate.py``.

Protocol mirrors §3.4.1: the victim trains on 90% of the data; the
adversary holds the other 10%, Jacobian-augments it, labels it by querying
the victim, and builds white-box / black-box / SE(r) substitutes. Fig 8:
substitute accuracy on held-out test data. Fig 9: I-FGSM transferability.

``evaluate`` runs the protocol at a model's reduced config, as the
reference does; ``evaluate_config`` runs it at any ``CNNConfig`` (the
published widths on the card).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from repro_torch import prng
from repro_torch.config import CNNConfig
from repro_torch.configs import get_reduced
from repro_torch.core.security import attacks as A
from repro_torch.data.synthetic import image_dataset
from repro_torch.device import resolve_device
from repro_torch.models import cnn as CNN


@dataclasses.dataclass
class SecurityReport:
    model: str
    victim_acc: float
    white_acc: float
    black_acc: float
    se_acc: Dict[float, float]
    white_transfer: float
    black_transfer: float
    se_transfer: Dict[float, float]


def evaluate(model_id: str = "vgg16", *, n_train: int = 2500,
             n_test: int = 400, ratios=(0.2, 0.4, 0.5, 0.8),
             epochs: int = 15, sub_epochs: int = 12, seed: int = 0,
             quick: bool = False, device=None) -> SecurityReport:
    """The reference's ``evaluate`` at ``get_reduced(model_id)``, on
    ``device`` (``None``: the card)."""
    if quick:
        n_train, n_test, epochs, sub_epochs = 1600, 200, 12, 8
        ratios = (0.2, 0.5)
    return evaluate_config(model_id, get_reduced(model_id), n_train=n_train,
                           n_test=n_test, ratios=ratios, epochs=epochs,
                           sub_epochs=sub_epochs, seed=seed, device=device)


def evaluate_config(model_id: str, cfg: CNNConfig, *, n_train: int = 2500,
                    n_test: int = 400, ratios=(0.2, 0.4, 0.5, 0.8),
                    epochs: int = 15, sub_epochs: int = 12, seed: int = 0,
                    device=None,
                    record: Optional[dict] = None) -> SecurityReport:
    """The protocol at ``cfg``. ``record``, if given, receives the victim
    (``"victim"``), the black-box substitute (``"black"``), each SE
    substitute's init, freeze masks and trained params (``"se"``: ratio ->
    (init, masks, sub)), and each training run's wall seconds (``"train_s"``,
    device work included)."""
    dev = resolve_device(device)

    def train(name, params, xt, yt, n_epochs, **kw):
        t0 = time.perf_counter()
        out = A.train_cnn(cfg, params, xt, yt, epochs=n_epochs, device=dev,
                          **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if record is not None:
            record.setdefault("train_s", {})[name] = time.perf_counter() - t0
        return out

    x, y = image_dataset(n_train + n_test, img=cfg.img_size, seed=seed,
                         noise=0.45)
    xte, yte = x[n_train:], y[n_train:]
    x, y = x[:n_train], y[:n_train]
    # victim: 90% / adversary: 10% (paper's split)
    n_vic = int(0.9 * n_train)
    xv, yv = x[:n_vic], y[:n_vic]
    xa = x[n_vic:]

    victim = train("victim", CNN.init_cnn(cfg, prng.key(seed), device=dev),
                   xv, yv, epochs)
    victim_acc = A.accuracy(cfg, victim, xte, yte, device=dev)

    # adversary's query set (paper: 5k images -> 45k augmented; scaled)
    xq, yq = A.jacobian_augment(cfg, victim, xa, None, rounds=3, seed=seed,
                                device=dev)

    # white-box: the victim itself
    white_acc = victim_acc
    # black-box: blank model trained on query data
    black = train("black",
                  CNN.init_cnn(cfg, prng.key(seed + 1), device=dev),
                  xq, yq, sub_epochs)
    black_acc = A.accuracy(cfg, black, xte, yte, device=dev)

    se_acc, se_sub = {}, {}
    for r in ratios:
        init, masks = A.se_substitute_init(cfg, victim, r, seed=seed,
                                           device=dev)
        sub = train(f"se_{r}", init, xq, yq, sub_epochs, freeze_masks=masks)
        se_acc[r] = A.accuracy(cfg, sub, xte, yte, device=dev)
        se_sub[r] = sub
        if record is not None:
            record.setdefault("se", {})[r] = (init, masks, sub)

    # Fig 9: transferability of substitute-crafted adversarial examples
    n_adv = min(256, n_test)
    wt, _ = A.transferability(cfg, victim, victim, xte[:n_adv], yte[:n_adv],
                              device=dev)
    bt, _ = A.transferability(cfg, black, victim, xte[:n_adv], yte[:n_adv],
                              device=dev)
    se_tr = {r: A.transferability(cfg, se_sub[r], victim,
                                  xte[:n_adv], yte[:n_adv], device=dev)[0]
             for r in ratios}
    if record is not None:
        record.update(victim=victim, black=black)
    return SecurityReport(model_id, victim_acc, white_acc, black_acc, se_acc,
                          wt, bt, se_tr)
