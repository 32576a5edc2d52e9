"""Elastic scaling: resume a run on a DIFFERENT mesh than it stopped on.
Port of ``repro/runtime/elastic.py``.

Checkpoints are host numpy (``checkpoint.manager``), so rescaling is:
  1. build the new mesh from the ranks that are left,
  2. re-derive param/opt specs for that mesh (the rules are pure functions
     of (config, mesh)),
  3. lay the restored host arrays out on it as DTensors, each rank copying
     only its own block of each leaf to its card.

``candidate_meshes`` enumerates the (data, model) factorizations of the
surviving rank count, preferring shapes that keep the model axis intact
(TP resharding moves the most bytes).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint.manager import CheckpointManager, rebuild_tree
from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.sharding import rules


def candidate_meshes(n_devices: int, prefer_model: int = 16
                     ) -> List[Tuple[int, int]]:
    out = []
    for model in range(min(prefer_model, n_devices), 0, -1):
        if n_devices % model == 0:
            out.append((n_devices // model, model))
    return out


def rescale(cfg: ModelConfig, ckpt: CheckpointManager,
            ranks: Optional[Sequence[int]] = None, model_axis: int = 0):
    """Restore the latest checkpoint onto a ("data", "model") mesh over
    ``ranks`` (the whole world when None; every rank of the world calls
    this, a rank outside the mesh gets empty shards), on the checkpoint
    manager's device type.

    Returns (step, params, opt_state, mesh)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size())) if ranks is None \
        else list(ranks)
    n = len(ranks)
    cands = candidate_meshes(n)
    if model_axis:
        cands = [c for c in cands if c[1] == model_axis] or cands
    data, model = cands[0]
    mesh = DeviceMesh(ckpt.device.type,
                      torch.tensor(ranks[:data * model]).reshape(data, model),
                      mesh_dim_names=("data", "model"))

    step, host = ckpt.restore()
    pspec = T.param_spec(cfg)
    params = rebuild_tree(pspec, host["params"],
                          (mesh, rules.param_pspecs(cfg, mesh)))
    opt = rebuild_tree(adamw.init(pspec), host["opt"],
                       (mesh, rules.opt_pspecs(cfg, mesh))) \
        if "opt" in host else None
    return step, params, opt, mesh
