"""PartitionSpec tables: params, optimizer state, inputs, caches. Port of
``repro/sharding/rules.py``: the same specs, leaf for leaf, for every
architecture and mesh.

Strategy: FSDP over ``data`` x TP over ``model`` x DP over ``pod``. Weight
matrices shard their input dim over ``data`` (ZeRO-3 style gather-on-use)
and their output/head/expert dim over ``model``. Dims that do not divide
the mesh axis are replicated instead (``_maybe``).

The tables read only the mesh's axis names and sizes, so they take a
``DeviceMesh`` or a ``MeshShape``. ``distribute_tree`` is the counterpart
of the reference's ``jax.device_put(tree, to_named(mesh, specs))``; a
spec's placements are ``sharding.api.placements``. ``place`` and
``zeros_tree`` build a DTensor from the rank's own block alone, so that a
restore or a fresh AdamW state never holds a whole leaf on a card;
``init_params`` draws a fresh start leaf by leaf, keeping each leaf's block
before the next is drawn.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.cache import model_cache_spec
from repro_torch.sharding.api import P, mesh_sizes, placements, relax_views
from repro_torch.tree import flatten_with_path, leaves, unflatten


def _maybe(axis: Optional[str], dim: int, size: int):
    if axis is None:
        return None
    if dim % size == 0:
        return axis
    return None


def arch_rules(cfg: ModelConfig, mesh) -> dict:
    """Per-arch logical-axis overrides: shardings must divide exactly, so
    archs whose head count doesn't divide the `model` axis shard the
    head_dim instead (deepseek 56H, gemma2 8H, internvl 14H, musicgen 24H
    on a 16-way axis), and odd vocabularies replicate their embeddings."""
    md = mesh_sizes(mesh).get("model", 1)
    rules = {}
    if cfg.heads_eff and cfg.heads_eff % md:
        rules["heads"] = None
        rules["head_dim"] = "model" if cfg.head_dim % md == 0 else None
    else:
        rules["head_dim"] = None
    if cfg.num_kv_heads and cfg.num_kv_heads % md:
        rules["kv_heads"] = None
        rules["kv_head_dim"] = "model" if cfg.head_dim % md == 0 else None
    else:
        rules["kv_head_dim"] = None
    if cfg.vocab_size % md:
        rules["vocab"] = None
    if cfg.moe is not None and cfg.moe.num_experts % md:
        rules["expert"] = None
    return rules


def param_pspecs(cfg: ModelConfig, mesh, serving: bool = False):
    """PartitionSpec tree mirroring ``transformer.init_params``.

    serving=True: weights-stationary decode — drop the FSDP (`data`) axis
    on weight input dims when the TP-sharded copy fits the memory budget,
    so decode steps stop all-gathering weights every layer."""
    sizes = mesh_sizes(mesh)
    md = sizes.get("model", 1)
    dt = sizes.get("data", 1)
    no_fsdp = False
    if serving:
        per_dev = cfg.param_count() * 4 / max(md, 1)
        no_fsdp = per_dev <= 4e9  # fits comfortably next to the KV cache
    pod = sizes.get("pod", 1)
    # ZeRO-over-pod: block params/opt shard their layer-stack axis across
    # pods (compute sees whole layers; grads reduce-scatter to the owning
    # pod).
    stk = "pod" if (pod > 1 and cfg.n_superblocks() % pod == 0) else None

    def fsdp(dim):
        if no_fsdp:
            return None
        return _maybe("data", dim, dt)

    def tp(dim):
        return _maybe("model", dim, md)

    d, v = cfg.d_model, cfg.vocab_size
    spec = T.param_spec(cfg)

    def classify(names, leaf):
        nd = len(leaf.shape)
        top = names[0]
        name = names[-1]
        parent = names[-2] if len(names) >= 2 else ""
        if top == "embed":
            if tp(v):
                return P("model", fsdp(d))
            # odd vocab (granite/internvl/mamba2): shard d over both axes
            both = d % (md * dt) == 0
            return P(None, ("model", "data") if both else (tp(d) or fsdp(d)))
        if top == "head":
            return P(fsdp(d), tp(v))
        if top == "final_norm":
            return P(*([None] * nd))
        # block leaves: leading axis = layer stack
        if parent == "attn":
            h, kvh, dh = cfg.heads_eff, cfg.num_kv_heads, cfg.head_dim
            # shard heads over `model` when divisible, else head_dim
            h_ax, hd_ax = (tp(h), None) if h % md == 0 else (None, tp(dh))
            kv_ax, kvd_ax = (tp(kvh), None) if kvh % md == 0 else (None, tp(dh))
            if name == "wq":
                return P(stk, fsdp(d), h_ax, hd_ax)
            if name in ("wk", "wv"):
                return P(stk, fsdp(d), kv_ax, kvd_ax)
            if name == "wo":
                return P(stk, h_ax, hd_ax, fsdp(d))
        if parent == "mlp":
            f = cfg.d_ff
            if name == "router":
                return P(stk, fsdp(d), None)
            if nd == 4:  # MoE (n, e, din, dout)
                # 2D expert parallelism: experts over `model`, FF over
                # `data`
                e = cfg.moe.num_experts
                if name in ("wi", "wg"):
                    return P(stk, tp(e), None, fsdp(f))
                if name == "wo":
                    return P(stk, tp(e), fsdp(f), None)
            if name in ("wi", "wg"):
                return P(stk, fsdp(d), tp(f))
            if name == "wo":
                return P(stk, tp(f), fsdp(d))
        if parent == "rec":
            w = cfg.rglru_block_width or d
            if name in ("w_x", "w_gate"):
                return P(stk, fsdp(d), tp(w))
            if name in ("w_rg", "w_ig"):
                return P(stk, tp(w), None)
            if name == "w_out":
                return P(stk, tp(w), fsdp(d))
            if name == "conv_w":
                return P(stk, None, tp(w))
            if name in ("conv_b", "b_rg", "b_ig", "lam"):
                return P(stk, tp(w))
        if parent == "ssd":
            di = cfg.ssm_d_inner
            z = 2 * di + 2 * cfg.ssm_state + cfg.ssm_heads
            if name == "w_in":
                return P(stk, fsdp(d), tp(z))
            if name == "w_out":
                return P(stk, tp(di), fsdp(d))
            if name == "conv_w":
                return P(stk, None, tp(di + 2 * cfg.ssm_state))
            if name == "conv_b":
                return P(stk, tp(di + 2 * cfg.ssm_state))
            if name == "norm_scale":
                return P(stk, tp(di))
        return P(*([None] * nd))

    return unflatten(spec, [classify(path, leaf)
                            for path, leaf in flatten_with_path(spec)])


def opt_pspecs(cfg: ModelConfig, mesh):
    """AdamW state mirrors the params (m, v) + replicated step counter."""
    ps = param_pspecs(cfg, mesh)
    return {"m": ps, "v": ps, "step": P()}


def batch_pspecs(cfg: ModelConfig, mesh, kind: str):
    names = tuple(mesh_sizes(mesh))
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp = dp if dp else None
    tok = P(dp, None)
    emb = P(dp, None, None)
    out = {}
    if cfg.frontend is not None:
        out["embeds"] = emb
    else:
        out["tokens"] = tok
    if kind == "train":
        out["targets"] = tok
    return out


def cache_pspecs(cfg: ModelConfig, mesh, batch: int, cache_len: int):
    """Decode caches: batch over dp (when divisible), seq over model
    (context-parallel decode), tiny recurrent states replicated on model."""
    sizes = mesh_sizes(mesh)
    dp_names = tuple(a for a in ("pod", "data") if a in sizes)
    dp_size = 1
    for a in dp_names:
        dp_size *= sizes[a]
    dp = dp_names if (dp_names and batch % dp_size == 0) else None
    md = sizes.get("model", 1)

    def one(name, shape):
        if name in ("k", "v"):
            return P(dp, _maybe("model", shape[1], md), None, None)
        if name == "pos":
            return P(_maybe("model", shape[0], md))
        if name == "state":      # SSD state (b, h, p, n)
            return P(dp, None, None, None)
        if name == "h":          # RG-LRU state (b, w)
            return P(dp, _maybe("model", shape[-1], md))
        if name == "conv":       # conv tail (b, k-1, c)
            return P(dp, None, _maybe("model", shape[-1], md))
        return P(*([None] * len(shape)))

    spec = model_cache_spec(cfg, batch, cache_len)
    # skip the leading layer-stack axis of the stacked cache
    return unflatten(spec, [P(None, *one(path[-1], tuple(leaf.shape[1:])))
                            for path, leaf in flatten_with_path(spec)])


def _spec_leaves(spec_tree) -> list:
    """The specs of a spec tree in flatten order (a ``P`` is a tuple, so
    ``tree.leaves`` would walk into it)."""
    if isinstance(spec_tree, P):
        return [spec_tree]
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree)
                for s in _spec_leaves(spec_tree[k])]
    return [s for v in spec_tree for s in _spec_leaves(v)]


def local_block(shape, mesh, pls):
    """This rank's block of a tensor of ``shape`` laid out by the placements
    ``pls``: one ``slice`` a dim, or ``None`` on a rank outside the mesh.
    Read off DTensor's own split of each dim's positions (a small index
    tensor a dim), so that it is the block ``distribute_tensor`` keeps;
    ``_StridedShard`` included."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    if mesh.get_coordinate() is None:
        return None
    out = []
    for d, n in enumerate(shape):
        pos = torch.arange(n).reshape([n if i == d else 1
                                       for i in range(len(shape))])
        own = [p if getattr(p, "dim", None) == d else Replicate()
               for p in pls]
        idx = distribute_tensor(pos, mesh, own, src_data_rank=None) \
            .to_local().reshape(-1).tolist()
        lo = idx[0] if idx else 0
        if idx != list(range(lo, lo + len(idx))):
            raise NotImplementedError(
                f"placements {pls} give dim {d} a block that is not one run")
        out.append(slice(lo, lo + len(idx)))
    return tuple(out)


def _from_block(shape, mesh, spec, make_local):
    """A DTensor of global ``shape`` on ``mesh`` laid out by ``spec`` whose
    local tensor is ``make_local(block)`` (``block`` from ``local_block``,
    None outside the mesh): only this rank's block is ever built."""
    import torch
    from torch.distributed.tensor import DTensor

    relax_views()
    pls = placements(mesh, spec, len(shape))
    local = make_local(local_block(shape, mesh, pls))
    stride, acc = [], 1
    for n in reversed(shape):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def place(value, mesh, spec, dtype, device):
    """A whole host array (or tensor) as a DTensor on ``mesh`` laid out by
    ``spec``, in ``dtype`` on ``device``: the rank slices its own block on
    the host and copies that alone to the device, so a restore or a fresh
    layout never puts the whole value on a card."""
    import numpy as np
    import torch

    def make_local(block):
        if block is None:
            return torch.empty((0,), dtype=dtype, device=device)
        if isinstance(value, np.ndarray):
            # a fresh C-ordered copy of the block (``...`` keeps a 0-d
            # value an array)
            part = np.array(value[block + (...,)], order="C")
            return torch.from_numpy(part).to(device=device, dtype=dtype)
        whole = all(b.stop - b.start == n for b, n in zip(block, value.shape))
        # a block smaller than the value is copied, so that the shard holds
        # no reference to the whole value
        return value[block].to(device=device, dtype=dtype, copy=not whole)
    return _from_block(tuple(value.shape), mesh, spec, make_local)


def distribute_tree(tree, mesh, spec_tree):
    """Each leaf of ``tree`` as a DTensor on ``mesh`` laid out by its spec.
    Every rank passes the same whole tensor and keeps its own block (no
    communication; the whole leaf can be freed after); a ``meta`` leaf
    stays ``meta``."""
    return unflatten(tree, [place(t, mesh, s, t.dtype, t.device) for s, t in
                            zip(_spec_leaves(spec_tree), leaves(tree))])


def init_params(cfg: ModelConfig, seed: int, mesh, device):
    """``transformer.init_params(cfg, seed)`` laid out on ``mesh`` by
    ``param_pspecs``, one leaf at a time: each leaf is drawn whole, in the
    generator's order, the rank keeps its block (``place``) and the leaf is
    freed before the next is drawn. A rank holds its blocks and one whole
    leaf at most, and each block equals the same block of the unsharded
    ``init_params(cfg, seed)`` bit for bit."""
    specs = {path: s for (path, _), s in zip(
        flatten_with_path(T.param_spec(cfg)),
        _spec_leaves(param_pspecs(cfg, mesh)))}
    return T.init_params(cfg, seed, device, lay=lambda path, t: place(
        t, mesh, specs[path], t.dtype, t.device))


def zeros_tree(template, mesh, spec_tree, device):
    """Zeros shaped like ``template``'s leaves (``meta`` ones included) as
    DTensors on ``mesh`` laid out by ``spec_tree``, each rank allocating
    its own block only: a fresh AdamW state on a mesh."""
    import torch

    def one(s, t):
        def make_local(block):
            shape = (0,) if block is None else \
                tuple(b.stop - b.start for b in block)
            return torch.zeros(shape, dtype=t.dtype, device=device)
        return _from_block(tuple(t.shape), mesh, s, make_local)
    return unflatten(template, [one(s, t) for s, t in
                                zip(_spec_leaves(spec_tree), leaves(template))])
