"""Top-level LM: init, the training forward, the one-shot prefill and the
contiguous-cache decode step, for attention, MoE, RG-LRU and SSD patterns.
Port of ``init_params``, ``param_spec``, ``_embed``, ``_unembed``,
``_run_layers`` (modes ``train``, ``prefill`` and ``decode``), ``forward``,
``prefill_hidden``, ``prefill``, ``apply_cache_updates`` and
``decode_step`` from ``repro/models/transformer.py``.

``init_params`` builds the reference's tree (same paths, shapes and scales)
from a ``torch.Generator``; its numbers differ from ``jax.random``'s, so the
tests feed both packages converted JAX weights instead
(``repro_torch.convert``). The reference's ``lax.scan`` over super-blocks is
a Python loop over layers (here and in ``models/paged.py``). The serving
paths take the token tensor itself where the reference takes a ``batch``
dict; ``forward`` takes the reference's dict (``tokens`` or, for a
frontend-stub config, ``embeds``, and ``targets``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.core.sealed_tensor import SealedTensor, slice_layer
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import cache as MC
from repro_torch.models import layers as L
from repro_torch.sharding.api import constrain, dtensor_scope, is_dtensor
from repro_torch.tree import leaves, map_leaves, unflatten


def init_params(cfg: ModelConfig, seed: int = 0, device=None, lay=None):
    """Random f32 params, shaped like the reference's ``init_params``.

    ``lay(path, leaf)``, when given, receives each leaf as soon as it is
    made, in the generator's order, and what it returns is kept in the tree
    in the leaf's place (``sharding.rules.init_params`` keeps the rank's
    block, so a fresh sharded start never holds more than one whole leaf);
    the numbers are the same either way."""
    dev = resolve_device(device)
    return _init(cfg, dev, torch.Generator(device=dev).manual_seed(seed),
                 lay)


def param_spec(cfg: ModelConfig):
    """Shape/dtype tree of the params without allocating: the same tree as
    ``init_params`` of tensors on the ``meta`` device (the reference's
    ``jax.eval_shape``)."""
    return _init(cfg, torch.device("meta"), None)


def _init(cfg: ModelConfig, dev: torch.device, gen, lay=None):
    n = cfg.n_superblocks()
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, dh = cfg.heads_eff, cfg.num_kv_heads, cfg.head_dim
    lay = lay or (lambda path, t: t)

    def normal(path, shape, scale, dead=None):
        t = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32).mul_(scale)
        if dead is not None:         # padded heads, zeroed in place
            t.masked_fill_(dead, 0.0)
        return lay(path, t)

    def fill(path, shape, value):
        return lay(path, torch.full(shape, value, dtype=torch.float32,
                                    device=dev))

    def norm(path, shape=(n, d)):
        if cfg.norm == "layernorm":
            return {"scale": fill(path + ("scale",), shape, 1.0),
                    "bias": fill(path + ("bias",), shape, 0.0)}
        return {"scale": fill(path + ("scale",), shape, 0.0)}

    params = {"embed": {"w": normal(("embed", "w"), (v, d), d ** -0.5)},
              "final_norm": norm(("final_norm",), (d,))}
    if not cfg.tie_embeddings:
        params["head"] = {"w": normal(("head", "w"), (d, v), d ** -0.5)}

    def mlp(path):
        if cfg.moe is not None:     # (n, e, ...) experts and their router
            e = cfg.moe.num_experts
            return {"router": normal(path + ("router",), (n, d, e),
                                     d ** -0.5),
                    "wi": normal(path + ("wi",), (n, e, d, f), d ** -0.5),
                    "wg": normal(path + ("wg",), (n, e, d, f), d ** -0.5),
                    "wo": normal(path + ("wo",), (n, e, f, d), f ** -0.5)}
        return {"wi": normal(path + ("wi",), (n, d, f), d ** -0.5),
                "wg": normal(path + ("wg",), (n, d, f), d ** -0.5),
                "wo": normal(path + ("wo",), (n, f, d), f ** -0.5)}

    def const(path, row):            # one row per super-block
        return lay(path, row.to(dev)[None].repeat(n, 1))

    def rec(path):                   # RG-LRU (Griffin)
        w = cfg.rglru_block_width or d
        ramp = torch.linspace(0.9, 0.999, w, dtype=torch.float32)
        lam = torch.log(torch.expm1(ramp ** -(1 / B._RGLRU_C) - 1 + 1e-8))
        return {"w_x": normal(path + ("w_x",), (n, d, w), d ** -0.5),
                "w_gate": normal(path + ("w_gate",), (n, d, w), d ** -0.5),
                "conv_w": normal(path + ("conv_w",), (n, 4, w), 0.1),
                "conv_b": fill(path + ("conv_b",), (n, w), 0.0),
                "w_rg": normal(path + ("w_rg",), (n, w, w), w ** -0.5),
                "b_rg": fill(path + ("b_rg",), (n, w), 0.0),
                "w_ig": normal(path + ("w_ig",), (n, w, w), w ** -0.5),
                "b_ig": fill(path + ("b_ig",), (n, w), 0.0),
                "lam": const(path + ("lam",), lam),
                "w_out": normal(path + ("w_out",), (n, w, d), w ** -0.5)}

    def ssd(path):                   # Mamba2 SSD
        di, ns, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(1e-1))
        u = torch.rand((n, h), generator=gen, device=dev) * (hi - lo) + lo
        return {"w_in": normal(path + ("w_in",), (n, d, 2 * di + 2 * ns + h),
                               d ** -0.5),
                "conv_w": normal(path + ("conv_w",),
                                 (n, cfg.ssm_conv, di + 2 * ns), 0.1),
                "conv_b": fill(path + ("conv_b",), (n, di + 2 * ns), 0.0),
                "A_log": const(path + ("A_log",), torch.log(torch.arange(
                    1, h + 1, dtype=torch.float32))),
                "D": fill(path + ("D",), (n, h), 1.0),
                "dt_bias": lay(path + ("dt_bias",),
                               torch.log(torch.expm1(torch.exp(u)))),
                "norm_scale": fill(path + ("norm_scale",), (n, di), 0.0),
                "w_out": normal(path + ("w_out",), (n, di, d), di ** -0.5)}

    def attention(path):
        dq = do = None
        if hq > cfg.num_heads:
            # heads padded WITHIN each GQA group (zero heads at each
            # group's tail), as the reference pads them: the q-head ->
            # kv-head assignment is unchanged and the padded heads start
            # as exact no-ops
            dead = ~(torch.arange(hq // hkv, device=dev)
                     < cfg.num_heads // hkv).repeat(hkv)
            dq, do = dead[:, None], dead[:, None, None]
        return {"wq": normal(path + ("wq",), (n, d, hq, dh), d ** -0.5, dq),
                "wk": normal(path + ("wk",), (n, d, hkv, dh), d ** -0.5),
                "wv": normal(path + ("wv",), (n, d, hkv, dh), d ** -0.5),
                "wo": normal(path + ("wo",), (n, hq, dh, d),
                             (cfg.num_heads * dh) ** -0.5, do)}

    blocks = []
    for j, kind in enumerate(cfg.pattern):
        path = ("blocks", str(j))
        blk = {"norm1": norm(path + ("norm1",))}
        if kind in ("attn", "local_attn"):
            blk["attn"] = attention(path + ("attn",))
        elif kind == "rglru":
            blk["rec"] = rec(path + ("rec",))
        elif kind == "ssd":
            blk["ssd"] = ssd(path + ("ssd",))
        else:
            raise ValueError(kind)
        if kind != "ssd" and cfg.d_ff:
            blk["norm2"] = norm(path + ("norm2",))
            blk["mlp"] = mlp(path + ("mlp",))
        blocks.append(blk)
    params["blocks"] = tuple(blocks)
    return params


def _embed(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """The input activations in the compute dtype. ``batch``: the token
    tensor (B, S) of the serving paths (the embedding's rows gathered, then
    cast; a sealed embedding's through the gather kernel), or the training
    batch dict: a frontend-stub config's ``embeds``, else the rows of the
    embedding cast whole to the compute dtype, as the reference takes them,
    so that the backward sums repeated tokens' rows in that dtype too."""
    dt = L.cdtype(cfg)
    w = params["embed"]["w"]
    if is_dtensor(w):
        if isinstance(batch, dict) and cfg.frontend is not None:
            x = batch["embeds"].to(dt)
        else:
            tokens = batch["tokens"] if isinstance(batch, dict) else batch
            x = _lookup(w.to(dt), tokens)
        return constrain(x, "batch", None, None)
    if isinstance(batch, dict):
        if cfg.frontend is not None:
            return batch["embeds"].to(dt)
        return w.to(dt)[batch["tokens"]]
    if isinstance(w, SealedTensor):   # the serving view keeps it line-sealed
        return w.gather_rows(batch, dt)
    return w[batch].to(dt)


def _lookup(w, tokens):
    """The rows of DTensor ``w`` (vocab, d) at DTensor ``tokens``, on each
    rank's own tokens, without making the table whole where its vocab is
    split: the split of ``d`` is gathered (FSDP's weight gather), each rank
    looks its ids up in its own block of the vocab (ids outside it give
    zero rows) and the rows are summed over the axes that split the vocab
    (``Partial``). An odd vocab, replicated, has ``d`` alone gathered. The
    gradient of the rank's block is summed over the axes that split the
    tokens and reduced onto ``w``'s layout in the backward."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = w.device_mesh
    tok_pls = [pl if isinstance(pl, Shard) else Replicate()
               for pl in tokens.placements]
    # per mesh dim: the table keeps a split of the vocab unless the tokens
    # are split there too (then that dim's vocab is gathered)
    vocab = [type(pl) is Shard and pl.dim == 0 and isinstance(tp, Replicate)
             for pl, tp in zip(w.placements, tok_pls)]
    tab_pls = [Shard(0) if v else Replicate() for v in vocab]
    grad_pls = [Partial() if isinstance(tp, Shard) else tab
                for tp, tab in zip(tok_pls, tab_pls)]
    out_pls = [tp if isinstance(tp, Shard) else Partial() if v
               else Replicate() for tp, v in zip(tok_pls, vocab)]
    tab = w.redistribute(mesh, tab_pls).to_local(grad_placements=grad_pls)
    tok = tokens.redistribute(mesh, tok_pls).to_local()
    rows, lo = tab.shape[0], 0
    coord = mesh.get_coordinate()
    for i, v in enumerate(vocab):
        if v:
            lo = lo * mesh.shape[i] + coord[i]
    lo *= rows
    if rows == w.shape[0]:
        x = tab[tok]
    else:
        ids = tok - lo
        own = (ids >= 0) & (ids < rows)
        x = torch.where(own[..., None], tab[ids.clamp(0, rows - 1)], 0)
    return DTensor.from_local(x, mesh, out_pls, run_check=False)


def _unembed(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    dt = L.cdtype(cfg)
    if cfg.tie_embeddings:
        w = params["embed"]["w"]
        logits = L.plain_matmul(x.reshape(-1, x.shape[-1]), w.T, dt)
        logits = logits.reshape(tuple(x.shape[:-1]) + (w.shape[0],)).to(dt)
    else:
        # the head may arrive still sealed (tile layout) on the serving path
        logits = L.dense(x.to(dt), params["head"]["w"], "bsd,dv->bsv", dt)
    logits = constrain(logits.float(), "batch", None, "vocab")
    return L.softcap(logits, cfg.logit_softcap)


def layer_params(params, j: int, i: int):
    """Pattern position j's params of super-block i (a sealed leaf stays
    sealed: ``slice_layer`` takes its slice)."""
    return map_leaves(lambda t: slice_layer(t, i), params["blocks"][j])


def _unstacked(tree, n: int) -> list:
    """The n per-layer trees of a stacked tree, by one ``unbind`` a leaf:
    its backward stacks the n layers' gradients once, where n slices would
    each scatter into a zero tensor of the whole stack."""
    cols = [t.unbind(0) for t in leaves(tree)]
    return [unflatten(tree, [c[i] for c in cols]) for i in range(n)]


def _run_layers(cfg: ModelConfig, params, x, positions, mode, cache,
                remat: str = "none"):
    """The super-block stack. train: returns (x, aux), the MoE layers'
    auxiliary loss summed in layer order (f32); ``remat`` "full" and
    "save_carries" both run each super-block under
    ``torch.utils.checkpoint``, which keeps only its input (the reference's
    ``save_only_these_names()`` with no names saves only the scan's carry)
    and recomputes the rest in the backward. prefill: ``cache`` is the
    empty contiguous cache that gives each layer its slot count; returns
    (x, filled cache). decode: returns (x, per pattern position the update
    stacked over super-blocks, as the reference's scan emits it: an
    attention layer's {"k_new", "v_new"} (n_super, B, 1, kv_heads,
    head_dim), a recurrent layer's whole new state) for
    ``apply_cache_updates``."""
    if mode == "train":
        return _run_train_layers(cfg, params, x, positions, remat)
    outs = [[] for _ in cfg.pattern]
    for i in range(cfg.n_superblocks()):
        for j, kind in enumerate(cfg.pattern):
            c = {key: t[i] for key, t in cache[j].items()}
            x, out, _ = B.block_apply(cfg, kind, layer_params(params, j, i),
                                      x, positions, mode, c)
            outs[j].append(out)
    return x, tuple({key: torch.stack([o[key] for o in oj]) for key in oj[0]}
                    for oj in outs)


def _run_train_layers(cfg: ModelConfig, params, x, positions, remat: str):
    if remat not in ("none", "save_carries", "full"):
        raise ValueError(f"unknown remat {remat!r}")
    n = cfg.n_superblocks()
    layers = [_unstacked(blk, n) for blk in params["blocks"]]

    def body(i, h, aux):
        # a DTensor stack recomputes under remat outside ``forward``'s
        # scope, so the scope is entered here too
        with dtensor_scope(h):
            for j, kind in enumerate(cfg.pattern):
                h, _, a = B.block_apply(cfg, kind, layers[j][i], h,
                                        positions, "train", None)
                aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        if remat == "none":
            x, aux = body(i, x, aux)
        else:
            x, aux = checkpoint(body, i, x, aux, use_reentrant=False)
    return x, aux


def forward(cfg: ModelConfig, params, batch, *, remat: str = "none"):
    """Training/eval forward. batch: {tokens | embeds, targets}. Returns
    (loss, metrics) with the CE loss in f32: ``logsumexp`` of the f32
    logits less the gold logit, averaged, plus the MoE auxiliary loss;
    ``accuracy`` by argmax (the first of tied maxima, as ``jnp.argmax``)."""
    with dtensor_scope(params["embed"]["w"]):
        x = _embed(cfg, params, batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        x, aux = _run_layers(cfg, params, x, positions, "train", None, remat)
        x = L.apply_norm(cfg, params["final_norm"], x)
        logits = _unembed(cfg, params, x)
        targets = batch["targets"].long()
        logz = torch.logsumexp(logits, dim=-1)
        gold, hit = _gold_and_hit(logits, targets)
        ce = (logz - gold).mean()
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux, "accuracy": hit.float().mean()}


def _gold_and_hit(logits, targets):
    """The gold logit and whether the argmax hits the target. Over DTensor
    logits, whose vocab may be sharded, the gold logit is a masked sum
    (exact: one term is not zero), so that it gathers no logits across
    devices."""
    if not is_dtensor(logits):
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        return gold, logits.argmax(dim=-1) == targets
    ids = _vocab_ids(logits)
    onehot = targets[..., None] == ids
    gold = torch.where(onehot, logits, torch.zeros_like(logits)).sum(-1)
    return gold, _argmax(logits) == targets


def _vocab_ids(logits):
    """arange(V) as a DTensor laid out as the logits' vocab axis."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    vocab = Shard(logits.ndim - 1)
    return distribute_tensor(
        torch.arange(logits.shape[-1], device=logits.to_local().device),
        logits.device_mesh,
        [Shard(0) if pl == vocab else Replicate()
         for pl in logits.placements], src_data_rank=None)


def _argmax(logits):
    """``argmax`` over the last axis, the first of tied maxima. Over
    DTensors, the least index that attains the max (two reductions that
    shard as the vocab does, where DTensor's argmax gathers candidates)."""
    if not is_dtensor(logits):
        return torch.argmax(logits, dim=-1)
    ids = _vocab_ids(logits)
    top = logits.amax(dim=-1, keepdim=True)
    return torch.where(logits == top, ids,
                       torch.full_like(ids, logits.shape[-1])).amin(-1)


def prefill_hidden(cfg: ModelConfig, params, tokens: torch.Tensor,
                   cache_len: int):
    """Prompt pass up to the final norm over tokens (B, S) at positions
    ``arange(S)``: (normed hidden (B, S, D), contiguous cache)."""
    with dtensor_scope(params["embed"]["w"]):
        x = _embed(cfg, params, tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        cache0 = MC.model_cache_init(cfg, x.shape[0], cache_len, x.device)
        x, cache = _run_layers(cfg, params, x, positions, "prefill", cache0)
        return L.apply_norm(cfg, params["final_norm"], x), cache


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache_len: int):
    """Run the prompt; returns (logits at the last position (B, V) f32,
    cache)."""
    x, cache = prefill_hidden(cfg, params, tokens, cache_len)
    with dtensor_scope(x):
        return _unembed(cfg, params, x[:, -1:])[:, 0], cache


def apply_cache_updates(cfg: ModelConfig, cache, updates, pos: int):
    """Write each attention layer's new K/V at slot ``pos % cache_len`` (the
    ring of a sliding window) and mark the slot with ``pos``; a recurrent
    layer's state is replaced wholesale. Updates ``cache`` IN PLACE, where
    the reference builds a new one, so a decode step copies one token's K/V
    per layer and not the cache; returns it."""
    for kind, cj, uj in zip(cfg.pattern, cache, updates):
        if kind not in ("attn", "local_attn"):
            for key, t in cj.items():
                t.copy_(uj[key])
            continue
        slot = pos % cj["k"].shape[2]
        cj["k"][:, :, slot] = uj["k_new"][:, :, 0]
        cj["v"][:, :, slot] = uj["v_new"][:, :, 0]
        cj["pos"][:, slot] = pos
    return cache


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                pos: int):
    """One serve step: tokens (B, 1) at position ``pos`` (a host int)
    against the contiguous cache, which is updated in place. Returns
    (logits (B, V) f32, cache, next_token (B,) greedy)."""
    with dtensor_scope(params["embed"]["w"]):
        x = _embed(cfg, params, tokens)
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=x.device)
        x, updates = _run_layers(cfg, params, x, positions, "decode", cache)
        cache = apply_cache_updates(cfg, cache, updates, pos)
        x = L.apply_norm(cfg, params["final_norm"], x)
        logits = _unembed(cfg, params, x)[:, 0]
        return logits, cache, _argmax(logits)
