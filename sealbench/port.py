"""Everything the benchmark takes from the program, in one place.

The program is the PyTorch and CUDA port, ``repro_torch``: the serving
engine (``serve/engine.py::ServeEngine``), its step functions
(``serve/step.py``), its launch counters (``kernels/ops.py``) and its kernel
build (``kernels/_build.py``). This module maps a configuration file to the
program's ``ModelConfig``, hands it the benchmark's weights in the tree it
takes (with the constants the program cannot set folded in), and reads the engine's host-side bookkeeping that the per-layer
metrics need. Nothing else in the harness imports the program.
"""
from __future__ import annotations

import inspect
import math
import re
from pathlib import Path
from typing import Dict, List

import numpy as np


def program_eps() -> float:
    """The epsilon of the program's RMSNorm, which its ``ModelConfig``
    cannot set."""
    from repro_torch.models import layers

    return inspect.signature(layers.rmsnorm).parameters["eps"].default


def model_config(c: dict):
    """The program's ``ModelConfig`` for a dense GQA configuration file."""
    from repro_torch.config import ModelConfig

    d, hq = c["hidden_size"], c["num_attention_heads"]
    if c["hidden_act"] != "silu":
        raise ValueError(f"{c['name']}: the program's MLP is gated SiLU, "
                         f"the file states {c['hidden_act']}")
    return ModelConfig(
        name=c["name"], family="dense", num_layers=c["num_hidden_layers"],
        d_model=d, num_heads=hq, num_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim") or d // hq, d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], pattern=("attn",), act="silu",
        tie_embeddings=bool(c.get("tie_word_embeddings", False)),
        rope_theta=float(c["rope_theta"]), dtype=c["dtype"])


def fold_constants(c: dict, w: Dict[str, object]) -> Dict[str, float]:
    """Scale the benchmark's weights, in place, so that the program computes
    the function the configuration file states, though its ``ModelConfig``
    has no RMSNorm epsilon and no multipliers: the program normalises with
    ``program_eps()``, scales attention by ``head_dim ** -0.5`` and
    multiplies nothing.

    Every step is exact in exact arithmetic. The residual stream is carried
    at ``s = sqrt(program_eps / rms_norm_eps)`` times its published size, so
    each RMSNorm, ``x / sqrt(mean(x ** 2) + eps)``, sees the published
    epsilon: the embedding is multiplied by ``embedding_multiplier * s``,
    each block's two output projections by ``residual_multiplier * s``.
    The queries take ``attention_multiplier / head_dim ** -0.5``. The
    logits are divided by ``logits_scaling`` in the head, or, where the
    head is the embedding, in the final norm's weight, which also takes
    back the embedding's factor. Returns the factors."""
    dh = c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]
    s = math.sqrt(program_eps() / c["rms_norm_eps"])
    f = {"embed": c.get("embedding_multiplier", 1.0) * s,
         "residual": c.get("residual_multiplier", 1.0) * s,
         "query": c.get("attention_multiplier", dh ** -0.5) * dh ** 0.5,
         "logits": 1.0 / c.get("logits_scaling", 1.0)}
    w["embed.w"].mul_(f["embed"])
    w["attn.wo"].mul_(f["residual"])
    w["mlp.wo"].mul_(f["residual"])
    w["attn.wq"].mul_(f["query"])
    if "head.w" in w:
        w["head.w"].mul_(f["logits"])
    else:
        # the norm's weight is stored as its offset from one
        w["final_norm.scale"].add_(1.0).mul_(
            f["logits"] / f["embed"]).sub_(1.0)
    return f


def params_tree(c: dict, w: Dict[str, object]):
    """The benchmark's stacked weights as the program's parameter tree, the
    configuration's constants folded in (``fold_constants``: the same
    tensors, scaled in place, no copy)."""
    fold_constants(c, w)
    tree = {"embed": {"w": w["embed.w"]},
            "final_norm": {"scale": w["final_norm.scale"]}}
    if "head.w" in w:
        tree["head"] = {"w": w["head.w"]}
    block = {}
    for name, t in w.items():
        group, leaf = name.split(".")
        if group in ("norm1", "norm2", "attn", "mlp"):
            block.setdefault(group, {})[leaf] = t
    tree["blocks"] = (block,)
    return tree


def make_engine(cfg, params, c: dict, mix: dict, key: bytes, device):
    from repro_torch.config import SealConfig
    from repro_torch.serve.engine import ServeEngine

    seal = dict(c["seal"])
    seal_cache = seal.pop("seal_cache")
    return ServeEngine(cfg, params, batch_slots=mix["slots"],
                       max_len=mix["max_len"], seal=SealConfig(**seal),
                       key_bytes=key, block_size=mix["block_size"],
                       seal_cache=seal_cache,
                       admit_batch=mix.get("admit_batch"),
                       chunk_tokens=mix["chunk_tokens"], device=device)


def build_kernels() -> None:
    """Build every CUDA source of the program that has no up-to-date
    library yet, all at once (a checkout's first run); later runs find
    them built."""
    from repro_torch.kernels import _build

    _build.build_all()


def launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import ops

    return ops.launch_counts()


def step_module():
    from repro_torch.serve import step

    return step


def span_targets(eng) -> List[tuple]:
    """(object, attribute, span name) of each call the spans wrap: the
    scheduler's step, its two dispatch kinds, the tick's one device-to-host
    copy, and the two step functions the dispatches call."""
    st = step_module()
    return [(eng, "step", "engine.step"),
            (eng, "_chunk_tick", "engine.chunk_tick"),
            (eng, "_decode_tick", "engine.decode_tick"),
            (eng, "_fetch", "engine.fetch"),
            (st, "chunk_step", "step.chunk_step"),
            (st, "decode_tick", "step.decode_tick")]


def _mirror(eng, name: str):
    """A host-side field of the engine that the shapes are read from. A
    missing one fails the run: the per-layer metrics that need the shapes
    (``mfu``, the rooflines) would otherwise have nothing to read."""
    try:
        return getattr(eng, name)
    except AttributeError:
        raise RuntimeError(
            f"the program's ServeEngine has no {name!r}; sealbench/port.py "
            f"reads the dispatch shapes from it") from None


def decode_shape(eng) -> dict:
    """The next decode tick as the engine's host mirrors have it: every
    slot's cache length, and which slots decode."""
    lengths = np.asarray(_mirror(eng, "_lengths")).copy()
    running = [r is not None and p is None
               for r, p in zip(_mirror(eng, "_active"),
                               _mirror(eng, "_pending"))]
    return {"kind": "decode", "slots": int(eng.slots),
            "lengths": lengths.tolist(), "running": running,
            "mb": int(eng.max_len // eng.block_size)}


def chunk_shape(eng) -> dict:
    """The next chunked-prefill dispatch: the pending slots it takes (the
    first ``admit width``), each row's chunk length, cache length, and
    whether the chunk ends its prompt."""
    c = int(eng.chunk_tokens)
    pending, lengths = _mirror(eng, "_pending"), _mirror(eng, "_lengths")
    rows = [i for i, p in enumerate(pending) if p is not None]
    rows = rows[:int(_mirror(eng, "_admit_n"))]
    cl = [min(len(pending[i]), c) for i in rows]
    return {"kind": "chunk", "rows": len(rows), "chunk": c, "cl": cl,
            "final": [n == len(pending[i]) for n, i in zip(cl, rows)],
            "lengths": [int(lengths[i]) for i in rows],
            "mb": int(eng.max_len // eng.block_size)}


_GLOBAL = re.compile(r"__global__")
_CALL = re.compile(r"([A-Za-z_]\w*)\s*\(")


def kernel_names() -> List[str]:
    """The name of every ``__global__`` function in the program's CUDA
    sources: the program's own kernels, as the device trace names them."""
    import repro_torch

    csrc = Path(repro_torch.__file__).resolve().parent / "csrc"
    names = []
    for src in sorted(csrc.glob("*.cu")):
        text = src.read_text()
        for m in _GLOBAL.finditer(text):
            for call in _CALL.finditer(text, m.end(), m.end() + 400):
                if call.group(1) != "__launch_bounds__":
                    names.append(call.group(1))
                    break
    return sorted(set(names))
