"""Sealed decode on the card: the paper's own scenario, the decode step
with the weights sealed under five schemes, built from a real parameter
tree and run. Port of ``repro/launch/sealed_dryrun.py`` by function
(``_leaf_lines``, ``synthetic_masks``, ``sealed_decode_variant``,
``main``): the reference lowers and compiles the step for a 256-chip mesh
and reads the compiled HLO; here it runs on one device and is timed.

Variants, the paper's schemes:

  baseline    — plaintext weights (the paper's insecure Baseline)
  counter     — counter mode with a separate counter table, full encryption
  coloe       — ColoE (counters inline, 34-word records), full encryption
  coloe_se    — ColoE + Smart Encryption at ratio r with the layout split:
                a leaf's first ``int(lines * r)`` lines are ciphertext, the
                rest plaintext lines that skip the engine
  coloe_fused — ColoE + SE where the matmul leaves that
                ``sealed_store.tile_geometry`` accepts are tile-sealed under
                the structural mask and reach the fused decrypt-in-matmul
                kernel still sealed; the other leaves decrypt first

The ``counter``, ``coloe`` and ``coloe_fused`` images are the store's own
leaves (``sealed_store._seal_lines`` and ``_seal_tiles``), and their step is
the store's builder, ``serve.step.make_sealed_decode_step``: unfused
(``unseal_params``) for the first two, fused (``fused_params``) for the
third. ``coloe_se`` splits a leaf at rest, a layout the store lacks, so its
step unseals the ciphertext part itself before ``make_decode_step``. Every
line leaf is sealed under its path's nonce from address 0 at write counter
0; a step decrypts each leaf that has ciphertext lines with one
``lines_unseal`` launch on the card. SE masks are structural (the first
ceil(r * rows) rows of each SE leaf; the embedding and head fully
encrypted), as in the reference.

The record keeps the reference's keys where they keep their meaning
(``stored_param_bytes_global``, ``plaintext_bytes_materialized_per_step``,
``kv_cache_plaintext_bytes_per_step``, ``fused_matmul_leaves``). Its
``flops_per_device`` is ``roofline.model_flops`` of the cell on one device
and its ``bytes_per_device`` the step's counted bytes (the image read, the
materialized plaintext written and read, the KV cache read): counted from
the shapes, not measured. The compiler's numbers give way to measured ones:
``step_ms`` (CUDA events on the card, the median), ``peak_gib`` and
``arg_gib``; ``collective_bytes_per_device`` is 0 on one device.

    PYTHONPATH=src python -m repro_torch.launch.sealed_dryrun \\
        --arch granite_3_2b --variant all --reduced --device cpu --batch 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.config import SHAPES, ModelConfig, SealConfig, ShapeConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import coloe as CL
from repro_torch.core import engine as E
from repro_torch.core import plan as P
from repro_torch.core import sealed_store as SS
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import roofline
from repro_torch.models import cache as MC
from repro_torch.models import transformer as T
from repro_torch.serve.step import make_decode_step, make_sealed_decode_step
from repro_torch.tree import flatten_with_path, map_leaves, unflatten

VARIANTS = ("baseline", "counter", "coloe", "coloe_se", "coloe_fused")
KEY = bytes(range(32))
_COLOE_VARIANTS = ("coloe", "coloe_se", "coloe_fused")


def _leaf_lines(leaf) -> int:
    words = -(-leaf.numel() * leaf.element_size() // 4)
    return -(-words // CL.WORDS_PER_LINE)


def synthetic_masks(pspec, seal: SealConfig):
    """Structural SE ratios per leaf path: ``seal.smart_ratio`` for an SE
    leaf (its first ceil(r * rows) rows encrypted), None for a fully
    encrypted one (the embedding, the head, every unclassified leaf)."""
    plans = {}
    for pt, leaf in flatten_with_path(pspec):
        path = "/".join(pt)
        cls = P._classify(pt, leaf.ndim)
        boundary = pt[0] in ("embed", "head")
        if cls is None or seal.smart_ratio >= 1.0 or boundary:
            plans[path] = None          # fully encrypted
        else:
            plans[path] = seal.smart_ratio
    return plans


@dataclasses.dataclass
class _Leaf:
    """One leaf of a variant's image: its layout and byte accounting."""
    shape: tuple
    dtype: torch.dtype
    plan: P.LeafPlan
    lines: int
    enc_lines: int
    stored: int              # bytes at rest, by the reference's formula
    plaintext: int           # bytes the step materializes
    st: Optional[SS.SealedTensor] = None     # the store's line or tile leaf
    ct: Optional[E.SealedBuffer] = None      # coloe_se: the ciphertext lines
    pt: Optional[torch.Tensor] = None        # coloe_se: the plaintext lines

    @property
    def tiled(self) -> bool:
        return self.st is not None and self.st.meta.layout == "tiles"

    def tensors(self):
        """The buffers at rest."""
        if self.st is not None:
            return [t for t in (self.st.payload, self.st.counters,
                                self.st.row_mask, self.st.key_words,
                                self.st.wc) if t is not None]
        ct = [] if self.ct is None else [self.ct.payload]
        return ct + ([] if self.pt is None else [self.pt])


def _seal_leaf(eng, variant: str, seal: SealConfig, pt, leaf,
               ratio) -> _Leaf:
    """The leaf in the variant's layout (``sealed_dryrun.py:115-176`` of
    the reference: the same line counts, record widths and bytes). The
    fully encrypted line leaves and the tile leaves are the store's own
    (``sealed_store._seal_lines``, ``_seal_tiles``); a ``coloe_se`` leaf is
    split at rest, which the store has no layout for."""
    path = "/".join(pt)
    lines = _leaf_lines(leaf)
    full = P.LeafPlan(path, "full", (), (), None, 0, 0)
    geom = (SS.tile_geometry(pt, tuple(leaf.shape), leaf.dtype, seal)
            if variant == "coloe_fused" else None)
    if geom is not None:
        nb, _, _, k, _, _, _ = geom
        lead = tuple(leaf.shape[:nb])
        rows = k if ratio is None else math.ceil(ratio * k)
        mask = (torch.arange(k, device=leaf.device) < rows).expand(
            lead + (k,)).contiguous()
        plan = P.LeafPlan(path, "rows", tuple(range(nb)), (nb,), mask, 0, 0)
        n_lead = 1
        for d in lead:
            n_lead *= d
        # tile layout: no per-line counter area, the SE mask 1 B a row
        return _Leaf(tuple(leaf.shape), leaf.dtype, plan, lines, lines,
                     leaf.numel() * 4 + n_lead * k, 0,
                     st=SS._seal_tiles(eng, seal, leaf, plan, path, geom))
    if variant == "baseline":
        enc = 0
    elif variant in ("counter", "coloe", "coloe_fused"):
        enc = lines
    else:                                   # coloe_se: layout split
        enc = lines if ratio is None else int(lines * ratio)
    plain = lines - enc
    words_per = (CL.COLOE_LINE_WORDS if variant in _COLOE_VARIANTS
                 else CL.WORDS_PER_LINE)
    stored = (enc * words_per + plain * CL.WORDS_PER_LINE
              + (enc * 2 if variant == "counter" else 0)) * 4
    lf = _Leaf(tuple(leaf.shape), leaf.dtype, full, lines, enc, stored,
               0 if variant == "baseline" else
               leaf.numel() * leaf.element_size())
    if variant == "baseline":
        lf.pt = leaf
    elif variant != "coloe_se":
        lf.st = SS._seal_lines(eng, seal, leaf, full, path)
    else:
        data, _ = CL.pad_to_lines(E.tensor_to_words(leaf)[0])
        if enc:
            lf.ct = eng.encrypt(data[:enc].reshape(-1),
                                nonce2=SS._nonce2(path))
        if plain:
            lf.pt = data[enc:]
    return lf


def _unseal_split(eng, lf: _Leaf):
    """A ``coloe_se`` leaf as the step reads it: its ciphertext lines
    unsealed (one ``lines_unseal``), its plaintext lines appended, the
    words cast back to the leaf."""
    parts = [] if lf.ct is None else [eng.decrypt(lf.ct)]
    if lf.pt is not None:
        parts.append(lf.pt.reshape(-1))
    words = parts[0] if len(parts) == 1 else torch.cat(parts)
    return E.words_to_tensor(words, lf.shape, lf.dtype)


@dataclasses.dataclass
class DecodeState:
    """What the variants of one run share: the config and (cut) shape, the
    plaintext params they seal, the contiguous cache filled up to slot
    ``pos`` (every step decodes at ``pos`` and its write there is undone
    after it), the step's batch, and each variant's first-step logits."""
    cfg: ModelConfig
    shape: ShapeConfig
    config: str                      # "reduced" | "published"
    reduced: list                    # what was cut, for the record
    params: dict
    cache: tuple
    batch: dict
    pos: int
    logits: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        """Undo a step's cache write: slot ``pos`` empty again."""
        for kind, cj in zip(self.cfg.pattern, self.cache):
            if kind in ("attn", "local_attn"):
                cj["pos"][:, self.pos % cj["pos"].shape[1]] = MC.INVALID_POS


def decode_state(arch: str, shape_name: str, reduced: bool = False,
                 batch: Optional[int] = None, dtype: Optional[str] = None,
                 device=None, seed: int = 0) -> DecodeState:
    """Params from ``seed`` (``transformer.init_params``), the contiguous
    cache of the shape's ``seq_len`` slots with K/V drawn from ``seed``
    and every slot but the last filled (the step decodes at the last),
    and a batch of random tokens (frontend archs: embeddings). ``batch``
    cuts the shape's global batch; ``dtype`` overrides the config's
    compute dtype."""
    dev = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    cuts = ["config: reduced"] if reduced else []
    if dtype is not None:
        cfg = cfg.with_(dtype=dtype)
    shape = SHAPES[shape_name]
    if shape.kind != "decode":
        raise ValueError(f"{shape_name} is a {shape.kind} shape; the sealed "
                         f"decode step takes a decode shape")
    if batch is not None and batch != shape.global_batch:
        cuts.append(f"global_batch {shape.global_batch} -> {batch}")
        shape = dataclasses.replace(shape, global_batch=batch)
    params = T.init_params(cfg, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    b, s = shape.global_batch, shape.seq_len
    cache = MC.model_cache_init(cfg, b, s, dev)
    pos = s - 1
    for kind, cj in zip(cfg.pattern, cache):
        for key, t in cj.items():
            if key == "pos":
                t[:, :pos] = torch.arange(pos, dtype=torch.int32, device=dev)
            else:
                for layer in t:            # one layer at a time
                    layer.normal_(generator=gen)
    if cfg.frontend is not None:
        inputs = {"embeds": torch.randn((b, 1, cfg.d_model), generator=gen,
                                        device=dev).to(getattr(torch,
                                                               cfg.dtype))}
    else:
        inputs = {"tokens": torch.randint(0, cfg.vocab_size, (b, 1),
                                          generator=gen, device=dev)}
    return DecodeState(cfg, shape, "reduced" if reduced else "published",
                       cuts, params, cache, inputs, pos)


def _delta(before, after) -> Dict[str, int]:
    """The kernels launched between two ``ops.launch_counts()``."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _written(leaves, image) -> int:
    """Bytes of the step's plaintext leaves that are not views of the
    image's buffers: what the step wrote to device memory."""
    stored = {t.untyped_storage().data_ptr()
              for lf in image for t in lf.tensors()}
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor)
               and t.untyped_storage().data_ptr() not in stored)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _clock(dev):
    """(start, stop -> ms): CUDA events on the card, the host clock on the
    CPU."""
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()

        def stop():
            b.record()
            b.synchronize()
            return a.elapsed_time(b)
        return stop
    t0 = time.perf_counter()
    return lambda: 1e3 * (time.perf_counter() - t0)


def sealed_decode_variant(arch: str, shape_name: str, variant: str,
                          ratio: float = 0.5, reduced: bool = False, *,
                          batch: Optional[int] = None, dtype=None,
                          device=None, seed: int = 0,
                          state: Optional[DecodeState] = None,
                          warmup: int = 2, iters: int = 10,
                          probe: Optional[Callable] = None) -> dict:
    """Seal the params under ``variant``, run its decode step ``warmup`` +
    ``iters`` times (the first step's logits kept in ``state.logits``, its
    kernel launches and the plaintext bytes it wrote counted, as are the
    sealing's launches) and return the record. ``state`` (from
    ``decode_state``) lets several variants share one set of params and
    one cache; ``probe``, if given, is called with a function that runs one
    more step, and what it returns is kept under ``"probe"``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")
    if state is None:
        state = decode_state(arch, shape_name, reduced, batch, dtype, device,
                             seed)
    cfg, dev = state.cfg, state.cache[0]["pos"].device
    seal = SealConfig(mode="counter" if variant == "counter" else "coloe",
                      smart_ratio=ratio)
    eng = E.make_engine(seal.mode, KEY, dev)
    ratios = synthetic_masks(state.params, seal)
    flat = flatten_with_path(state.params)
    counts0 = ops.launch_counts()
    t0 = time.perf_counter()
    image = {"/".join(pt): _seal_leaf(eng, variant, seal, pt, leaf,
                                      ratios["/".join(pt)])
             for pt, leaf in flat}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seal_s = time.perf_counter() - t0
    seal_launches = _delta(counts0, ops.launch_counts())
    if variant in ("baseline", "coloe_se"):
        decode = make_decode_step(cfg)

        def view():
            return [lf.pt if variant == "baseline" else _unseal_split(eng, lf)
                    for lf in image.values()]

        def run():
            return decode(unflatten(state.params, view()), state.cache,
                          state.batch, state.pos)
    else:
        # the store's image through its builder: every leaf decrypted
        # first, or with ``fused`` the line leaves only
        fused = variant == "coloe_fused"
        sp = SS.SealedParams({p: lf.st for p, lf in image.items()},
                             {p: lf.plan for p, lf in image.items()},
                             map_leaves(lambda _: None, state.params), seal,
                             {KEY: eng})
        decode = make_sealed_decode_step(cfg, sp, KEY, fused=fused)

        def view():
            tree = (SS.fused_params if fused else SS.unseal_params)(sp, KEY)
            return [t for _, t in flatten_with_path(tree)]

        def run():
            return decode(sp.tensors, state.cache, state.batch, state.pos)

    def step():
        out = run()
        state.reset()
        return out

    args = [t for lf in image.values() for t in lf.tensors()]
    args += [t for cj in state.cache for t in cj.values()]
    args += list(state.batch.values())
    arg_bytes = _nbytes(args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    counts0 = ops.launch_counts()
    logits = step()[0]
    launches = _delta(counts0, ops.launch_counts())
    state.logits[variant] = logits.float().cpu()
    # the step's own view, made once more outside its launch count
    written = _written(view(), image.values())
    for _ in range(warmup - 1):
        step()
    times = []
    for _ in range(iters):
        stop = _clock(dev)
        step()
        times.append(stop())
    peak = temp = None
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        temp = peak - before
    rec_probe = probe(step) if probe is not None else None

    kv_bytes = _nbytes(t for cj in state.cache for t in cj.values())
    stored = sum(lf.stored for lf in image.values())
    plaintext = sum(lf.plaintext for lf in image.values())
    tiles = [lf for lf in image.values() if lf.tiled]
    rec = {
        "arch": arch, "shape": shape_name, "variant": variant, "ratio": ratio,
        "config": state.config, "batch": state.shape.global_batch,
        "reduced": list(state.reduced), "dtype": cfg.dtype,
        "status": "ok", "mesh": "1", "devices": 1,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "seal_s": seal_s,
        "flops_per_device": roofline.model_flops(cfg, state.shape),
        "bytes_per_device": stored + 2 * plaintext + kv_bytes,
        "collective_bytes_per_device": 0,
        "stored_param_bytes_global": stored,
        "plaintext_bytes_materialized_per_step": plaintext,
        "kv_cache_plaintext_bytes_per_step": kv_bytes,
        "fused_matmul_leaves": len(tiles),
        "fused_matmul_slices": sum(lf.shape[0] if lf.st.meta.n_batch
                                   else 1 for lf in tiles),
        "unsealed_line_leaves": sum(1 for lf in image.values()
                                    if lf.enc_lines and not lf.tiled),
        "plaintext_bytes_written": written,
        "launches_per_step": launches, "seal_launches": seal_launches,
        "step_ms": statistics.median(times), "step_ms_each": times,
        "peak_gib": None if peak is None else peak / 2**30,
        "arg_gib": arg_bytes / 2**30,
        "memory": (None if peak is None else
                   {"argument_bytes": arg_bytes, "temp_bytes": temp}),
    }
    if rec_probe is not None:
        rec["probe"] = rec_probe
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--variant", default="all")
    ap.add_argument("--ratio", type=float, default=0.5)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (CI smoke)")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the shape's global batch to this")
    ap.add_argument("--dtype", default=None,
                    help="compute dtype in place of the config's")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/sealed_decode.json")
    args = ap.parse_args(argv)
    variants = VARIANTS if args.variant == "all" else [args.variant]
    state = decode_state(args.arch, args.shape, args.reduced, args.batch,
                         args.dtype, args.device, args.seed)
    out = []
    for v in variants:
        rec = sealed_decode_variant(args.arch, args.shape, v, args.ratio,
                                    args.reduced, state=state)
        print(json.dumps(rec))
        out.append(rec)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
