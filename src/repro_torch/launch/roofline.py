"""Roofline of step records on the card. Port of
``repro/launch/roofline.py`` (``model_flops``, ``roofline_row``,
``build_table``, ``render_markdown``), with the card's constants
(``repro_torch.config.HW``: an NVIDIA H100) in place of the TPU's.

Per record:
  compute term    = flops_per_device / peak bf16 FLOP/s
  memory term     = bytes_per_device / HBM bandwidth
  collective term = collective_bytes_per_device / (links x NVLink bandwidth)
The reference's records come from compiled HLO; the port's
(``launch.sealed_dryrun``) count a step's FLOPs and bytes from its shapes
and run on one card, so their collective bytes are 0.

MODEL_FLOPS = the useful math: 6*N_active*T for train, 2*N_active*T +
causal attention for prefill, 2*N_active*B + cache attention for decode.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import List, Optional

from repro_torch.config import HW, SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs import get_config, get_reduced

# NVLink's data-sheet rate is the card's total over all its links, so the
# collective term divides by it once
NVLINK_LINKS = 1


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful-math FLOPs per step (global, all devices)."""
    n_active = cfg.param_count(active_only=True)
    n_embed = cfg.vocab_size * cfg.d_model
    n_matmul = n_active - n_embed          # embedding gather is not a matmul
    kinds = cfg.layer_kinds()
    n_attn_layers = sum(1 for k in kinds if k == "attn")
    n_local_layers = sum(1 for k in kinds if k == "local_attn")
    hd = cfg.num_heads * cfg.head_dim

    if shape.kind == "train":
        toks = shape.seq_len * shape.global_batch
        base = 6.0 * n_matmul * toks
        # attention scores+values, causal half, fwd(2) + bwd(4)
        attn = 6.0 * shape.global_batch * hd * (
            n_attn_layers * shape.seq_len ** 2 / 2
            + n_local_layers * shape.seq_len * min(cfg.window or shape.seq_len,
                                                   shape.seq_len) / 1)
        return base + attn
    if shape.kind == "prefill":
        toks = shape.seq_len * shape.global_batch
        base = 2.0 * n_matmul * toks
        attn = 2.0 * shape.global_batch * hd * (
            n_attn_layers * shape.seq_len ** 2 / 2
            + n_local_layers * shape.seq_len * min(cfg.window or shape.seq_len,
                                                   shape.seq_len))
        return base + attn
    # decode: one token per sequence against the cache
    base = 2.0 * n_matmul * shape.global_batch
    cache = shape.seq_len
    attn = 2.0 * shape.global_batch * hd * (
        n_attn_layers * cache
        + n_local_layers * min(cfg.window or cache, cache)) * 2
    return base + attn


def _cell(rec: dict):
    """The config and shape a record ran: the reduced config where the
    record says so (``"config": "reduced"``), and its ``batch`` where the
    shape's global batch was cut."""
    arch = rec["arch"]
    cfg = get_reduced(arch) if rec.get("config") == "reduced" \
        else get_config(arch)
    shape = SHAPES[rec["shape"]]
    if "batch" in rec:
        shape = dataclasses.replace(shape, global_batch=rec["batch"])
    return cfg, shape


def roofline_row(rec: dict) -> Optional[dict]:
    """The three terms, the bottleneck and the useful share of one record
    (None unless its status is ok). ``collective_bytes_per_device`` may be
    the reference's per-kind dict or one number."""
    if rec.get("status") != "ok":
        return None
    cfg, shape = _cell(rec)
    flops_dev = rec["flops_per_device"]
    bytes_dev = rec.get("bytes_per_device",
                        rec.get("bytes_accessed_scaled", 0.0))
    coll = rec["collective_bytes_per_device"]
    coll_dev = sum(coll.values()) if isinstance(coll, dict) else coll
    t_comp = flops_dev / HW["peak_flops_bf16"]
    t_mem = bytes_dev / HW["hbm_bw"]
    t_coll = coll_dev / (NVLINK_LINKS * HW["nvlink_bw"])
    dom = max((t_comp, "compute"), (t_mem, "memory"), (t_coll, "collective"))
    mf = model_flops(cfg, shape)
    hlo_global = flops_dev * rec["devices"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "bottleneck": dom[1],
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_ratio": mf / hlo_global if hlo_global else 0.0,
        # roofline fraction: useful work rate vs peak if the dominant term
        # were fully utilized
        "roofline_fraction": (mf / rec["devices"] / HW["peak_flops_bf16"]) /
                             max(dom[0], 1e-30),
        "collectives": coll,
        "memory_gib": ((rec["memory"]["temp_bytes"] +
                        rec["memory"]["argument_bytes"]) / 2**30
                       if rec.get("memory") else None),
    }


def build_table(result_dir: str = "results/dryrun", mesh: str = "16x16"
                ) -> List[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(result_dir, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if rec.get("mesh") != mesh:
            continue
        row = roofline_row(rec)
        if row:
            rows.append(row)
    return rows


def render_markdown(rows: List[dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | bound | "
           "MODEL/HLO | roofline frac | mem GiB |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"{r['bottleneck']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2f} | {r['memory_gib']:.1f} |\n")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    rows = build_table(a.dir, a.mesh)
    if a.json:
        print(json.dumps(rows, indent=1))
    else:
        print(render_markdown(rows))


if __name__ == "__main__":
    main()
