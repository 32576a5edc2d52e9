"""Multi-pod dry run: one step of an (arch x shape) cell on the production
mesh, counted per device. Port of ``repro/launch/dryrun.py``.

    python -m repro_torch.launch.dryrun --arch granite_3_2b \\
        --shape decode_32k [--multi-pod] [--out results/dryrun_torch]

The reference lowers and compiles each cell for 256 (or 512) forced host
devices and reads the compiled HLO. Here one process starts the ``fake``
process group of 512 ranks (no data moves, collectives return at once),
builds the 16x16 or 2x16x16 ``DeviceMesh`` over it, lays the parameters,
optimizer state, batch and caches out by ``sharding.rules`` as DTensors
whose shards are ``meta`` tensors (shapes only, nothing allocated), and
runs the train, prefill or decode step once under ``launch.step_stats``:
FLOPs of the device's local products, the unfused bytes its ops read and
write, collective bytes by kind and the peak of live op results.

The record keeps the reference's fields that ``launch.roofline`` reads
(``status``, ``devices``, ``mesh``, ``flops_per_device``,
``bytes_per_device``, ``collective_bytes_per_device``, ``memory`` with
``argument_bytes`` and ``temp_bytes``); ``run_s`` is the step's host time
and ``collective_sources_per_device`` the collective bytes by kind and
source (``step_stats``).
``memory.temp_bytes`` is the peak of the step's live op results, the
arguments excluded (there is no buffer assignment to read).
``"plan": "dtensor-eager"`` marks the counts as those of the port's eager
DTensor plan, not of the reference's compiled GSPMD program. Its regions
without a sharding rule (``sharding.api.local_call``: the MoE slots,
dispatch and combine, the RG-LRU and SSD conv and scan) run on each
device's own shard of the batch, as ``shard_map`` regions would, the MoE
dispatch into a buffer summed over the batch axes; its embedding lookup
gathers only the ``d`` split of the table and reads each device's vocab
block. What still parts the counts from GSPMD's is DTensor's propagation
of the plain ops between them (a masked ``torch.where`` over sharded
attention scores gathers them, for one), and the MoE combine, which reads
the expert outputs whole.
``run_cell(..., reduced=True, mesh=...)`` runs a reduced config
(``"config": "reduced"`` in the record) on any mesh: the CPU tests' fake
4x2 and 1x1.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.config import SHAPES, TrainConfig, cell_supported
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.launch import step_stats
from repro_torch.launch.inputs import batch_specs, input_specs
from repro_torch.launch.mesh import init_distributed, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve.step import make_decode_step
from repro_torch.sharding import rules
from repro_torch.sharding.api import P, mesh_sizes, use_mesh
from repro_torch.train.step import make_prefill_step, make_train_step
from repro_torch.tree import leaves

WORLD = 512


def _dp_size(mesh) -> int:
    sizes = mesh_sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size() for t in leaves(tree))


def _mesh_name(mesh) -> str:
    return "x".join(map(str, mesh.shape))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             microbatches: int = 0, remat: str = "full", *,
             reduced: bool = False, mesh=None) -> dict:
    """One cell's record. ``mesh``: the production mesh when None (the
    fake group must be up, ``init_distributed(fake=True, world_size=512)``,
    as ``main`` starts it)."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh),
           "kind": shape.kind}
    if reduced:
        rec["config"] = "reduced"
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    t0 = time.time()
    dp = _dp_size(mesh)
    pspec = T.param_spec(cfg)
    params = rules.distribute_tree(pspec, mesh, rules.param_pspecs(
        cfg, mesh, serving=(shape.kind == "decode")))
    b_specs = batch_specs(cfg, shape, shape.kind)
    b_ps = rules.batch_pspecs(cfg, mesh, shape.kind)
    # batch dims that do not divide dp (e.g. long_500k batch=1): replicate
    b_ps = {k: P(*([None] * b_specs[k].ndim)) if b_specs[k].shape[0] % dp
            else s for k, s in b_ps.items()}
    batch = rules.distribute_tree(b_specs, mesh, b_ps)

    if shape.kind == "train":
        mb = microbatches or max(1, min(shape.global_batch // dp, 16))
        rec["microbatches"] = mb
        step = make_train_step(cfg, TrainConfig(microbatches=mb, remat=remat))
        opt = rules.distribute_tree(adamw.init(pspec), mesh,
                                    rules.opt_pspecs(cfg, mesh))
        args = (params, opt, batch)
    elif shape.kind == "prefill":
        rec["batch_chunks"] = 1
        step = make_prefill_step(cfg, cache_len=shape.seq_len, batch_chunks=1)
        args = (params, batch)
    else:  # decode
        step = make_decode_step(cfg)
        cache = rules.distribute_tree(
            input_specs(cfg, shape)["cache"], mesh,
            rules.cache_pspecs(cfg, mesh, shape.global_batch, shape.seq_len))
        args = (params, cache, batch, shape.seq_len - 1)

    run_rules = rules.arch_rules(cfg, mesh)
    md = mesh_sizes(mesh).get("model", 1)
    if shape.kind == "train" and shape.seq_len % md == 0:
        # sequence-parallel residual stream (activation-memory lever)
        run_rules["seq_res"] = "model"
    arg_bytes = _local_bytes([a for a in args if not isinstance(a, int)])
    with use_mesh(mesh, run_rules), step_stats.StepStats() as st:
        out = step(*args)
        del out
    stats = st.totals()
    rec.update(
        status="ok",
        plan="dtensor-eager",
        devices=mesh.size(),
        run_s=time.time() - t0,
        flops_per_device=stats["flops"],
        bytes_per_device=stats["bytes"],
        collective_bytes_per_device=stats["collectives"],
        collective_sources_per_device=stats["collective_sources"],
        memory=dict(argument_bytes=arg_bytes,
                    temp_bytes=stats["peak_bytes"]),
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    cells = [(a, s) for a in ([args.arch] if args.arch else ARCH_IDS)
             for s in ([args.shape] if args.shape else list(SHAPES))]
    if args.list:
        for a, s in cells:
            print(a, s)
        return 0

    init_distributed("cpu", fake=True, world_size=WORLD)
    os.makedirs(args.out, exist_ok=True)
    name = "2x16x16" if args.multi_pod else "16x16"
    for a, s in cells:
        tag = f"{a}__{s}__{'mp' if args.multi_pod else 'sp'}"
        path = os.path.join(args.out, tag + ".json")
        try:
            rec = run_cell(a, s, args.multi_pod,
                           microbatches=args.microbatches, remat=args.remat)
        except Exception as e:  # record failures, keep going
            rec = {"arch": a, "shape": s, "status": "error", "mesh": name,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        keys = ["arch", "shape", "mesh", "status"] + \
            (["run_s"] if "run_s" in rec else []) + \
            (["error"] if "error" in rec else [])
        print(json.dumps({k: rec[k] for k in keys}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
