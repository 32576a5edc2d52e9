#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--report out.json]

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (printing
``-Xptxas -v``), prints the card's name and power limit, and then runs:

1. the ChaCha20 kernel against its plain PyTorch version, bitwise;
2. the fused decrypt-in-matmul kernel against its plain version at the
   full-width internlm2-1.8B shapes (wq, MLP wi/wo, LM head);
3. sealed continuous-batching serving of internlm2-1.8B at full width (ColoE,
   SE ratio 0.5, fused decrypt, sealed KV cache): 8 greedy requests through
   ``ServeEngine``, launch counts read around that run, the first decode
   tick's logits held against a plaintext engine's on the same tokens (in
   bf16, and in f32 where only sum order separates the two), and a
   reduced-size run on the card held against the CPU plain path;
4. CUDA-event timings of both kernels and of one decode tick, each beside the
   least time the card could take for the same work.

Every phase raises on failure, so the script exits non-zero. The line before
the last is a JSON ``{"kernels": [...]}`` record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/`` beside it, it exits non-zero and prints no result.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA's data sheet), at the full 700 W
# power limit. The data sheet gives no integer rate. Its 67 TFLOP/s of f32
# outside the tensor cores is 132 SMs x 128 lanes x 2 FLOP
# (an FMA) x 1.98 GHz: one 32-lane warp instruction per clock in each of an
# SM's four schedulers. No 32-bit operation issues faster than that, so
# 132 x 128 x 1.98e9 = 33.5e12 32-bit integer operations per second is the
# ceiling the ChaCha rounds are held to.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
BF16_FLOPS = 989e12
CHACHA_OPS = 976          # 20 rounds x 4 quarter-rounds x 12 ops + 16 adds
CHACHA_XOR_OPS = 16       # XOR of one block into 16 ciphertext words

SM_REPLACES = "src/repro/kernels/sealed_matmul.py:94"
CC_REPLACES = "src/repro/kernels/chacha20.py:91"

# the serve phase: slots, requests and new tokens per request
SLOTS, REQUESTS, NEW_TOKENS = 4, 8, 16
# Kernel vs plain version, either compute dtype: both round the same operands
# and sum in f32, so only the order of the sums separates them.
KERNEL_TOL = 1e-4


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes, int_ops=0.0, bf16_flops=0.0):
    """Least time for the work: the larger of bytes over the memory rate and
    each kind of operation over its peak rate. Returns (ms, bound_by)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(int_ops / INT32_OPS_PER_S, bf16_flops / BF16_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default="",
                    help="also write every measured number to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1

    from repro_torch.kernels import _build
    t0 = time.time()
    reports = _build.build_all()
    log(f"[build] {time.time() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "ptxas" in line or "up to date" in line:
                log(f"[build:{name}] {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)

    report = {"card": card, "device": torch.cuda.get_device_name(0)}
    dev = torch.device("cuda")
    from repro_torch.device import resolve_device
    resolve_device(dev)
    report["chacha"] = phase_chacha(torch, dev, args.seed)
    report["sealed_matmul"] = phase_sealed_matmul(torch, dev, args.seed)
    report["serve"] = phase_serve(torch, dev, args)
    report["timing"] = phase_timing(torch, dev, args, report)

    t = report["timing"]
    kernels = [
        {"name": "sealed_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/sealed_matmul.cu",
         "replaces": SM_REPLACES,
         "launches": report["serve"]["launches"]["sealed_matmul"],
         "max_abs_err": report["sealed_matmul"]["max_abs_err"],
         "ms": t["sealed_matmul"]["ms"],
         "plain_ms": t["sealed_matmul"]["plain_ms"],
         "bound_ms": t["sealed_matmul"]["bound_ms"],
         "bound_by": t["sealed_matmul"]["bound_by"],
         "library_ms": None,
         "shape": t["sealed_matmul"]["shape"]},
        {"name": "chacha20", "route": "cuda",
         "source": "src/repro_torch/csrc/chacha20.cu",
         "replaces": CC_REPLACES,
         "launches": report["serve"]["launches"]["chacha20"],
         "max_abs_err": report["chacha"]["max_abs_err"],
         "ms": t["chacha20"]["ms"],
         "plain_ms": t["chacha20"]["plain_ms"],
         "bound_ms": t["chacha20"]["bound_ms"],
         "bound_by": t["chacha20"]["bound_by"],
         "library_ms": None,
         "shape": t["chacha20"]["shape"]},
    ]
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# --------------------------------------------------------------------------
# phase 1: ChaCha20 kernel vs plain, bitwise
# --------------------------------------------------------------------------

def _rand_words(torch, gen, shape, dev):
    return torch.randint(-2**31, 2**31, shape, generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)


def phase_chacha(torch, dev, seed):
    from repro_torch import u32
    from repro_torch.kernels import chacha20 as CC
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    key = _rand_words(torch, gen, (8,), dev)
    cases = 0
    for n in (1, 255, 256, 257, 1000, 65_537):
        for per_block in (False, True):
            for start in (0, 2**32 - 100, None):
                if start is None:
                    ctr = _rand_words(torch, gen, (n,), dev)
                else:
                    ctr = u32.from_i64(torch.arange(start, start + n,
                                                    device=dev))
                nz = _rand_words(torch, gen, (n, 3) if per_block else (3,),
                                 dev)
                got = CC.chacha20_blocks_cuda(key, ctr, nz)
                want = CC.chacha20_blocks_plain(key, ctr, nz)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"chacha20 kernel != plain at n={n} "
                        f"per_block={per_block} start={start}")
                cases += 1
    nz = _rand_words(torch, gen, (3,), dev)
    got = ops.keystream(key, nz, 777, counter0=12345)
    want = ref.chacha20_keystream_ref(
        key, nz, u32.from_i64(torch.arange(12345, 12345 + 777, device=dev)))
    if got.shape != (16, 777) or not torch.equal(got, want):
        raise AssertionError("ops.keystream != chacha20_keystream_ref")
    log(f"[chacha] {cases + 1} cases bitwise equal to the plain version")
    return {"cases": cases + 1, "max_abs_err": 0}


# --------------------------------------------------------------------------
# phase 2: sealed_matmul kernel vs plain at the main path's shapes
# --------------------------------------------------------------------------

def _shapes():
    from repro_torch.configs import get_config
    cfg = get_config("internlm2_1_8b")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    return {"wq": (d, cfg.q_dim), "mlp_wi": (d, f), "mlp_wo": (f, d),
            "head": (d, v)}


def _sealed_operands(torch, dev, gen, k, n, ratio, wc, bk, bn):
    from repro_torch import u32
    from repro_torch.kernels import ref
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    mask = torch.rand((k,), generator=gen, device=dev) < ratio
    key = _rand_words(torch, gen, (8,), dev)
    nonce = _rand_words(torch, gen, (3,), dev)
    ct = ref.seal_weights_ref(w, key, nonce, bk, bn, mask, wc)
    wcw = torch.tensor(u32.const(wc), dtype=torch.int32, device=dev)
    return w, mask, key, nonce, ct, wcw


def phase_sealed_matmul(torch, dev, seed):
    from repro_torch.core.sealed_store import _pick_block
    from repro_torch.kernels import ref
    from repro_torch.kernels import sealed_matmul as SMK
    from repro_torch.kernels.chacha20 import chacha20_blocks_plain
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    combos = [(m, r, wc, cdt) for m in (4, 32) for r in (0.0, 0.5, 1.0)
              for wc in (0, 5) for cdt in ("float32", "bfloat16")]
    cases = []
    shapes = dict(_shapes())
    shapes["bn8"] = (2048, 2056)           # N = 8 * 257: seal tile bn = 8
    for name, (k, n) in shapes.items():
        bk, bn = _pick_block(k), _pick_block(n)
        if name == "wq":
            mine = combos                  # the whole grid
        else:                              # each value of each axis
            mine = [c for i, c in enumerate(combos) if i % 4 == i // 4 % 4]
        by_seal = {}
        for m, ratio, wc, cdt in mine:
            by_seal.setdefault((ratio, wc), []).append((m, cdt))
        for (ratio, wc), runs in by_seal.items():
            w, mask, key, nonce, ct, wcw = _sealed_operands(
                torch, dev, gen, k, n, ratio, wc, bk, bn)
            # the plain unseal must give the weight back bit for bit
            w_plain = ref.unseal_weights_ref(ct, key, nonce, bk, bn, mask,
                                             wcw, block_fn=chacha20_blocks_plain)
            if not torch.equal(w_plain.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"{name}: seal/unseal roundtrip differs")
            for m, cdt in runs:
                x = torch.randn((m, k), generator=gen, device=dev)
                c = getattr(torch, cdt)
                want = x.to(c).float() @ w_plain.to(c).float()
                got = SMK.sealed_matmul_cuda(x, ct, mask, key, nonce, wcw,
                                             bk=bk, bn=bn, compute_dtype=cdt)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                ok = (bool(torch.isfinite(got).all())
                      and err <= KERNEL_TOL * scale)
                cases.append({"leaf": name, "K": k, "N": n, "bk": bk,
                              "bn": bn, "M": m, "ratio": ratio, "wc": wc,
                              "compute_dtype": cdt, "max_abs_err": err,
                              "out_scale": scale})
                log(f"[sealed_matmul] {name} K={k} N={n} bk={bk} bn={bn} "
                    f"M={m} ratio={ratio} wc={wc} {cdt}: max_abs_err={err:.3e}"
                    f" (scale {scale:.3e}, tol {KERNEL_TOL:g} x scale)")
                if not ok:
                    raise AssertionError(f"sealed_matmul disagrees: {cases[-1]}")
        del w, ct, w_plain
        torch.cuda.empty_cache()
    return {"cases": cases,
            "max_abs_err": max(c["max_abs_err"] for c in cases)}


# --------------------------------------------------------------------------
# phase 3: sealed serving at full width
# --------------------------------------------------------------------------

def _prompts(seed, count, vocab):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, rng.randint(64, 201)).astype(np.int32)
            for _ in range(count)]


def first_tick_logits(torch, cfg, params, cache_seal, prompts, forced, dev,
                      block_size=16, chunk=32):
    """Chunked prefill of every prompt at once, then one teacher-forced
    decode tick on ``forced`` (or on the prefill argmax when None), through
    the same paged functions the engine runs. Returns (prefill logits,
    decode logits, tokens fed)."""
    from repro_torch.models import cache as MC
    from repro_torch.models import paged as PG
    b = len(prompts)
    longest = max(len(p) for p in prompts)
    mb = -(-(longest + 1) // block_size)
    pools = MC.paged_pool_init(cfg, 1 + b * mb, block_size, dev)
    tables = (1 + torch.arange(b, device=dev)[:, None] * mb
              + torch.arange(mb, device=dev)[None, :])
    wc = torch.zeros((1 + b * mb,), dtype=torch.int32, device=dev)
    lengths = torch.zeros((b,), dtype=torch.int64, device=dev)
    last = [None] * b
    for off in range(0, longest, chunk):
        toks = torch.zeros((b, chunk), dtype=torch.int64)
        cl = torch.zeros((b,), dtype=torch.int64)
        for i, p in enumerate(prompts):
            seg = p[off:off + chunk]
            toks[i, :len(seg)] = torch.as_tensor(seg, dtype=torch.int64)
            cl[i] = len(seg)
        toks, cl = toks.to(dev), cl.to(dev)
        logits, ups = PG.chunk_logits(cfg, params, pools, tables, lengths, wc,
                                      toks, cl, cache_seal)
        PG.append_tokens(cfg, cache_seal, pools, ups, tables, lengths, cl, wc)
        for i, p in enumerate(prompts):
            if off < len(p) <= off + chunk:
                last[i] = logits[i]
        lengths = lengths + cl
    prefill = torch.stack(last)
    if forced is None:
        forced = prefill.argmax(dim=-1)
    dec, _ = PG.decode_logits(cfg, params, pools, tables, lengths, wc,
                              forced[:, None], cache_seal)
    return prefill, dec, forced


def _rel_err(torch, got, want):
    got, want = got.float().cpu(), want.float().cpu()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).abs().max() / want.abs().max())


def phase_serve(torch, dev, args):
    from repro_torch.config import SealConfig
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core import sealed_store as SS
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import map_leaves

    out = {}
    # 3a. small input, held against the CPU plain path (f32)
    small = get_reduced("internlm2_1_8b").with_(dtype="float32")
    p_small = T.init_params(small, seed=args.seed, device="cpu")
    prompts = _prompts(args.seed, 3, small.vocab_size)
    pre_c, dec_c, forced = first_tick_logits(torch, small, p_small, None,
                                             prompts, None, "cpu")
    p_gpu = map_leaves(lambda t: t.to(dev), p_small)
    sp = SS.seal_params(p_gpu, SealConfig(), bytes(range(32)))
    pre_g, dec_g, _ = first_tick_logits(
        torch, small, SS.fused_params(sp, bytes(range(32))),
        SS.cache_seal_config(bytes(range(32)), dev), prompts,
        forced.to(dev), dev)
    err_small = max(_rel_err(torch, pre_g, pre_c), _rel_err(torch, dec_g, dec_c))
    out["reduced_vs_cpu_rel_err"] = err_small
    log(f"[serve] reduced f32: sealed on the card vs plain on the CPU, "
        f"max rel err {err_small:.3e} (tol 1e-4)")
    if not err_small <= 1e-4:
        raise AssertionError("reduced-size card run disagrees with the CPU")

    # 3b. full width
    cfg = get_config("internlm2_1_8b")
    t0 = time.time()
    params = T.init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model},"
        f" {n_params / 1e9:.3f} B params, init {time.time() - t0:.1f} s")
    prompts = _prompts(args.seed + 7, REQUESTS, cfg.vocab_size)
    seal = SealConfig()                   # ColoE, SE 0.5, fused decrypt
    t0 = time.time()
    eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=256,
                      seal=seal, device=dev)
    torch.cuda.synchronize()
    out["seal_s"] = time.time() - t0
    fused = eng.stats["fused_matmul_leaves"]
    log(f"[serve] sealed in {out['seal_s']:.1f} s: {fused} fused leaf kinds, "
        f"stored {eng.sealed.stored_bytes() / 1e9:.3f} GB, plaintext per step "
        f"{eng.stats['weights_plaintext_bytes_per_step'] / 1e9:.3f} GB")
    handles = [eng.submit(p, max_tokens=NEW_TOKENS) for p in prompts]

    ops.reset_launch_counts()            # the main path starts here
    torch.cuda.synchronize()
    t0 = time.time()
    eng.run()
    torch.cuda.synchronize()
    launches = ops.launch_counts()       # ... and ends here
    serve_s = time.time() - t0
    out["launches"] = launches
    out["serve_s"] = serve_s
    out["stats"] = {k: v for k, v in eng.stats.items()}
    dispatches = eng.stats["prefills"] + eng.stats["decode_steps"]
    per_dispatch = cfg.n_superblocks() * (fused - 1) + 1
    log(f"[serve] sealed run: {serve_s:.2f} s, {eng.stats['tokens']} tokens, "
        f"{eng.stats['prefills']} chunk + {eng.stats['decode_steps']} decode "
        f"dispatches, launches {launches}")
    if not all(h.done and len(h.out) == NEW_TOKENS for h in handles):
        raise AssertionError("not every request completed")
    if launches["sealed_matmul"] != dispatches * per_dispatch:
        raise AssertionError(
            f"sealed_matmul launched {launches['sealed_matmul']} times, "
            f"expected {per_dispatch} per dispatch x {dispatches}")
    if launches["chacha20"] <= 0:
        raise AssertionError("the ChaCha kernel never ran on the main path")
    eng.check_device_mirror()

    plain = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=256,
                        seal=None, device=dev)
    ph = [plain.submit(p, max_tokens=NEW_TOKENS) for p in prompts]
    plain.run()
    same = sum(a == b for h, g in zip(handles, ph)
               for a, b in zip(h.out, g.out))
    total = sum(len(h.out) for h in handles)
    out["greedy_agreement"] = same / total
    log(f"[serve] greedy tokens equal to the plaintext engine's: "
        f"{same}/{total} = {same / total:.3f}")

    # teacher-forced first decode tick, sealed vs plaintext, one prompt per
    # slot, both fed the plaintext prefill's argmax
    first = prompts[:SLOTS]
    pre_p, dec_p, forced = first_tick_logits(torch, cfg, params, None, first,
                                             None, dev)
    pre_s, dec_s, _ = first_tick_logits(torch, cfg, eng.params(),
                                        eng.cache_seal, first, forced, dev)
    err_pre, err_dec = (_rel_err(torch, pre_s, pre_p),
                        _rel_err(torch, dec_s, dec_p))
    out["first_tick_rel_err"] = {"prefill": err_pre, "decode": err_dec}
    log(f"[serve] teacher-forced logits, sealed vs plaintext: prefill max rel "
        f"err {err_pre:.3e}, first decode tick {err_dec:.3e} (tol 2e-2)")
    if not (err_pre <= 2e-2 and err_dec <= 2e-2):
        raise AssertionError("sealed logits disagree with plaintext")
    # the same weights and forced tokens in f32: without bf16 roundings the
    # two paths differ only in sum order, so a kernel fault that grows
    # through the layers like the bf16 gap would show here
    cfg32 = cfg.with_(dtype="float32")
    pre_p32, dec_p32, _ = first_tick_logits(torch, cfg32, params, None, first,
                                            forced, dev)
    pre_s32, dec_s32, _ = first_tick_logits(torch, cfg32, eng.params(),
                                            eng.cache_seal, first, forced, dev)
    err32 = (_rel_err(torch, pre_s32, pre_p32),
             _rel_err(torch, dec_s32, dec_p32))
    out["first_tick_rel_err_f32"] = {"prefill": err32[0], "decode": err32[1]}
    log(f"[serve] the same in f32: prefill max rel err {err32[0]:.3e}, first "
        f"decode tick {err32[1]:.3e} (tol 1e-4)")
    if not max(err32) <= 1e-4:
        raise AssertionError("sealed f32 logits disagree with plaintext")
    out["engine"] = eng
    out["plain_engine"] = plain
    out["params"] = params
    out["prompts"] = prompts
    return out


def _leaves(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


# --------------------------------------------------------------------------
# phase 4: timings
# --------------------------------------------------------------------------

def _time_ms(torch, fn, iters, flush=None):
    """Mean CUDA-event time of ``fn`` over ``iters`` launches after one
    warm-up; ``flush`` (if given) runs between launches, outside the timed
    window, so every launch finds a cold L2."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def phase_timing(torch, dev, args, report):
    from repro_torch.core.sealed_store import _pick_block
    from repro_torch.kernels import chacha20 as CC
    from repro_torch.kernels import sealed_matmul as SMK
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    scratch = torch.empty((64 * 2**20,), dtype=torch.int32, device=dev)
    flush = lambda: scratch.zero_()           # 256 MB > the 50 MB L2
    out = {"sealed_matmul_shapes": []}

    # sealed_matmul at each main-path leaf shape, SE 0.5, bf16
    for name, (k, n) in _shapes().items():
        bk, bn = _pick_block(k), _pick_block(n)
        w, mask, key, nonce, ct, wcw = _sealed_operands(
            torch, dev, gen, k, n, 0.5, 5, bk, bn)
        for m in (4, 32):
            x = torch.randn((m, k), generator=gen, device=dev)
            run = lambda: SMK.sealed_matmul_cuda(
                x, ct, mask, key, nonce, wcw, bk=bk, bn=bn,
                compute_dtype="bfloat16")
            plain = lambda: SMK.sealed_matmul_plain(
                x, ct, mask, key, nonce, wcw, bk=bk, bn=bn,
                compute_dtype="bfloat16")
            ms = _time_ms(torch, run, 20, flush)
            plain_ms = _time_ms(torch, plain, 2) if m == 4 else None
            enc_rows = int(mask.sum())
            nbytes = 4 * m * k + 4 * k * n + k + 4 * m * n + 48
            ops_int = enc_rows * (n // 16) * (CHACHA_OPS + CHACHA_XOR_OPS)
            b_ms, b_by = bound_ms(nbytes, ops_int, 2.0 * m * k * n)
            rec = {"leaf": name, "M": m, "K": k, "N": n, "bk": bk, "bn": bn,
                   "enc_rows": enc_rows, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
            out["sealed_matmul_shapes"].append(rec)
            pm = f"{plain_ms:.3f}" if plain_ms is not None else "-"
            log(f"[time] sealed_matmul {name} M={m} K={k} N={n}: {ms:.4f} ms,"
                f" plain {pm} ms, bound {b_ms:.4f} ms ({b_by})")
        del w, ct
        torch.cuda.empty_cache()
    main = next(r for r in out["sealed_matmul_shapes"]
                if r["leaf"] == "mlp_wi" and r["M"] == 4)
    out["sealed_matmul"] = {"ms": main["ms"], "plain_ms": main["plain_ms"],
                            "bound_ms": main["bound_ms"],
                            "bound_by": main["bound_by"],
                            "shape": "mlp_wi M=4 K=2048 N=8192 SE0.5 bf16"}

    # ChaCha at the main path's largest call: the embedding's line OTP
    # (two blocks per 128 B line, per-block nonces), and one cache-block OTP
    from repro_torch import u32
    cfg = report["serve"]["engine"].cfg
    n_embed = 2 * (-(-cfg.vocab_size * cfg.d_model // 32))
    key = _rand_words(torch, gen, (8,), dev)
    out["chacha_shapes"] = []
    for label, nblk in (("embed line OTP", n_embed),
                        ("KV view OTP, 4 slots x 16 blocks", 4 * 16 * 512)):
        ctr = u32.from_i64(torch.arange(nblk, device=dev))
        nz = _rand_words(torch, gen, (nblk, 3), dev)
        ms = _time_ms(torch, lambda: CC.chacha20_blocks_cuda(key, ctr, nz),
                      20, flush)
        plain_ms = _time_ms(torch,
                            lambda: CC.chacha20_blocks_plain(key, ctr, nz), 2)
        b_ms, b_by = bound_ms(nblk * (64 + 4 + 12) + 32, nblk * CHACHA_OPS)
        out["chacha_shapes"].append({"call": label, "blocks": nblk, "ms": ms,
                                     "plain_ms": plain_ms, "bound_ms": b_ms,
                                     "bound_by": b_by})
        log(f"[time] chacha20 {label}: {nblk} blocks, {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    c0 = out["chacha_shapes"][0]
    out["chacha20"] = {"ms": c0["ms"], "plain_ms": c0["plain_ms"],
                       "bound_ms": c0["bound_ms"], "bound_by": c0["bound_by"],
                       "shape": f"{c0['blocks']} blocks, per-block nonces"}

    # one decode tick with every slot decoding, sealed and plaintext
    serve = report["serve"]
    ticks = {}
    for label, eng in (("sealed", serve["engine"]),
                       ("plaintext", serve["plain_engine"])):
        for p in serve["prompts"][:eng.slots]:
            eng.submit(p, max_tokens=64)
        while any(r is None or eng._pending[i] is not None
                  for i, r in enumerate(eng._active)):
            eng.step()
        ms = _time_ms(torch, eng._decode_tick, 5)
        wall = []
        for _ in range(5):
            t0 = time.time()
            eng._decode_tick()            # ends in the tokens' d2h copy
            wall.append(1e3 * (time.time() - t0))
        ticks[label] = {"ms": ms, "host_ms": sorted(wall)[len(wall) // 2]}
        eng.queue.clear()
        log(f"[time] decode tick, {eng.slots} slots, {label}: {ms:.2f} ms "
            f"(device events), {ticks[label]['host_ms']:.2f} ms (host clock)")
    # the tick's sealed matmuls alone, at their bound: every fused leaf at
    # M = slots, with the image's own masks
    eng = serve["engine"]
    tb_bytes, tb_ops = 0.0, 0.0
    for path, st in eng.sealed.tensors.items():
        if st.meta.layout != "tiles":
            continue
        layers = st.meta.shape[0] if st.meta.n_batch else 1
        k, n = st.k_size, st.n_size
        enc = int(st.row_mask.sum())
        tb_bytes += layers * (4 * k * n + k) + layers * 4 * eng.slots * (k + n)
        tb_ops += enc * (n // 16) * (CHACHA_OPS + CHACHA_XOR_OPS)
    b_ms, b_by = bound_ms(tb_bytes, tb_ops)
    ticks["sealed_matmul_bound_ms"] = b_ms
    ticks["sealed_matmul_bound_by"] = b_by
    log(f"[time] the tick's sealed matmuls at their bound: {b_ms:.3f} ms "
        f"({b_by}; {tb_bytes / 1e9:.2f} GB, {tb_ops / 1e9:.1f} G int ops)")
    out["decode_tick"] = ticks
    out["tick_profile"] = _profile_ticks(torch, serve["engine"])
    for key_ in ("engine", "plain_engine", "params", "prompts"):
        serve.pop(key_)
    return out


def _profile_ticks(torch, eng, ticks=3, top=12):
    """Device time by kernel over a few sealed decode ticks, and the share
    of the window in which the device ran nothing (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(ticks):
            eng._decode_tick()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    rows = []
    for ev in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    out = {"ticks": ticks, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms),
           "top": [{"kernel": k[:90], "calls": c, "device_ms": us / 1e3}
                   for us, k, c in rows[:top]]}
    log(f"[profile] {ticks} sealed decode ticks: wall {wall_ms:.2f} ms, "
        f"device busy {busy_ms:.2f} ms, idle share {out['idle_share']:.3f}")
    for r in out["top"]:
        log(f"[profile]   {r['device_ms']:9.3f} ms  x{r['calls']:<6d} "
            f"{r['kernel']}")
    return out


if __name__ == "__main__":
    sys.exit(main())
