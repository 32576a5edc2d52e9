"""Serving launcher: staggered requests through the continuous batcher or
the group-drain baseline, over optionally sealed weights and KV cache. Port
of ``repro/launch/serve.py`` (``poisson_arrivals``, ``drive``, ``main``).

``python -m repro_torch.launch.serve --arch internlm2_1_8b --seal coloe``
``python -m repro_torch.launch.serve --device cpu --engine group --check``

Arrivals are Poisson in *scheduler-step* units: request ``i`` is submitted
once the engine has advanced ``arrival[i]`` steps, so the trace is
deterministic under ``--seed`` and independent of host speed. ``--check``
exits non-zero unless every request completed. ``--device`` picks the card
(``cuda``, the default) or the CPU's plain path (``cpu``).

Flags of slices the port has not reached yet (prefix sharing, MAC
verification and tamper injection, sampling, the Direct engine) exit
non-zero with a message that names the slice.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.config import SealConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import GroupServeEngine, ServeEngine

_PREFIX = "the prefix-sharing slice of the port"
_INTEGRITY = "the verify/MAC/tamper slice of the port"


def poisson_arrivals(n: int, mean_gap: float, rng) -> np.ndarray:
    """Cumulative arrival times (in scheduler steps) for ``n`` requests."""
    if mean_gap <= 0:
        return np.zeros((n,))
    return np.cumsum(rng.exponential(mean_gap, size=n))


def drive(eng, prompts, arrivals, submit_kw) -> list:
    """Feed requests as their arrival step comes due, stepping the engine
    in between; returns the submitted Request handles, all drained.

    ``submit_kw`` is one kwargs dict for every request or a list with one
    per request. The arrival clock counts the engine's own consumed steps
    (prefills + decode steps, relative to this call) plus idle ticks, so
    both engine types face the same arrival process and back-to-back
    ``drive`` calls on one engine replay the same trace.
    """
    def consumed():
        return eng.stats["decode_steps"] + eng.stats["prefills"]

    base = consumed()
    reqs, i, sim, idle = [], 0, 0.0, 0.0
    continuous = isinstance(eng, ServeEngine)
    while i < len(prompts) or eng.busy:
        while i < len(prompts) and arrivals[i] <= sim:
            kw = submit_kw[i] if isinstance(submit_kw, list) else submit_kw
            reqs.append(eng.submit(prompts[i], **kw))
            i += 1
        if eng.busy:
            if continuous:
                eng.step()
            else:
                eng.run()      # group baseline drains whatever has arrived
            sim = consumed() - base + idle
        else:
            idle += 1.0        # idle tick waiting for the next arrival
            sim += 1.0
    return reqs


def _unported(args) -> list:
    """(flag, slice) for every flag whose slice is not ported yet."""
    out = []
    if args.prefix_share:
        out.append(("--prefix-share", _PREFIX))
    if args.shared_prefix:
        out.append(("--shared-prefix", _PREFIX))
    if args.expect_shared:
        out.append(("--expect-shared", _PREFIX))
    if args.compare_sealed:
        out.append(("--compare-sealed", _PREFIX))
    if args.verify:
        out.append(("--verify", _INTEGRITY))
    if args.inject_tamper:
        out.append(("--inject-tamper", _INTEGRITY))
    if args.temperature or args.top_k or args.top_p < 1.0:
        out.append(("--temperature/--top-k/--top-p",
                    "the sampling slice of the port"))
    if args.seal == "direct":
        out.append(("--seal direct",
                    "the Direct engine (AES-128) slice of the port"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain PyTorch path)")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "continuous", "group"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--stagger", type=float, default=0.0,
                    help="mean Poisson inter-arrival gap in scheduler steps")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seal", default="coloe",
                    choices=["none", "direct", "counter", "coloe"])
    ap.add_argument("--seal-cache", default="auto",
                    choices=["auto", "on", "off"],
                    help="seal the paged KV cache (auto: follow --seal)")
    ap.add_argument("--smart-ratio", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefix-share", action="store_true")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="prefill chunk width in tokens (0: 2x block size)")
    ap.add_argument("--shared-prefix", type=int, default=0)
    ap.add_argument("--compare-sealed", action="store_true")
    ap.add_argument("--expect-shared", action="store_true")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--inject-tamper", default="")
    ap.add_argument("--max-run-steps", type=int, default=0,
                    help="abort a drain with StragglerTimeout after this "
                         "many scheduler steps (0: unbounded)")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless every request completed")
    args = ap.parse_args(argv)

    unported = _unported(args)
    for flag, where in unported:
        print(f"FAIL: {flag} is not ported yet: it comes with {where}",
              file=sys.stderr)
    if unported:
        return 2

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.production else get_reduced(args.arch)
    params = T.init_params(cfg, seed=0, device=dev)
    seal = None if args.seal == "none" else SealConfig(
        mode=args.seal, smart_ratio=args.smart_ratio)
    engine = args.engine
    if engine == "auto":
        attn_only = all(k in ("attn", "local_attn") for k in cfg.pattern)
        engine = "continuous" if attn_only else "group"
    max_len = args.prompt_len + args.max_tokens + 8
    if engine == "continuous":
        seal_cache = {"auto": None, "on": True, "off": False}[args.seal_cache]
        eng = ServeEngine(cfg, params, batch_slots=args.slots,
                          max_len=max_len, seal=seal, seal_cache=seal_cache,
                          chunk_tokens=args.chunk_tokens or None,
                          max_run_steps=args.max_run_steps or None,
                          device=dev)
    else:
        eng = GroupServeEngine(cfg, params, batch_slots=args.slots,
                               max_len=max_len, seal=seal, device=dev)

    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, cfg.vocab_size,
                           size=rng.randint(max(1, args.prompt_len // 2),
                                            args.prompt_len + 1))
               for _ in range(args.requests)]
    arrivals = poisson_arrivals(args.requests, args.stagger, rng)
    t0 = time.time()
    reqs = drive(eng, prompts, arrivals, dict(max_tokens=args.max_tokens))
    dt = time.time() - t0
    n_done = sum(r.done for r in reqs)
    extra = ""
    if engine == "continuous":
        extra = f" chunks={eng.stats['prefill_chunks']}"
    print(f"[{engine}] completed {n_done}/{len(reqs)} requests in {dt:.2f}s "
          f"— {eng.stats['tokens'] / max(dt, 1e-9):.1f} tok/s "
          f"(seal={args.seal}, device={dev}){extra} stats={eng.stats}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.out[:12]}")
    if args.check and n_done != len(reqs):
        print(f"FAIL: {len(reqs) - n_done} requests did not complete",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
