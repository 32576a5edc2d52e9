"""Serving launcher: staggered requests through the continuous batcher or
the group-drain baseline, over optionally sealed weights and KV cache. Port
of ``repro/launch/serve.py`` (``poisson_arrivals``, ``drive``, ``main``).

``python -m repro_torch.launch.serve --arch internlm2_1_8b --seal coloe``
``python -m repro_torch.launch.serve --seal direct --verify --check``
``python -m repro_torch.launch.serve --device cpu --engine group --check``
``python -m repro_torch.launch.serve --prefix-share --chunked-prefill \
    --shared-prefix 32 --expect-shared --compare-sealed``
``python -m repro_torch.launch.serve --seal none --seal-cache on --verify \
    --inject-tamper bitflip,replay,rollback,relocate --check``
``python -m repro_torch.launch.serve --seal coloe --verify --temperature 0.7 \
    --top-k 5 --top-p 0.9 --check``

Arrivals are Poisson in *scheduler-step* units: request ``i`` is submitted
once the engine has advanced ``arrival[i]`` steps, so the trace is
deterministic under ``--seed`` and independent of host speed. ``--check``
exits non-zero unless every request completed. ``--device`` picks the card
(``cuda``, the default) or the CPU's plain path (``cpu``).

``--verify`` over sealed weights also seals them with MACs and sweeps them
once per drain (fail-stop); ``--seed`` seeds the requests' sampling streams
too. ``--seal direct`` serves through the Direct engine (AES-128-ECB lines,
every leaf decrypted each dispatch: the AES kernel on the card).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.config import SealConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.security.tamper import TamperInjector
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import GroupServeEngine, ServeEngine


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
    ap.add_argument("--prefix-share", action="store_true",
                    help="copy-on-write prefix sharing across requests")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="report chunked-prefill stats (admission always "
                         "prefills in chunks; this just surfaces the knob)")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="prefill chunk width in tokens (0: 2x block size)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every prompt this many common prefix tokens")
    ap.add_argument("--compare-sealed", action="store_true",
                    help="replay the trace with the cache sealed the other "
                         "way and require equal token streams (continuous "
                         "only)")
    ap.add_argument("--expect-shared", action="store_true",
                    help="exit non-zero unless shared_prefix_blocks > 0")
    ap.add_argument("--verify", action="store_true",
                    help="arm the co-located Carter-Wegman MACs: sweep "
                         "sealed weights once per drain (fail-stop) and "
                         "check every sealed cache block at every read")
    ap.add_argument("--inject-tamper", default="",
                    help="comma-separated fault kinds (bitflip,replay,"
                         "rollback,relocate) to inject against the sealed "
                         "cache; exits non-zero unless every injected fault "
                         "fired AND was detected (continuous only)")
    ap.add_argument("--max-run-steps", type=int, default=0,
                    help="abort a drain with StragglerTimeout after this "
                         "many scheduler steps (0: unbounded)")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless every request completed")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.production else get_reduced(args.arch)
    if cfg.frontend is not None:        # the engines' refusal, before init
        raise AssertionError("serving demo targets token archs")
    params = T.init_params(cfg, seed=0, device=dev)
    seal = None if args.seal == "none" else SealConfig(
        mode=args.seal, smart_ratio=args.smart_ratio)
    engine = args.engine
    if engine == "auto":
        attn_only = all(k in ("attn", "local_attn") for k in cfg.pattern)
        engine = "continuous" if attn_only else "group"
    max_len = args.shared_prefix + args.prompt_len + args.max_tokens + 8

    kinds = [k.strip() for k in args.inject_tamper.split(",") if k.strip()]
    verify = args.verify or bool(kinds)     # injection implies verification
    if kinds and engine != "continuous":
        print("FAIL: --inject-tamper needs the continuous engine",
              file=sys.stderr)
        return 2
    # stagger the one-shot injectors so each fault lands on a live victim
    # instead of piling onto the same scheduler step
    injectors = [TamperInjector(k, slot=0, start_step=3 + 6 * i)
                 for i, k in enumerate(kinds)]

    def build(seal_cache_override=None):
        if engine != "continuous":
            if verify and seal is None:
                print("FAIL: --verify needs sealed weights with the group "
                      "engine", file=sys.stderr)
                sys.exit(2)
            return GroupServeEngine(cfg, params, batch_slots=args.slots,
                                    max_len=max_len, seal=seal,
                                    verify=verify, device=dev)
        seal_cache = {"auto": None, "on": True, "off": False}[args.seal_cache]
        if seal_cache_override is not None:
            seal_cache = seal_cache_override
        if verify and seal is None and not seal_cache:
            print("FAIL: --verify/--inject-tamper need sealed weights "
                  "and/or a sealed cache", file=sys.stderr)
            sys.exit(2)
        return ServeEngine(cfg, params, batch_slots=args.slots,
                           max_len=max_len, seal=seal, seal_cache=seal_cache,
                           sample_seed=args.seed,
                           prefix_share=args.prefix_share,
                           chunk_tokens=args.chunk_tokens or None,
                           verify=verify, fault_hooks=injectors,
                           max_run_steps=args.max_run_steps or None,
                           device=dev)

    eng = build()
    submit_kw = dict(max_tokens=args.max_tokens)
    if engine == "continuous":      # the group engine stays greedy
        submit_kw.update(temperature=args.temperature, top_k=args.top_k,
                         top_p=args.top_p)
    rng = np.random.RandomState(args.seed)
    shared = rng.randint(0, cfg.vocab_size, size=args.shared_prefix)
    prompts = [np.concatenate([
                   shared,
                   rng.randint(0, cfg.vocab_size,
                               size=rng.randint(max(1, args.prompt_len // 2),
                                                args.prompt_len + 1))])
               for _ in range(args.requests)]
    arrivals = poisson_arrivals(args.requests, args.stagger, rng)
    t0 = time.time()
    reqs = drive(eng, prompts, arrivals, submit_kw)
    dt = time.time() - t0
    n_done = sum(r.done for r in reqs)
    extra = ""
    if engine == "continuous":
        extra = (f" chunks={eng.stats['prefill_chunks']}"
                 f" shared_blocks={eng.stats['shared_prefix_blocks']}"
                 f" shared_tokens={eng.stats['shared_prefix_tokens']}"
                 f" cow={eng.stats['cow_copies']}")
    if verify:
        extra += (f" mac_checks={eng.stats['mac_checks']}"
                  f" mac_failures={eng.stats['mac_failures']}")
        if engine == "continuous":
            extra += f" retries={eng.stats['retries']}"
    print(f"[{engine}] completed {n_done}/{len(reqs)} requests in {dt:.2f}s "
          f"— {eng.stats['tokens'] / max(dt, 1e-9):.1f} tok/s "
          f"(seal={args.seal}, device={dev}){extra} stats={eng.stats}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.out[:12]}")
    ok = True
    if args.check and n_done != len(reqs):
        print(f"FAIL: {len(reqs) - n_done} requests did not complete",
              file=sys.stderr)
        ok = False
    if args.expect_shared and eng.stats.get("shared_prefix_blocks", 0) <= 0:
        print("FAIL: no prefix blocks were shared", file=sys.stderr)
        ok = False
    if injectors:
        unfired = [i.kind for i in injectors if not i.fired]
        if unfired:
            print(f"FAIL: injectors never fired: {unfired}", file=sys.stderr)
            ok = False
        if eng.stats["mac_failures"] < sum(i.fired for i in injectors):
            print(f"FAIL: {sum(i.fired for i in injectors)} faults injected "
                  f"but only {eng.stats['mac_failures']} MAC failures "
                  f"detected", file=sys.stderr)
            ok = False
        for inj in injectors:
            for ev in inj.events:
                print(f"  tamper[{ev.kind}] step={ev.step} slot={ev.slot} "
                      f"block={ev.block} {ev.detail}")
        victims = [r for r in reqs if r.retries > 0 or r.error]
        print(f"  detected {eng.stats['mac_failures']} tampered dispatches; "
              f"{eng.stats['retries']} re-prefills; victims="
              f"{[r.rid for r in victims]}")
    if args.compare_sealed and engine == "continuous":
        other = build(seal_cache_override=not eng.seal_cache)
        reqs2 = drive(other, prompts, arrivals, submit_kw)
        if [r.out for r in reqs] != [r.out for r in reqs2]:
            print("FAIL: sealed and plaintext token streams differ",
                  file=sys.stderr)
            ok = False
        else:
            which = "sealed" if other.seal_cache else "plaintext"
            print(f"  replay with {which} cache: token streams equal")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
