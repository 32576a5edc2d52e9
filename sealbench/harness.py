"""One run of one cell: set-up, the measured window, the trace, the check.

Set-up (``setup_s``, from the process's start): the program's kernels
built where they are not yet, the weights made on the device from the
seed, the engine made (it seals the weights), then the warm-up: one
chunked prefill at every row count from the admit width down to one, with
decode ticks between, and the closed loop's ramp until every client's
first request has its first token. The window then runs the closed loop
for ``seconds``. With ``trace`` a stretch of steps after it runs under the
profiler. Then the program's state is freed and the sample of finished
requests goes to the reference.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib
import sys
import time
from typing import Callable, Dict, List, Optional

from sealbench import check as CK
from sealbench import port
from sealbench import spec as SP
from sealbench import stats as STS
from sealbench.loop import ClosedLoop, drain
from sealbench.spans import Spans
from sealbench.traffic import Traffic, warmup_prompts

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the warm-up's requests each take this many tokens: a chunk, then a tick
WARMUP_TOKENS = 2


def log(msg: str) -> None:
    print(f"[sealbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, whole)
    is JAX's, Flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class RunData:
    """What the per-layer readers read."""
    config: dict
    mix: dict
    window: dict                    # stats.window_numbers of the window
    stats_delta: Dict[str, int]     # the engine's counters over the window
    spans: Dict[str, tuple]         # span name -> (seconds, count), window
    stretch: object = None          # trace.Stretch of the traced steps
    dispatches: List[dict] = dataclasses.field(default_factory=list)
    port_kernels: List[str] = dataclasses.field(default_factory=list)


def seal_key(seed: int) -> bytes:
    return hashlib.sha256(b"sealbench weight key %d" % seed).digest()


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell: SP.Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False,
        clock: Callable[[], float] = time.perf_counter) -> Dict:
    """One run of ``cell``. With ``control`` the float8 control stands in
    the program's place in the comparison: ``correct`` and ``widest_gap``
    are the control's, and ``program_gap`` the program's on the same
    sample."""
    import torch

    c, mix = cell.config, cell.mix
    ref = importlib.import_module(f"sealbench.reference.{c['family']}")
    dev = torch.device(device)
    cfg = port.model_config(c)
    if dev.type == "cuda":
        port.build_kernels()
    t_built = clock()
    w = ref.make_weights(c, seed, dev)
    eng = port.make_engine(cfg, port.params_tree(c, w), c, mix, seal_key(seed),
                           dev)
    del w
    gc.collect()
    _sync(torch, dev)
    t_engine = clock()
    log(f"{cell.name}: {ref.describe(c)}; kernels ready at "
        f"{t_built - t_start:.2f} s, weights sealed at "
        f"{t_engine - t_start:.2f} s")

    spans = Spans(port, clock)
    spans.install(eng)
    for prompts in warmup_prompts(mix, seed, cfg.vocab_size):
        drain(eng, prompts, WARMUP_TOKENS)
    loop = ClosedLoop(eng, Traffic(mix, seed, cfg.vocab_size),
                      mix["clients"], clock)
    t_warm = clock()
    loop.open()
    while not loop.ramped():
        loop.step()
    _sync(torch, dev)
    t_open = clock()
    setup_s = t_open - t_start
    s0 = dict(eng.stats)
    deadline = t_open + seconds
    while clock() < deadline:
        loop.step()
    t_close = clock()
    s1 = dict(eng.stats)
    log(f"warm-up {t_warm - t_engine:.2f} s, ramp {t_open - t_warm:.2f} s; "
        f"window {t_close - t_open:.2f} s, {loop.steps} steps in all, "
        f"set-up {setup_s:.2f} s")

    stretch, stretched = None, []
    if trace:
        from sealbench import trace as TR

        def need():
            kinds = {d["shape"]["kind"]
                     for d in spans.dispatches[spans.mark:]}
            return kinds >= {"chunk", "decode"}

        stretch = TR.profile_steps(loop, spans, mix["trace_steps"], need)
        stretched = spans.dispatches[spans.mark:]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    data = RunData(c, mix, STS.window_numbers(loop.records, t_open, t_close),
                   {k: s1[k] - s0[k] for k in s0
                    if isinstance(s0[k], int) and isinstance(s1[k], int)},
                   spans.totals(t_open, t_close), stretch, stretched,
                   port.kernel_names() if trace else [])
    banned = forbidden_modules()
    if banned:
        raise RuntimeError(f"loaded after the window: {banned}")

    # free the program's state before the reference runs
    spans.remove()
    records = loop.records
    loop.eng = None
    del eng, loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
    t_ref = clock()
    w = ref.make_weights(c, seed, dev)
    recs = CK.sample(records, seed, mix["check_tokens"],
                     mix["check_requests"])
    got = CK.gaps(ref, c, w, recs, dev, control=control)
    del w
    log(f"reference over {got['requests']} requests, {got['tokens']} served "
        f"tokens: {clock() - t_ref:.2f} s")

    limit = cell.check["widest_gap_limit"]
    nums = data.window
    # the control stands in the program's place: its picks are judged
    gap = got["control_gap"] if control else got["widest_gap"]
    correct = (got["tokens"] >= mix["check_tokens"]
               and gap <= limit and nums["failed"] == 0)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = SP.reader(m["name"])(data)
            if v is None:
                log(f"left out {m['name']}: its reader found nothing to "
                    f"read in the traced stretch")
            else:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = STS.end_to_end(nums)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": bool(correct), "attempted": nums["submitted"],
              "failed": nums["failed"], "metrics": metrics,
              "device": device_info(torch, dev, peak, stretch)}
    if stretch is not None:
        from sealbench.trace import breakdown
        result["breakdown"] = breakdown(stretch)
    result["window"] = {"tokens": nums["tokens"], "first": nums["first"],
                        "seconds": nums["seconds"],
                        "requests_checked": got["requests"]}
    if control:
        # the program's own reading on the same sample, for calibrate.py
        result["program_gap"] = got["widest_gap"]
    # the numbers compared, each beside its limit: the line's last key
    result["check"] = {
        "widest_gap": {"value": gap, "limit": limit},
        "served_tokens_checked": {"value": got["tokens"],
                                  "min": mix["check_tokens"]},
        "failed_requests": {"value": nums["failed"], "limit": 0}}
    return result


def device_info(torch, dev, peak: int, stretch) -> Dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    if stretch is not None:
        info["busy_s"] = stretch.busy_s
        info["window_s"] = stretch.window_s
    return info
