"""Run one cell of the benchmark once.

    python3 sealbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for (``BENCHMARK.json``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` (and ``breakdown`` when traced), then ``check``: each number
compared beside its limit, also printed as the last lines of standard
error. Without a card, outside a checkout of the program, or with JAX
loaded, it exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from sealbench import spec
    cell = spec.load_cell(args.workload, ROOT)
    import torch
    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program (src/repro_torch) is not in this checkout: {e}",
              file=sys.stderr)
        return 3
    torch.cuda.init()
    print(f"[sealbench] torch imported at {t_torch - T_START:.2f} s, CUDA "
          f"initialised at {time.perf_counter() - T_START:.2f} s",
          file=sys.stderr, flush=True)
    from sealbench import harness
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START)
    banned = harness.forbidden_modules()
    if banned:
        print(f"JAX or the JAX package was loaded: {banned}", file=sys.stderr)
        return 4
    for name, entry in result["check"].items():
        bound = " ".join(f"{k} {v}" for k, v in entry.items() if k != "value")
        print(f"check {name} {entry['value']} {bound}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
