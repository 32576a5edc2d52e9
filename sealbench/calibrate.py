"""The readings a cell's limit is set from: for each seed, one run of the
cell at its own load (a window of ``--seconds``), the program's widest gap
and the float8 control's widest gap on the same sample of served requests,
with the control in the program's place (``control_correct``, which has
to come out false). All seeds run in one process, so the program's kernels load once. The
benchmark's own runs never run the control.

    python3 sealbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 20 [--out <file.jsonl>]

One JSON line a seed on standard output (and in ``--out``), then a summary:
the largest program reading, the smallest control reading and their ratio.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from sealbench import harness, spec

    cell = spec.load_cell(args.workload, ROOT)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run(cell, seed, args.seconds, False, "cuda",
                          time.perf_counter(), control=True)
        row = {"workload": cell.name, "seed": seed,
               "widest_gap": res["program_gap"],
               "control_gap": res["check"]["widest_gap"]["value"],
               "tokens": res["check"]["served_tokens_checked"]["value"],
               "control_correct": res["correct"], "window": res["window"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
    low = max(r["widest_gap"] for r in rows)
    high = min(r["control_gap"] for r in rows)
    print(json.dumps({"workload": cell.name, "seeds": len(rows),
                      "program_max": low, "control_min": high,
                      "ratio": high / low if low else None,
                      "seconds": time.perf_counter() - T_START}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
