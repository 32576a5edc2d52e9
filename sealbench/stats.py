"""The end-to-end arithmetic over a window: every sample, no medians of
pieces."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """The p-th percentile of all ``values``, linear between the two
    nearest ranks (rank ``p / 100 * (n - 1)``); None when there are none."""
    xs = sorted(values)
    if not xs:
        return None
    r = (len(xs) - 1) * p / 100.0
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def window_numbers(records, t_open: float, t_close: float) -> Dict:
    """What the clients saw in the window (t_open, t_close]:

    tokens     every token stamped inside it, of any request, those in
               flight at either end included;
    ttft       time from submission to the first token of every request
               submitted inside it; one with no token by the close counts
               at (close - submission), a lower bound, so that a stall
               cannot drop out of the sample;
    itl        every gap between consecutive tokens of one request when
               both fall inside it;
    submitted  requests submitted inside it, and how many of them ended
               with an error;
    first      first tokens stamped inside it.
    """
    tokens = first = 0
    ttft: List[float] = []
    itl: List[float] = []
    submitted = failed = 0
    for r in records:
        inside = [t for t in r.stamps if t_open < t <= t_close]
        tokens += len(inside)
        if r.stamps and t_open < r.stamps[0] <= t_close:
            first += 1
        itl.extend(b - a for a, b in zip(inside, inside[1:]))
        if t_open <= r.t_submit < t_close:
            submitted += 1
            failed += r.error is not None
            seen = r.stamps[0] if r.stamps and r.stamps[0] <= t_close \
                else t_close
            ttft.append(seen - r.t_submit)
    return {"tokens": tokens, "first": first, "ttft": ttft, "itl": itl,
            "submitted": submitted, "failed": failed,
            "seconds": t_close - t_open}


def end_to_end(nums: Dict) -> Dict[str, float]:
    """The three served metrics of a window."""
    return {"output_tok_s": nums["tokens"] / nums["seconds"],
            "ttft_p90_ms": 1e3 * percentile(nums["ttft"], 90),
            "itl_p95_ms": 1e3 * percentile(nums["itl"], 95)}
