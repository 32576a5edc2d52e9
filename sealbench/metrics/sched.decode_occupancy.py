"""Scheduler: tokens from decode ticks over (decode ticks x slots) in the
window. The engine's counters (``ServeEngine.stats``) less the first
tokens, which the chunked prefill makes and the harness counts."""


def read(run):
    ticks = run.stats_delta.get("decode_steps", 0)
    if not ticks:
        return None
    decoded = run.stats_delta["tokens"] - run.window["first"]
    return decoded / (ticks * run.mix["slots"])
