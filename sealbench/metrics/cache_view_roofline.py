"""``kernels/chacha20.py``'s cache view (``chacha20_cache_view``, one a
layer a dispatch): the bound of its launches in the traced stretch (live
words read, the view written, a pad per live unit) over its device time,
in %."""
from sealbench import readers
from sealbench import roofline_work as W

COUNTER = "chacha20_cache_view"


def read(run):
    if run.stretch is None or not run.dispatches:
        return None
    ms, counted = 0.0, 0
    for d in run.dispatches:
        launches = W.view_launches(run.config, d["shape"],
                                   run.mix["block_size"])
        if d["after"][COUNTER] - d["before"][COUNTER] != len(launches):
            return None
        ms += sum(W.pad_bound(b, p)[0] for b, p in launches)
        counted += len(launches)
    return readers.share(ms, counted, run.stretch, "cache_view_kernel")
