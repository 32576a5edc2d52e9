"""The model step as a whole: useful FLOPs of the traced stretch's
dispatches (``roofline_work.dispatch_flops``) over the stretch's seconds at
the card's bf16 peak, in %."""
from sealbench import roofline_work as W


def read(run):
    if run.stretch is None or not run.dispatches:
        return None
    flops = sum(W.dispatch_flops(run.config, d["shape"])
                for d in run.dispatches)
    return 100.0 * flops / (run.stretch.window_s * W.PEAK_BF16)
