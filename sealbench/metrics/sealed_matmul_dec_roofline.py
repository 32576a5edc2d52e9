"""``kernels/sealed_matmul.py``'s decode kernel: the bound of its launches
in the traced stretch over its device time, in %."""
from sealbench import readers


def read(run):
    if run.stretch is None:
        return None
    bounds = readers.matmul_bound_ms(run)
    if bounds is None:
        return None
    ms, counted = bounds["sealed_matmul_dec"]
    return readers.share(ms, counted, run.stretch, "sealed_matmul_dec_kernel")
