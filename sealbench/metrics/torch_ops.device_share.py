"""Model code in PyTorch ops (``models/layers.py::_sdpa``, casts, copies):
device time in operations that are not one of the program's own kernels
(``__global__`` functions of its CUDA sources) over all device time of the
traced stretch, in %."""


def read(run):
    s = run.stretch
    if s is None or not run.port_kernels:
        return None
    total = sum(s.by_name().values())
    own = sum(s.time_of(k)[0] for k in run.port_kernels)
    if total <= 0:
        return None
    return 100.0 * (total - own) / total
