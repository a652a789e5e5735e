"""device_kernels_per_iter: device-side operations (kernels, memcpy,
memset) of the traced window over its iterations: the launch cost of the
PMMH host step.  Layer: the PMMH host step (inference/pmmh.py).  Moves
props_per_s."""


def read(run):
    n = len(run.trace.in_window())
    if not n or not run.iterations:
        return None
    return n / run.iterations
