"""mfu: percent of the card's float32 peak that the window's counted
operations fill (the layer's frozen operations a propagation, times the
propagations of the traced window, over its seconds on the host's clock
times 67e12).  It is the traced run's props_per_s times a constant of the
configuration, read from the host's clock and not from the device; it
stays because it counts the same work whatever computes it, and so
bounds a gain after a kernel is renamed or taken off the path.  Layer:
the whole step.  Moves props_per_s."""

from benchmark.lib.roofline import PEAK_F32_PER_S


def read(run):
    window = run.trace.window_s
    if window <= 0 or run.props <= 0:
        return None
    return 100.0 * run.layer["ops_per_prop"] * run.props \
        / (window * PEAK_F32_PER_S)
