"""svol_filter_kernel_roofline: percent, the least time of the window's launches of
this layer (its frozen operations and bytes at the cell's shapes) over the
device time of every kernel launched inside the benchmark's
``svol_filter_kernel`` span.  Moves props_per_s."""

from benchmark.lib.roofline import roofline_share


def read(run):
    if run.layer_span != "svol_filter_kernel":
        return None
    return roofline_share(run)
