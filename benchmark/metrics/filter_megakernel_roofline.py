"""filter_megakernel_roofline: percent, the least time of the window's launches of
this layer (its frozen operations and bytes at the cell's shapes) over the
device time of every kernel launched inside the benchmark's
``filter_megakernel`` span.  Moves props_per_s."""

from benchmark.lib.roofline import roofline_share


def read(run):
    if run.layer_span != "filter_megakernel":
        return None
    return roofline_share(run)
