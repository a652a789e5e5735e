"""lw_megakernel_roofline: percent, the least time of the window's
launches of K3 (the configuration's frozen operations and bytes of the
cell's instance, ``paths["lw_megakernel.<instance>"]``, at the cell's
shapes) over the device time of every kernel launched inside the
benchmark's ``lw_megakernel`` span.  None in a cell whose driver opens no
such span.  Moves props_per_s."""

from benchmark.lib.roofline import roofline_share


def read(run):
    if run.layer_span != "lw_megakernel":
        return None
    return roofline_share(run)
