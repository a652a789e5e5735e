"""host_ms_per_iter: the host's milliseconds an iteration inside the
program's outermost spans (``ssme_tpu_torch.profiling``) in the traced
window: their union over the window's iterations (``pmmh.draw`` and
``pmmh.step`` in the PMMH cells, ``lw.svol_leverage_lw`` in the Liu-West
cells).  The layer's busy time: once it passes the device's time an
iteration, the host paces the cell.  None where the program records no
span.  Layer: the port's Python host work.  Moves props_per_s."""

from benchmark.lib import program_spans


def read(run):
    recs = program_spans.in_window(run)
    if not recs or not run.iterations:
        return None
    return 1e3 * program_spans.union_s(program_spans.outermost(recs)) \
        / run.iterations
