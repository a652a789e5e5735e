"""filter_megakernel_host_ms: the host's milliseconds an iteration inside
the program's ``filter_megakernel.launch`` spans whose key is the cell's
K2 instance (the driver's ``kernel_instance`` note), in the traced
window: their union over the window's iterations.  The wrapper's host
cost of each launch (the model's id, the output allocations, the C
call).  None where the cell runs no K2 instance or the program records
no such span (a program whose K2 span carries no key).  Layer: the
generic likelihood hook and K2.  Moves props_per_s."""

from benchmark.lib import program_spans


def read(run):
    instance = run.notes.get("kernel_instance")
    recs = program_spans.in_window(run) if instance else None
    if not recs or not run.iterations:
        return None
    mine = [r for r in recs if r.name == "filter_megakernel.launch"
            and r.key == instance]
    if not mine:
        return None
    return 1e3 * program_spans.union_s(mine) / run.iterations
