"""lw_megakernel_host_ms: the host's milliseconds a pass inside the
program's ``lw_megakernel.launch`` spans whose key names the cell's K3
instance (the key is "<instance>.<layout>"; the driver's
``kernel_instance`` note), in the traced window: their union over the
window's passes.  The wrapper's host cost of each launch (the model's
id, the layout, the output allocations, the argument block, the C
call).  None where the cell runs no K3 instance or the program records no
such span (a program whose K3 span is keyed by the layout alone).  Layer:
the Liu-West wrapper and K3.  Moves props_per_s."""

from benchmark.lib import program_spans


def read(run):
    instance = run.notes.get("kernel_instance")
    recs = program_spans.in_window(run) if instance else None
    if not recs or not run.iterations:
        return None
    mine = [r for r in recs if r.name == "lw_megakernel.launch"
            and isinstance(r.key, str)
            and r.key.split(".")[0] == instance]
    if not mine:
        return None
    return 1e3 * program_spans.union_s(mine) / run.iterations
