"""setup_program_s: the seconds inside the program's outermost spans
(``ssme_tpu_torch.profiling``) before the traced window: the library's
load (and build), ``pmmh.init`` and the first call of each span of the
window's path, which the program always records.  The program's share
of ``setup_s``; the rest is the import of torch, the CUDA context and
the benchmark's own data.  None where the program records no span.
Layer: set-up.  Moves setup_s."""

from benchmark.lib import program_spans


def read(run):
    recs = program_spans.before_window(run)
    if not recs:
        return None
    return program_spans.union_s(program_spans.outermost(recs))
