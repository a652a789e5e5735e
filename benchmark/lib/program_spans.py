"""What the program's own spans say about a traced run.

The program records its host work as spans (``ssme_tpu_torch.profiling``:
``spans()`` gives records ``(start_ns, end_ns, name, id, parent_id,
key)`` on ``time.time_ns()``, the clock of the profiler's events and of
the benchmark's window).  It records them while ``torch.profiler`` runs,
so inside a ``--trace 1`` window, and at each span name's first
occurrence in the process, so the set-up's first calls too.  Here: each
name's count, total and self time in the window, the outermost spans,
and the device's idle gaps labelled by the innermost program span open
at the gap's start.

A program that records no span (one without ``profiling.spans``), or
whose record dropped some, gives None to every reader here.
"""

from __future__ import annotations

GAP_OUTSIDE = "between the program's spans"


def records():
    """The program's span records, or None where it records none or
    dropped some."""
    from ssme_tpu_torch import profiling

    read = getattr(profiling, "spans", None)
    if read is None or profiling.spans_dropped():
        return None
    return read() or None


def clipped(recs, lo, hi):
    """The records that overlap [lo, hi), their times clipped to it."""
    return [r._replace(start_ns=max(r.start_ns, lo),
                       end_ns=min(r.end_ns, hi))
            for r in recs if r.end_ns > lo and r.start_ns < hi]


def in_window(run, recs=None):
    """The records of the run's traced window, clipped to it (None
    without a trace or a record)."""
    recs = records() if recs is None else recs
    if not recs or run.trace is None:
        return None
    return clipped(recs, *run.trace.window) or None


def before_window(run, recs=None):
    """The records that began before the traced window, clipped to end
    at its start: the set-up's (None without a trace or a record)."""
    recs = records() if recs is None else recs
    if not recs or run.trace is None:
        return None
    lo = run.trace.window[0]
    return clipped(recs, min(r.start_ns for r in recs), lo) or None


def union_s(recs):
    """Seconds covered by the records' intervals, each instant once."""
    total, end = 0, None
    for s, e in sorted((r.start_ns, r.end_ns) for r in recs):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def outermost(recs):
    """The records whose parent is not among ``recs``."""
    ids = {r.id for r in recs}
    return [r for r in recs if r.parent_id not in ids]


def by_name(recs):
    """{name: {"count", "total_s", "self_s"}}: a span's self time is its
    length less what its children cover."""
    children = {}
    for r in recs:
        children.setdefault(r.parent_id, []).append(r)
    out = {}
    for r in recs:
        row = out.setdefault(r.name, {"count": 0, "total_s": 0.0,
                                      "self_s": 0.0})
        length = (r.end_ns - r.start_ns) / 1e9
        row["count"] += 1
        row["total_s"] += length
        row["self_s"] += length - union_s(
            clipped(children.get(r.id, []), r.start_ns, r.end_ns))
    return out


def idle_gaps(trace, recs, k=10):
    """The k longest idle gaps of the device in the window, each named by
    the innermost program span open on the host at the gap's start:
    [[label, seconds], ...]."""
    lo, hi = trace.window
    gaps, t = [], lo
    for s, e in trace.busy_intervals():
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:k]:
        open_ = [r for r in recs if r.start_ns <= s < r.end_ns]
        label = (min(open_, key=lambda r: r.end_ns - r.start_ns).name
                 if open_ else GAP_OUTSIDE)
        out.append([label, (e - s) / 1e9])
    return out
