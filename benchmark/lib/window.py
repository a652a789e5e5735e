"""The measured window, and what a run hands to the reporting step.

After each iteration the loop records a CUDA event; it stops enqueueing
once the host clock passes the window's seconds, then synchronises.  The window runs from the start event (the
device idle, just after a synchronisation) to that final synchronisation;
an iteration's interval is the time between consecutive iteration-end
events, which counts the device's waits on the host.  The host stays at
most LEAD iterations ahead of the device (before it enqueues iteration i
it waits for the end of iteration i - LEAD): the device always has work
queued, and the window ends within a few iterations of its seconds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from benchmark.lib import trace as trace_lib

LEAD = 4


@dataclass
class Run:
    """One run of a cell: the work and time of its window, its checks,
    and (traced runs) the trace.  ``checks`` holds (name, value, limit)
    triples: a run is correct when every value is finite and at most its
    limit."""

    setup_s: float
    window_s: float
    iterations: int
    props: float
    intervals_ms: list
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    # the benchmark's span around each call into the measured layer, the
    # frozen counts of that layer (the configuration's ``paths`` entry),
    # and the rows, particles and steps of one call
    layer_span: str
    layer: dict
    launch_shape: dict
    trace: object = None
    notes: dict = field(default_factory=dict)

    @property
    def correct(self):
        return all(v is not None and v == v and v <= lim
                   for _, v, lim in self.checks)


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(step, seconds, device, spans, trace=False):
    """Call ``step(i)`` for i = 0, 1, ... until ``seconds`` have passed on
    the host clock, inside the benchmark's window span.  Returns (window
    seconds, iterations, intervals in ms (None off the card), trace (None
    unless ``trace``: the window then runs under ``torch.profiler``,
    recording the device's activity and the launches, and the benchmark's
    ``spans`` record their times))."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    prof = None
    if trace:
        prof = profile(activities=[ProfilerActivity.CUDA] if cuda
                       else [ProfilerActivity.CPU])
        prof.start()
        spans.recording = True
    synchronize(device)
    events = []
    with spans.span(trace_lib.WINDOW_SPAN):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            if cuda and i >= LEAD:
                events[i - LEAD].synchronize()
            step(i)
            i += 1
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
        synchronize(device)
        window_s = time.perf_counter() - t0
    tr = None
    if prof is not None:
        prof.stop()
        spans.recording = False
        tr = trace_lib.from_profiler(prof, spans.records)
    intervals = None
    if cuda:
        intervals = [a.elapsed_time(b)
                     for a, b in zip([start] + events[:-1], events)]
    return window_s, i, intervals, tr
