"""What a ``torch.profiler`` trace of a window says: device intervals,
the benchmark's spans, and which kernels each span launched.

The device-side rule and the short kernel names are copied from
``ssme_tpu_torch/bench.py`` at commit 979befa (``device_share``: only
device-side events, kernels, memcpy and memset, count, since a CPU op's
device time repeats that of the kernels it launched; ``_short``).  Here
the busy time is the union of those intervals, clipped to the window,
and user annotations on the device timeline are left out.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from dataclasses import dataclass, field

# the benchmark's span around the whole measured window
WINDOW_SPAN = "bench.window"


def short(kernel_name: str) -> str:
    """A kernel's name without its template and argument lists."""
    name = kernel_name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ")
    return re.split(r"[<(]", name)[0]


@dataclass
class Trace:
    """Device events (start_ns, end_ns, name, launch_ns) with the host
    time of their launch where the trace links it (else None), the
    benchmark's spans (start_ns, end_ns, name) on the host, and the
    window (start_ns, end_ns)."""

    device: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    window: tuple = (0, 0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def in_window(self):
        lo, hi = self.window
        return [e for e in self.device if e[1] > lo and e[0] < hi]

    def busy_intervals(self):
        """Merged device intervals clipped to the window."""
        lo, hi = self.window
        out = []
        for s, e, _, _ in sorted(self.in_window()):
            s, e = max(s, lo), min(e, hi)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def span_device_s(self, name: str):
        """(device seconds of every event launched inside the spans named
        ``name``, number of such spans), or (None, 0) where no launch of
        the window can be placed on the host's timeline."""
        spans = sorted((s, e) for s, e, n in self.spans if n == name)
        starts = [s for s, _ in spans]
        events = self.in_window()
        if not spans or not any(ev[3] is not None for ev in events):
            return None, len(spans)
        total = 0
        for s, e, _, launch in events:
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= spans[i][1]:
                total += e - s
        return total / 1e9, len(spans)

    def top_ops(self, k=10):
        """The k device operations by total seconds in the window."""
        by = {}
        for s, e, name, _ in self.in_window():
            by[short(name)] = by.get(short(name), 0) + (e - s) / 1e9
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k=10):
        """The k longest idle gaps of the device in the window, each
        named by the innermost benchmark span open on the host at the
        gap's start: [[label, seconds], ...]."""
        lo, hi = self.window
        busy = self.busy_intervals()
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        spans = [sp for sp in self.spans if sp[2] != WINDOW_SPAN]
        out = []
        for s, e in gaps[:k]:
            open_ = [sp for sp in spans if sp[0] <= s < sp[1]]
            label = (min(open_, key=lambda sp: sp[1] - sp[0])[2] if open_
                     else "between the benchmark's spans")
            out.append([label, (e - s) / 1e9])
        return out


class Spans:
    """The benchmark's own spans: each ``span(name)`` is a
    ``torch.profiler.record_function`` range and, while ``recording``,
    also a (start_ns, end_ns, name) record on the host's wall clock, the
    clock of the profiler's events."""

    def __init__(self):
        self.recording = False
        self.records = []

    @contextlib.contextmanager
    def span(self, name):
        from torch.profiler import record_function

        with record_function(name):
            if not self.recording:
                yield
                return
            start = time.time_ns()
            try:
                yield
            finally:
                self.records.append((start, time.time_ns(), name))


def from_profiler(prof, spans) -> Trace:
    """Read a finished ``torch.profiler.profile``'s raw device and launch
    events, with the benchmark's span records ``spans`` (one of them the
    window)."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    events = [ev for ev in prof.profiler.kineto_results.events()
              if not ev.is_user_annotation()]
    launches = {ev.correlation_id(): ev.start_ns() for ev in events
                if ev.device_type() == cpu and ev.name().startswith("cu")}
    device = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name(),
               launches.get(ev.correlation_id())) for ev in events
              if ev.device_type() != cpu and ev.duration_ns() > 0]
    windows = [(s, e) for s, e, n in spans if n == WINDOW_SPAN]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} "
                           f"{WINDOW_SPAN!r} spans, want 1")
    return Trace(device=device,
                 spans=[sp for sp in spans if sp[2] != WINDOW_SPAN],
                 window=windows[0])
