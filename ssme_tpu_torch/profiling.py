"""Profiling: the program's spans, a trace and a phase timer.

PyTorch counterpart of ``ssme_tpu/profiling.py``: a context manager
around ``torch.profiler`` that writes a Chrome trace (the counterpart of
a ``jax.profiler`` trace) and a phase timer that waits for the device of
a CUDA result before it stops the clock; besides them, the port's own
host spans.

Spans.  ``with span("pmmh.step", key=i):`` marks a piece of the
program's host work.  A recorded span is a :class:`SpanRecord`
``(start_ns, end_ns, name, id, parent_id, key)``: times on
``time.time_ns()``, the clock of ``torch.profiler``'s (Kineto's) events,
so a program span and the device activity it launched lie on one
timeline; ``parent_id`` the innermost recorded span open on the same
thread when it began (None at the top); ``key`` whatever the caller
passes, the MH iteration in ``inference/pmmh.py``, so the spans of one
iteration share it.  While a profiler runs, a recorded span also enters
a ``torch.profiler.record_function`` of its name, so :func:`trace`'s
Chrome trace shows the program's layers.

Spans are recorded while a ``torch.profiler`` session runs, and inside
``with record():`` (no profiler needed).  Besides, the first occurrence
of each span name in a process is always recorded: first calls are where
the kernels are built or loaded and lazy modules and handles are made.
Otherwise a span costs a flag check and a set lookup.  Records stay in
memory, at most ``MAX_SPANS`` of them (later ones are counted and
dropped): :func:`spans` reads them, :func:`spans_dropped` counts the
dropped ones, :func:`reset` clears both.  Each module that opens spans
names them in its ``HOST_SPANS`` tuple.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_FILE = "trace.json"
# the most span records kept; later ones are counted in spans_dropped()
MAX_SPANS = 1 << 16


class SpanRecord(NamedTuple):
    start_ns: int
    end_ns: int
    name: str
    id: int
    parent_id: Optional[int]
    key: Any


class _Stack(threading.local):
    def __init__(self):
        self.ids: List[int] = []


class _Recorder:
    """The process's span records, and which names have been seen."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: list = []
        self.dropped = 0
        self.seen: set = set()
        self.forced = 0
        self.ids = itertools.count(1)
        self.stack = _Stack()

    def add(self, rec: tuple) -> None:
        if len(self.records) < MAX_SPANS:
            self.records.append(rec)
        else:
            self.dropped += 1


_REC = _Recorder()
_OFF = contextlib.nullcontext()


class _Span:
    """A span being recorded; after it ends, ``seconds`` is its length."""

    __slots__ = ("name", "key", "id", "parent_id", "start_ns", "end_ns",
                 "_fn")

    def __init__(self, name: str, key):
        self.name, self.key = name, key

    def __enter__(self):
        _REC.seen.add(self.name)
        stack = _REC.stack.ids
        self.parent_id = stack[-1] if stack else None
        self.id = next(_REC.ids)
        stack.append(self.id)
        self._fn = None
        if _autograd_profiler._is_profiler_enabled:
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        _REC.stack.ids.pop()
        _REC.add((self.start_ns, self.end_ns, self.name, self.id,
                  self.parent_id, self.key))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def span(name: str, key=None):
    """A context manager around a piece of the program's host work: a
    recorded span (entered, it gives itself) while a ``torch.profiler``
    session runs, inside :func:`record`, or at the name's first
    occurrence in the process; else a shared no-op (entered, None)."""
    if (_autograd_profiler._is_profiler_enabled or _REC.forced
            or name not in _REC.seen):
        return _Span(name, key)
    return _OFF


@contextlib.contextmanager
def record():
    """Record every span opened inside, without a profiler."""
    with _REC.lock:
        _REC.forced += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.forced -= 1


def spans() -> List[SpanRecord]:
    """The recorded spans, in the order they ended."""
    return [SpanRecord(*r) for r in list(_REC.records)]


def spans_dropped() -> int:
    """Records dropped since the last :func:`reset` (past ``MAX_SPANS``)."""
    return _REC.dropped


def reset() -> None:
    """Clear the records and the count of dropped ones (the names seen
    stay seen: a first occurrence happens once a process)."""
    _REC.records.clear()
    _REC.dropped = 0


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the host and, once CUDA is in use, the card; on exit the
    trace is written to ``log_dir/trace.json`` as a Chrome trace
    (chrome://tracing, Perfetto), kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of ``result`` (a
    tensor, or tuples, lists and dicts of them)."""
    devices, stack = set(), [result]
    while stack:
        obj = stack.pop()
        if isinstance(obj, torch.Tensor):
            if obj.device.type == "cuda":
                devices.add(obj.device)
        elif isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (tuple, list)):
            stack.extend(obj)
    for dev in devices:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Wall-clock phase timing with device synchronization.

    Usage::

        pt = PhaseTimer()
        with pt.phase("first") as h:
            h["result"] = step_fn(state)   # first call builds the kernels
        with pt.phase("run") as h:
            h["result"] = step_fn(state)
        print(pt.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_result=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            if "result" in holder:
                _synchronize(holder["result"])
            elif sync_result is not None:
                _synchronize(sync_result)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total:10.4f}s  x{n}"
                         f"  ({total / n:.4f}s avg)")
        return "\n".join(lines)


__all__ = ["trace", "PhaseTimer", "TRACE_FILE", "span", "record", "spans",
           "spans_dropped", "reset", "SpanRecord", "MAX_SPANS"]
