"""Profiling and phase-timing helpers.

PyTorch counterpart of ``ssme_tpu/profiling.py``: a context manager
around ``torch.profiler`` that writes a Chrome trace (the counterpart of
a ``jax.profiler`` trace), a phase timer that waits for the device of a
CUDA result before it stops the clock, and the throughput report for
filter workloads.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

TRACE_FILE = "trace.json"


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


def throughput(props: int, seconds: float,
               num_devices: Optional[int] = None) -> Dict[str, float]:
    """Particle propagations per second, and per card (``num_devices``
    defaults to the CUDA cards present, or 1 without one)."""
    if num_devices is None:
        num_devices = max(1, torch.cuda.device_count())
    per_sec = props / seconds
    return {
        "propagations_per_sec": per_sec,
        "propagations_per_sec_per_chip": per_sec / num_devices,
    }


__all__ = ["trace", "PhaseTimer", "throughput", "TRACE_FILE"]
