"""The port's ``profiling`` (``ssme_tpu_torch/profiling.py``): the cases
of ``tests/test_profiling.py``, and the Chrome trace on the CPU."""

import json
import os

import torch

from ssme_tpu_torch import profiling
from ssme_tpu_torch.profiling import PhaseTimer, throughput

torch.set_num_threads(1)


def test_phase_timer_accumulates():
    pt = PhaseTimer()
    with pt.phase("a") as h:
        h["result"] = torch.arange(8).sum()
    with pt.phase("a"):
        pass
    with pt.phase("b", sync_result=(torch.ones(2), [torch.zeros(1)])):
        pass
    assert pt.counts["a"] == 2 and pt.counts["b"] == 1
    assert pt.totals["a"] >= 0.0
    rep = pt.report()
    assert "a" in rep and "x2" in rep


def test_throughput_metric():
    out = throughput(1_000_000, 0.5, num_devices=2)
    assert out["propagations_per_sec"] == 2_000_000
    assert out["propagations_per_sec_per_chip"] == 1_000_000
    # without a card the default is one device
    assert throughput(10, 1.0)["propagations_per_sec_per_chip"] == \
        10 / max(1, torch.cuda.device_count())


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.randn(64, 64) @ torch.randn(64, 64)
    path = tmp_path / "t" / profiling.TRACE_FILE
    assert os.path.exists(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
