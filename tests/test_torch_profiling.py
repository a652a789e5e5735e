"""The port's ``profiling`` (``ssme_tpu_torch/profiling.py``): the cases
of ``tests/test_profiling.py`` that it has, the Chrome trace on the CPU,
and the program's spans: when they are recorded, their parents, keys and
clock, and the spans of the PMMH step and the Liu-West wrapper."""

import importlib
import inspect
import itertools
import json
import os
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ssme_tpu_torch import profiling
from ssme_tpu_torch.inference import AdaptivePMMH
from ssme_tpu_torch.inference import pmmh as pmmh_mod
from ssme_tpu_torch.models import svol
from ssme_tpu_torch.ops import liu_west_megakernel as lwm
from ssme_tpu_torch.ops import svol_leverage_lw_kernel as k4
from ssme_tpu_torch.profiling import PhaseTimer

torch.set_num_threads(1)

_fresh = itertools.count()


def _name(tag):
    """A span name no other test of the process has opened."""
    return f"test.{tag}.{os.getpid()}.{next(_fresh)}"


@pytest.fixture(autouse=True)
def _clear_spans():
    profiling.reset()
    yield
    profiling.reset()


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


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.randn(64, 64) @ torch.randn(64, 64)
    path = tmp_path / "t" / profiling.TRACE_FILE
    assert os.path.exists(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_trace_shows_the_program_spans(tmp_path):
    name = _name("chrome")
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span(name):
            torch.randn(8, 8).sum()
    with open(tmp_path / "t" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == name for e in events)


def test_nothing_is_recorded_with_recording_off():
    name = _name("off")
    with profiling.span(name):      # the first occurrence
        pass
    profiling.reset()
    ctx = profiling.span(name)
    assert ctx is profiling.span(name)   # one shared no-op
    with ctx as entered:
        assert entered is None
    assert profiling.spans() == [] and profiling.spans_dropped() == 0


def test_a_record_is_taken_under_a_profiler_and_under_record():
    name = _name("on")
    with profiling.span(name):
        pass
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span(name, key=1):
            pass
    with profiling.record():
        with profiling.span(name, key=2) as sp:
            pass
    assert sp.seconds >= 0.0
    recs = profiling.spans()
    assert [(r.name, r.key) for r in recs] == [(name, 1), (name, 2)]
    assert all(r.start_ns <= r.end_ns for r in recs)
    with profiling.span(name):      # off again
        pass
    assert len(profiling.spans()) == 2


def test_parents_and_keys():
    outer, inner, leaf = _name("outer"), _name("inner"), _name("leaf")
    with profiling.record():
        with profiling.span(outer, key=7):
            with profiling.span(inner):
                with profiling.span(leaf, key="k"):
                    pass
            with profiling.span(inner):
                pass
        with profiling.span(leaf):
            pass
    recs = {(r.name, r.id): r for r in profiling.spans()}
    by = {}
    for (n, _), r in sorted(recs.items(), key=lambda kv: kv[1].start_ns):
        by.setdefault(n, []).append(r)
    (o,), (i1, i2), (l1, l2) = by[outer], by[inner], by[leaf]
    assert o.parent_id is None and o.key == 7
    assert i1.parent_id == i2.parent_id == o.id
    assert l1.parent_id == i1.id and l1.key == "k"
    assert l2.parent_id is None and l2.key is None
    assert len({r.id for r in recs.values()}) == 5
    assert o.start_ns <= i1.start_ns <= l1.end_ns <= i2.start_ns <= o.end_ns


def test_the_first_occurrence_of_a_name_is_recorded():
    a, b = _name("first_a"), _name("first_b")
    for _ in range(3):
        with profiling.span(a):
            with profiling.span(b):
                pass
    recs = profiling.spans()
    assert [r.name for r in recs] == [b, a]
    assert recs[0].parent_id == recs[1].id


def test_the_bounded_list_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 4)
    name = _name("bound")
    with profiling.record():
        for k in range(10):
            with profiling.span(name, key=k):
                pass
    assert [r.key for r in profiling.spans()] == [0, 1, 2, 3]
    assert profiling.spans_dropped() == 6
    profiling.reset()
    assert profiling.spans() == [] and profiling.spans_dropped() == 0


def test_spans_share_the_profilers_clock():
    """A program span around a CPU matmul holds the matmul's Kineto
    event: the span's clock is the profiler's."""
    name = _name("clock")
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span(name):
            a @ a
    (rec,) = profiling.spans()
    mm = [ev for ev in prof.profiler.kineto_results.events()
          if ev.name() in ("aten::mm", "aten::matmul")]
    assert mm
    for ev in mm:
        assert rec.start_ns <= ev.start_ns()
        assert ev.start_ns() + ev.duration_ns() <= rec.end_ns


def test_a_pmmh_step_records_its_named_spans():
    ys = torch.randn(24)
    pmmh = AdaptivePMMH(svol.make_model(), num_particles=16,
                        num_replicates=2, t0=1, t1=5)
    state = pmmh.init(0, svol.START_TRANS_THETA, ys, num_chains=3)
    state, _ = pmmh.step(state, ys)
    profiling.reset()
    with profiling.record():
        state, _ = pmmh.step(state, ys)
    recs = profiling.spans()
    names = [r.name for r in recs]
    want = [n for n in pmmh_mod.HOST_SPANS if n != "pmmh.init"]
    assert sorted(names) == sorted(want)
    by = {r.name: r for r in recs}
    step = by["pmmh.step"]
    assert step.parent_id is None and step.key == state.iteration == 2
    assert by["pmmh.draw"].key == step.key
    for n in want:
        if n != "pmmh.step":
            assert by[n].parent_id == step.id, n
            assert step.start_ns <= by[n].start_ns <= by[n].end_ns \
                <= step.end_ns
    # draw, then step, as a caller that keeps the draws runs them
    profiling.reset()
    with profiling.record():
        eps, log_u = pmmh.draw(state)
        pmmh.step(state, ys, eps, log_u)
    keys = {r.name: (r.key, r.parent_id) for r in profiling.spans()}
    assert keys["pmmh.draw"] == (3, None) and keys["pmmh.step"] == (3, None)


def test_the_cpu_liu_west_wrapper_records_its_spans():
    ys = 0.01 * torch.randn(20)
    with profiling.record():
        k4.svol_leverage_lw(5, ys, num_filters=2, num_particles=32)
    recs = profiling.spans()
    by = {r.name: r for r in recs}
    assert sorted(by) == sorted(k4.HOST_SPANS + lwm.HOST_SPANS[:1])
    top = by["lw.svol_leverage_lw"]
    assert top.parent_id is None
    assert by["lw.covariates"].parent_id == top.id
    assert by["lw.validate"].parent_id == top.id
    assert by["lw.covariates"].end_ns <= by["lw.validate"].start_ns


@pytest.mark.parametrize("module", [
    "ssme_tpu_torch.inference.pmmh", "ssme_tpu_torch.ops._cuda",
    "ssme_tpu_torch.ops.svol_filter_kernel",
    "ssme_tpu_torch.ops.filter_megakernel",
    "ssme_tpu_torch.ops.liu_west_megakernel",
    "ssme_tpu_torch.ops.svol_leverage_lw_kernel"])
def test_each_module_names_the_spans_it_opens(module):
    mod = importlib.import_module(module)
    opened = re.findall(r'profiling\.span\("([^"]+)"', inspect.getsource(mod))
    assert sorted(set(opened)) == sorted(mod.HOST_SPANS)
    assert len(opened) == len(mod.HOST_SPANS)
    assert not any(n.startswith("cu") for n in opened)
