"""The readers of the program's spans (``lib/program_spans.py``,
``metrics/host_ms_per_iter.py``, ``metrics/setup_program_s.py``) on
synthetic records and a synthetic trace.  CPU only."""

import os

import pytest

from benchmark.lib import program_spans
from benchmark.lib.cell import BENCH_DIR, load_module
from benchmark.lib.trace import Trace
from benchmark.lib.window import Run
from ssme_tpu_torch import profiling
from ssme_tpu_torch.profiling import SpanRecord

MS = 1_000_000
W0 = 10_000 * MS


def _metric(name):
    return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                       "test_metric_" + name)


def _rec(start_ms, end_ms, name, id_, parent=None, key=None):
    return SpanRecord(W0 + int(start_ms * MS), W0 + int(end_ms * MS), name,
                      id_, parent, key)


# set-up before the window (at 0 ms): the library inside init, a first
# draw and step; then two iterations of 10 ms in the window [0, 20)
RECORDS = [
    _rec(-900, -500, "pmmh.init", 1),
    _rec(-850, -600, "kernels.library", 2, 1),
    _rec(-840, -610, "kernels.library.load", 3, 2),
    _rec(-300, -290, "pmmh.draw", 4, None, 1),
    _rec(-290, -200, "pmmh.step", 5, None, 1),
    # iteration 1: draw 1 ms, step 3 ms with a 2-ms likelihood that
    # holds a 1.5-ms launch
    _rec(0, 1, "pmmh.draw", 6, None, 2),
    _rec(1, 4, "pmmh.step", 7, None, 2),
    _rec(1.5, 3.5, "pmmh.likelihood", 8, 7),
    _rec(2, 3.5, "svol_filter.launch", 9, 8),
    # iteration 2, the step running 1 ms past the window's end
    _rec(10, 11, "pmmh.draw", 10, None, 3),
    _rec(11, 21, "pmmh.step", 11, None, 3),
    _rec(12, 20.5, "pmmh.likelihood", 12, 11),
]
# the device busy 0-2.5, 3.5-9.5 and 12-19.5 ms in the window
DEVICE = [(W0, W0 + int(2.5 * MS), "k", None),
          (W0 + int(3.5 * MS), W0 + int(9.5 * MS), "k", None),
          (W0 + 12 * MS, W0 + int(19.5 * MS), "k", None)]


def _run(iterations=2, trace=True):
    tr = Trace(device=DEVICE, spans=[], window=(W0, W0 + 20 * MS)) \
        if trace else None
    return Run(setup_s=1.0, window_s=0.02, iterations=iterations, props=1.0,
               intervals_ms=None, checks=[], attempted=iterations, failed=0,
               memory_peak_bytes=0, layer_span="svol_filter_kernel",
               layer={}, launch_shape={}, trace=tr)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(RECORDS))
    monkeypatch.setattr(profiling, "spans_dropped", lambda: 0)


def test_self_times_and_counts_in_the_window():
    recs = program_spans.in_window(_run(), RECORDS)
    got = program_spans.by_name(recs)
    assert set(got) == {"pmmh.draw", "pmmh.step", "pmmh.likelihood",
                        "svol_filter.launch"}
    assert got["pmmh.draw"]["count"] == 2
    assert got["pmmh.draw"]["self_s"] == pytest.approx(2e-3)
    # steps: 3 ms + 9 ms (clipped at 20), less 2 ms + 8 ms of likelihood
    assert got["pmmh.step"]["total_s"] == pytest.approx(12e-3)
    assert got["pmmh.step"]["self_s"] == pytest.approx(2e-3)
    # likelihoods: 2 ms + 8 ms, less the 1.5-ms launch
    assert got["pmmh.likelihood"]["self_s"] == pytest.approx(8.5e-3)
    assert got["svol_filter.launch"]["self_s"] == pytest.approx(1.5e-3)


def test_outermost_unions():
    recs = program_spans.in_window(_run(), RECORDS)
    outer = program_spans.outermost(recs)
    assert sorted(r.id for r in outer) == [6, 7, 10, 11]
    # [0, 4) and [10, 20): the draws and steps of both iterations
    assert program_spans.union_s(outer) == pytest.approx(14e-3)
    setup = program_spans.before_window(_run(), RECORDS)
    assert sorted(r.id for r in program_spans.outermost(setup)) == [1, 4, 5]
    # init 400 ms, draw 10, step 90
    assert program_spans.union_s(program_spans.outermost(setup)) == \
        pytest.approx(0.5)
    # overlapping and nested intervals count once
    assert program_spans.union_s(RECORDS[:3]) == pytest.approx(0.4)


def test_idle_gaps_are_labelled_by_the_innermost_program_span():
    run = _run()
    gaps = program_spans.idle_gaps(run.trace, RECORDS)
    # the longest first: [9.5, 12) opening between iterations, [2.5, 3.5)
    # in the launch inside the first step's likelihood, [19.5, 20) in the
    # second likelihood
    assert [g[0] for g in gaps] == [program_spans.GAP_OUTSIDE,
                                    "svol_filter.launch", "pmmh.likelihood"]
    assert [g[1] for g in gaps] == pytest.approx([2.5e-3, 1e-3, 0.5e-3])
    assert program_spans.idle_gaps(run.trace, RECORDS, k=1) == [
        [program_spans.GAP_OUTSIDE, pytest.approx(2.5e-3)]]


def test_the_two_metrics(recorded):
    assert _metric("host_ms_per_iter").read(_run()) == pytest.approx(7.0)
    assert _metric("setup_program_s").read(_run()) == pytest.approx(0.5)


@pytest.mark.parametrize("name", ["host_ms_per_iter", "setup_program_s"])
def test_no_program_span_gives_none(monkeypatch, name):
    reader = _metric(name)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read(_run()) is None
    # a program older than its spans
    monkeypatch.delattr(profiling, "spans")
    assert reader.read(_run()) is None


@pytest.mark.parametrize("name", ["host_ms_per_iter", "setup_program_s"])
def test_a_record_that_dropped_spans_or_a_run_without_trace_gives_none(
        recorded, monkeypatch, name):
    reader = _metric(name)
    assert reader.read(_run(trace=False)) is None
    monkeypatch.setattr(profiling, "spans_dropped", lambda: 1)
    assert reader.read(_run()) is None


def test_no_iterations_gives_no_host_time(recorded):
    assert _metric("host_ms_per_iter").read(_run(iterations=0)) is None
