"""The factor-SVOL cell (``factor_svol_5.pmmh_k2_parity``, driver
``pmmh_k2``): the program passes and the control fails, and each PMMH
fault of ``test_bench_faults.py`` comes out not correct, at the cell's
own size on the card (``cuda``); on the CPU, at a size a test run holds,
the faults that no statistic hides, and the new metrics' readers.  Run
on the card with ``python -m pytest benchmark/tests -m cuda``."""

import math

import pytest
import torch
from test_bench_faults import PMMH_FAULTS, _card, _failed, _limits, _run

from benchmark.lib.cell import Cell, load_cell
from benchmark.lib.trace import Trace
from benchmark.lib.window import Run

CELL = "factor_svol_5.pmmh_k2_parity"


@pytest.mark.cuda
def test_program_passes_and_control_fails():
    dev = _card()
    run = _run(load_cell(CELL), dev, control=True)
    assert run.correct, run.checks
    limits = _limits(CELL)
    ctrl = dict(run.notes["control"])
    assert any(not (ctrl[k] <= limits[k]) for k in limits), ctrl


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(PMMH_FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    dev = _card()
    cell = load_cell(CELL)
    drv = cell.driver()
    PMMH_FAULTS[fault](monkeypatch, drv)
    run = _run(cell, dev, drv=drv)
    assert not run.correct, run.checks


def _small(tmp_path):
    """The cell cut to the CPU: the first 60 steps, N = 128, 16 chains,
    four sampled iterations."""
    import numpy as np

    c = load_cell(CELL)
    ys = np.loadtxt(c.data_path(c.config["data"]), delimiter=",")[:60]
    np.savetxt(tmp_path / "ys.csv", ys, delimiter=",")
    cfg = dict(c.config, num_particles=128, data=str(tmp_path / "ys.csv"))
    tr = dict(c.traffic, chains=16, check_iterations=4)
    return Cell(c.name, c.chips, cfg, tr, c.end_to_end, c.per_layer)


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_fault_on_cpu(fault, monkeypatch, tmp_path):
    torch.set_num_threads(2)
    cell = _small(tmp_path)
    sound = _run(cell, torch.device("cpu"), seconds=2.0)
    assert sound.correct, sound.checks
    drv = cell.driver()
    PMMH_FAULTS[fault](monkeypatch, drv)
    run = _run(cell, torch.device("cpu"), seconds=2.0, drv=drv)
    assert _failed(run), run.checks


def _stub_run(span, notes):
    return Run(setup_s=1.0, window_s=1.0, iterations=4, props=4.0,
               intervals_ms=[1.0] * 4, checks=[], attempted=4, failed=0,
               memory_peak_bytes=0, layer_span=span,
               layer={"ops_per_prop": 166, "bytes_in": {"1": 16},
                      "bytes_out": {"B": 4}},
               launch_shape=dict(B=256, N=1024, T=3084),
               trace=Trace(device=[(100, 200, "k", 150)],
                           spans=[(120, 180, span)], window=(0, 1000)),
               notes=notes)


def test_new_readers_read_only_their_cell(monkeypatch):
    """The K2 roofline reads only the ``filter_megakernel`` span, the
    host milliseconds only the program's launch spans keyed by the cell's
    instance; a program whose spans carry no key gives None."""
    from benchmark.lib import program_spans

    cell = load_cell(CELL)
    roof = cell.metric("filter_megakernel_roofline")
    host = cell.metric("filter_megakernel_host_ms")
    assert roof.read(_stub_run("svol_filter_kernel", {})) is None
    share = roof.read(_stub_run("filter_megakernel", {}))
    want = 100.0 * 166 * 256 * 1024 * 3084 / 67e12 / 100e-9
    assert math.isclose(share, want, rel_tol=1e-9)

    from ssme_tpu_torch.profiling import SpanRecord

    recs = [SpanRecord(10, 30, "filter_megakernel.launch", 1, None,
                       "factor_svol_5"),
            SpanRecord(40, 90, "filter_megakernel.launch", 2, None,
                       "svol_leverage"),
            SpanRecord(100, 140, "pmmh.step", 3, None, 1001)]
    monkeypatch.setattr(program_spans, "records", lambda: recs)
    run = _stub_run("filter_megakernel", {"kernel_instance": "factor_svol_5"})
    assert math.isclose(host.read(run), 1e3 * 20e-9 / 4)
    assert host.read(_stub_run("svol_filter_kernel", {})) is None
    unkeyed = [r._replace(key=None) for r in recs]
    monkeypatch.setattr(program_spans, "records", lambda: unkeyed)
    assert host.read(run) is None
