"""The factor Liu-West cell (``factor_svol_5_lw.lw_apf_n1024``, driver
``liu_west_factor``): the program as it is comes out correct, the control
(the float64 reference computed in bfloat16 in its place) does not, and
three faults planted under the timed path each come out not correct:
half the filters never written, two parameter rows of the cloud written
in each other's place, one filter's evidence counted twice.

The numbers are statistics over the pass's 64 filters, so the card tests
(``cuda``) read them at the cell's own size; on the CPU, at a size a test
run holds, the driver runs end to end and the faults that no statistic
hides show.  Run on the card with ``python -m pytest benchmark/tests -m
cuda``."""

import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark.lib.cell import BENCH_DIR, Cell, load_cell

CELL = "factor_svol_5_lw.lw_apf_n1024"
SEED = 2_900_000_023


def _limits():
    with open(os.path.join(BENCH_DIR, "limits", CELL + ".json")) as f:
        return {k: v["limit"] for k, v in json.load(f).items()}


def _patch(monkeypatch, change):
    """Wrap the program's lw_megakernel: its outputs changed by ``change``
    where they are produced."""
    from ssme_tpu_torch.ops import liu_west_megakernel as lwm

    orig = lwm.lw_megakernel

    def lw(*args, **kwargs):
        out = dict(orig(*args, **kwargs))
        change(out)
        return out

    monkeypatch.setattr(lwm, "lw_megakernel", lw)


def _half_left_out(out):
    """The second half of the filters never written."""
    f = out["log_likelihood"].shape[0]
    out["log_likelihood"] = out["log_likelihood"].clone()
    out["log_likelihood"][f // 2:] = 0.0
    out["cloud"] = out["cloud"].clone()
    out["cloud"][f // 2:] = 0.0


def _rows_swapped(out):
    """The cloud rows of mu1 and mu2 written in each other's place."""
    cloud = out["cloud"].clone()
    cloud[:, [5, 6]] = cloud[:, [6, 5]]
    out["cloud"] = cloud


def _one_filter_twice(out):
    """One filter's evidence counted twice; the others untouched."""
    ll = out["log_likelihood"].clone()
    ll[0] = 2.0 * ll[0]
    out["log_likelihood"] = ll


FAULTS = {"half_left_out": _half_left_out, "rows_swapped": _rows_swapped,
          "one_filter_twice": _one_filter_twice}


def _run(cell, device, seconds=4.0, control=False):
    return cell.driver().run(cell, SEED, seconds, False, time.time(), device,
                             _limits(), control=control)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the faults are read at the "
                    "cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_program_passes_and_control_fails():
    run = _run(load_cell(CELL), _card(), control=True)
    assert run.correct, run.checks
    assert run.failed == 0 and run.iterations >= 16
    limits = _limits()
    ctrl = dict(run.notes["control"])
    assert any(not (ctrl[k] <= limits[k]) for k in limits), ctrl


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    dev = _card()
    _patch(monkeypatch, FAULTS[fault])
    run = _run(load_cell(CELL), dev)
    assert not run.correct, run.checks


class _Small(Cell):
    """The cell cut to the CPU: the panel's first 200 steps, F = 4, N =
    64 (the plain version runs): enough steps that half a filter's
    evidence (~1100 nats) outweighs the mean gap's limit, set at T =
    3084.  A filter counted twice moves the sorted gap by its evidence
    alone, under that limit (3000) below ~550 steps: the card holds it."""

    def __init__(self):
        c = load_cell(CELL)
        super().__init__(c.name, c.chips, dict(c.config, num_particles=64),
                         dict(c.traffic, filters=4), c.end_to_end,
                         c.per_layer)

    def data_path(self, rel):
        path = super().data_path(rel)
        short = os.path.join(BENCH_DIR, "cache", "factor_panel_200.csv")
        os.makedirs(os.path.dirname(short), exist_ok=True)
        # written whole under another name, then renamed: a second test
        # process may be reading the file
        tmp = f"{short}.{os.getpid()}"
        np.savetxt(tmp, np.loadtxt(path, delimiter=",", ndmin=2)[:200],
                   delimiter=",")
        os.replace(tmp, short)
        return short


@pytest.mark.parametrize("fault", [None, "half_left_out"])
def test_driver_runs_on_cpu_and_planted_faults_show(fault, monkeypatch):
    torch.set_num_threads(2)
    if fault:
        _patch(monkeypatch, FAULTS[fault])
    run = _run(_Small(), torch.device("cpu"), seconds=0.1)
    values = {n: v for n, v, _ in run.checks}
    assert set(values) == {"ll_mean_gap", "ll_sorted_max_gap", "cloud_z"}
    assert np.isfinite(list(values.values())).all()
    assert run.iterations >= 1 and run.notes["checked_passes"] == [0]
    if fault:
        assert not run.correct, run.checks
