"""The cell of factor SV as published (``factor_svol_sv_10.pmmh_sv_parity``,
driver ``pmmh_k2_sv``): the program passes and the control fails, each
PMMH fault of ``test_bench_faults.py`` comes out not correct, and so does
this model's own fault, the idiosyncratic log-variances frozen at their
stationary means (the constant-d model in the program's place), at the
cell's own size on the card (``cuda``); on the CPU, at a size a test run
holds, the faults that no statistic hides.  Run on the card with
``python -m pytest benchmark/tests -m cuda``."""

import pytest
import torch
from test_bench_faults import (PMMH_FAULTS, _card, _failed, _limits, _run,
                               _wrap_program)

from benchmark.lib.cell import Cell, load_cell

CELL = "factor_svol_sv_10.pmmh_sv_parity"


def _idio_frozen(monkeypatch, drv):
    """The idiosyncratic log-variances frozen at their stationary means:
    every row the hook is handed has the sigma of its n idiosyncratic
    leaves set to 0 where the hook reads it, so the kernel filters the
    constant-d model, d = e^{mu_u}, in the published model's place."""
    def wrap(hook, config, traffic, device, orig):
        k, m = config["k_factors"], config["k_factors"] + config["n_assets"]

        def frozen(gen, params, ys, *zs):
            p = params.clone()
            p[:, 2 * m + k:3 * m] = 0.0
            return hook(gen, p, ys, *zs)
        return frozen
    _wrap_program(monkeypatch, drv, wrap)


FAULTS = dict(PMMH_FAULTS, idio_frozen=_idio_frozen)


@pytest.mark.cuda
def test_program_passes_and_control_fails():
    dev = _card()
    run = _run(load_cell(CELL), dev, control=True)
    assert run.correct, run.checks
    limits = _limits(CELL)
    ctrl = dict(run.notes["control"])
    assert any(not (ctrl[k] <= limits[k]) for k in limits), ctrl


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    dev = _card()
    cell = load_cell(CELL)
    drv = cell.driver()
    FAULTS[fault](monkeypatch, drv)
    run = _run(cell, dev, drv=drv)
    assert not run.correct, run.checks


def _small(tmp_path):
    """The cell cut to the CPU: the first 40 steps, N = 512, 32 chains,
    four sampled iterations (a chain's estimate there spreads by ~1 nat,
    so 128 gaps put the mean gap's standard error near 0.1)."""
    import numpy as np

    c = load_cell(CELL)
    ys = np.loadtxt(c.data_path(c.config["data"]), delimiter=",")[:40]
    np.savetxt(tmp_path / "ys.csv", ys, delimiter=",")
    cfg = dict(c.config, num_particles=512, data=str(tmp_path / "ys.csv"))
    tr = dict(c.traffic, chains=32, check_iterations=4)
    return Cell(c.name, c.chips, cfg, tr, c.end_to_end, c.per_layer)


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "idio_frozen"])
def test_fault_on_cpu(fault, monkeypatch, tmp_path):
    torch.set_num_threads(2)
    cell = _small(tmp_path)
    sound = _run(cell, torch.device("cpu"), seconds=1.0)
    assert sound.correct, sound.checks
    drv = cell.driver()
    FAULTS[fault](monkeypatch, drv)
    run = _run(cell, torch.device("cpu"), seconds=1.0, drv=drv)
    assert _failed(run), run.checks
