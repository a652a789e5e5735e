"""A run with the timed path broken underneath must come out not
correct, once for each fault a cell can have; the program as it is, and
the control (the reference in bfloat16 in its place), are read beside.

The cells' numbers are statistics over the window's chains or filters,
so their faults are read at each cell's own size, on the card
(``cuda``): the drivers are called directly, past the harness's look for
a chip.  On the CPU, at a size a test run holds, the faults that no
statistic hides run too.  Run on the card with
``python -m pytest benchmark/tests -m cuda``."""

import json
import math
import os
import time

import numpy as np
import pytest
import torch

from benchmark.lib.cell import BENCH_DIR, Cell, load_cell

with open(os.path.join(os.path.dirname(BENCH_DIR), "BENCHMARK.json")) as _f:
    _CELLS = [(w["name"], load_cell(w["name"]).traffic["driver"])
              for w in json.load(_f)["workloads"]]
PMMH_CELLS = [n for n, d in _CELLS if d == "pmmh"]
LW_CELLS = [n for n, d in _CELLS if d == "liu_west"]
SEED = 2_900_000_017


def _limits(name):
    with open(os.path.join(BENCH_DIR, "limits", name + ".json")) as f:
        return {k: v["limit"] for k, v in json.load(f).items()}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the faults are read at the "
                    "cell's own size")
    return torch.device("cuda", 0)


# -- the faults -------------------------------------------------------------

def _state_unchanged(monkeypatch, drv):
    """AdaptivePMMH.step hands back the state it was given (and reports
    it as the chain's position), whatever it decided."""
    from ssme_tpu_torch.inference.pmmh import AdaptivePMMH

    orig = AdaptivePMMH.step

    def step(self, state, ys, eps=None, log_u=None, zs=None):
        new, out = orig(self, state, ys, eps, log_u, zs)
        return (state._replace(iteration=new.iteration),
                (state.trans_theta, state.log_like) + tuple(out[2:]))

    monkeypatch.setattr(AdaptivePMMH, "step", step)


def _wrap_program(monkeypatch, drv, wrap):
    orig = drv._program

    def program(config, traffic, device):
        model, hook, cov = orig(config, traffic, device)
        return model, wrap(hook, config, traffic, device, orig), cov

    monkeypatch.setattr(drv, "_program", program)


def _half_the_replicates(monkeypatch, drv):
    """The likelihood of each chain from half of its replicates: the rest
    left out of the launch, the mean taken over those that ran."""
    def wrap(hook, config, traffic, device, orig):
        half = dict(traffic, replicates=traffic["replicates"] // 2)
        return orig(config, half, device)[1]
    _wrap_program(monkeypatch, drv, wrap)


def _answer_altered(monkeypatch, drv):
    """The hook sums the replicates' likelihoods where it should average
    them: every answer off by log R where it is produced."""
    def wrap(hook, config, traffic, device, orig):
        shift = math.log(traffic["replicates"])
        return lambda gen, params, ys, *zs: hook(gen, params, ys, *zs) \
            + shift
    _wrap_program(monkeypatch, drv, wrap)


def _lw_patch(monkeypatch, change):
    import ssme_tpu_torch.ops.svol_leverage_lw_kernel as mod

    orig = mod.svol_leverage_lw

    def lw(*args, **kwargs):
        out = dict(orig(*args, **kwargs))
        change(out)
        return out

    lw.launches = orig.launches  # the original counts its launches here
    monkeypatch.setattr(mod, "svol_leverage_lw", lw)


def _lw_half_left_out(out):
    """The second half of the filters never written."""
    f = out["log_likelihood"].shape[0]
    out["log_likelihood"] = out["log_likelihood"].clone()
    out["log_likelihood"][f // 2:] = 0.0
    out["cloud"] = out["cloud"].clone()
    out["cloud"][f // 2:] = 0.0


def _lw_state_unchanged(out):
    """The parameter cloud never moves from its prior draw."""
    cloud = out["cloud"].clone()
    u = torch.rand(cloud[:, 2:6].shape, device=cloud.device)
    lo = torch.tensor([0.8, -0.1, 0.01, -0.5], device=cloud.device)
    hi = torch.tensor([0.99, 0.1, 0.1, -0.01], device=cloud.device)
    p = lo[None, :, None] + (hi - lo)[None, :, None] * u
    cloud[:, 2] = torch.log(p[:, 0]) - torch.log1p(-p[:, 0])
    cloud[:, 3] = p[:, 1]
    cloud[:, 4] = torch.log(p[:, 2])
    cloud[:, 5] = torch.log1p(p[:, 3]) - torch.log1p(-p[:, 3])
    out["cloud"] = cloud


def _lw_answer_altered(out):
    """Two parameter rows of the cloud written in each other's place."""
    cloud = out["cloud"].clone()
    cloud[:, [3, 4]] = cloud[:, [4, 3]]
    out["cloud"] = cloud


def _lw_one_filter_altered(out):
    """One filter's evidence counted twice where it is produced; the
    other filters untouched."""
    ll = out["log_likelihood"].clone()
    ll[0] = 2.0 * ll[0]
    out["log_likelihood"] = ll


PMMH_FAULTS = {"state_unchanged": _state_unchanged,
               "half_the_replicates": _half_the_replicates,
               "answer_altered": _answer_altered}
LW_FAULTS = {"half_left_out": _lw_half_left_out,
             "state_unchanged": _lw_state_unchanged,
             "answer_altered": _lw_answer_altered,
             "one_filter_altered": _lw_one_filter_altered}


def apply_fault(monkeypatch, cell, drv, fault):
    """Plant ``fault`` under the cell's driver module ``drv``."""
    if cell.traffic["driver"] == "liu_west":
        _lw_patch(monkeypatch, LW_FAULTS[fault])
    else:
        PMMH_FAULTS[fault](monkeypatch, drv)


def _run(cell, device, seed=SEED, seconds=4.0, drv=None, control=False):
    drv = drv or cell.driver()
    return drv.run(cell, seed, seconds, False, time.time(), device,
                   _limits(cell.name), control=control)


def _failed(run):
    return [(n, v, lim) for n, v, lim in run.checks
            if not (v == v and v <= lim)]


# -- on the card, at each cell's own size -----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", PMMH_CELLS + LW_CELLS)
def test_program_passes_and_control_fails(name):
    dev = _card()
    run = _run(load_cell(name), dev, control=True)
    assert run.correct, run.checks
    limits = _limits(name)
    ctrl = dict(run.notes["control"])
    assert any(not (ctrl[k] <= limits[k]) for k in limits), ctrl


@pytest.mark.cuda
@pytest.mark.parametrize("name", PMMH_CELLS)
@pytest.mark.parametrize("fault", sorted(PMMH_FAULTS))
def test_pmmh_fault_is_not_correct(name, fault, monkeypatch):
    dev = _card()
    cell = load_cell(name)
    drv = cell.driver()
    PMMH_FAULTS[fault](monkeypatch, drv)
    run = _run(cell, dev, drv=drv)
    assert not run.correct, run.checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", LW_CELLS)
@pytest.mark.parametrize("fault", sorted(LW_FAULTS))
def test_liu_west_fault_is_not_correct(name, fault, monkeypatch):
    dev = _card()
    _lw_patch(monkeypatch, LW_FAULTS[fault])
    run = _run(load_cell(name), dev)
    assert not run.correct, run.checks


# -- on the CPU, at a size a test run holds ---------------------------------

class _Small(Cell):
    """A cell cut to the CPU: the first T steps, N = 256, 128 chains and
    eight sampled iterations (the reference draws its own particles, so
    the likelihood numbers are statistics over the sampled chains: these
    hold their standard error near the cell's), or four filters over
    more steps (a filter's evidence there outweighs the Liu-West limits,
    set at T = 3084)."""

    T = {"pmmh": 60, "liu_west": 240}

    def series(self, device):
        return super().series(device)[:self.T[self.traffic["driver"]]]


def _small(name):
    c = load_cell(name)
    tr = dict(c.traffic)
    for key, value in (("chains", 128), ("filters", 4),
                       ("check_iterations", 8)):
        if key in tr:
            tr[key] = value
    return _Small(c.name, c.chips, dict(c.config, num_particles=256), tr,
                  c.end_to_end, c.per_layer)


@pytest.mark.parametrize("name", PMMH_CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_pmmh_fault_on_cpu(name, fault, monkeypatch):
    torch.set_num_threads(2)
    cell = _small(name)
    sound = _run(cell, torch.device("cpu"), seconds=2.0)
    assert sound.correct, sound.checks
    drv = cell.driver()
    PMMH_FAULTS[fault](monkeypatch, drv)
    run = _run(cell, torch.device("cpu"), seconds=2.0, drv=drv)
    assert _failed(run), run.checks


@pytest.mark.parametrize("name", LW_CELLS)
@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
def test_liu_west_fault_on_cpu(name, fault, monkeypatch):
    torch.set_num_threads(2)
    cell = _small(name)
    _lw_patch(monkeypatch, LW_FAULTS[fault])
    run = _run(cell, torch.device("cpu"), seconds=0.2)
    assert _failed(run), run.checks


@pytest.mark.parametrize("name", LW_CELLS)
def test_liu_west_sound_on_cpu(name):
    torch.set_num_threads(2)
    run = _run(_small(name), torch.device("cpu"),
               seconds=0.2)
    assert np.isfinite([v for _, v, _ in run.checks]).all()
