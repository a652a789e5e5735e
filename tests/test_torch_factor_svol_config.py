"""The factor-SVOL configuration of the benchmark (5 assets, 2 factors)
against the port, on the CPU: the plain reference's Woodbury density,
prior and transforms against the port's model and K2 instance, the
recorded-chain replay of a short PMMH run over K2's factor hook at
d = 21, the two filters' likelihoods in distribution, and the port's
estimator entry point at a tiny size."""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.lib.cell import Cell, load_cell  # noqa: E402
from benchmark.reference import factor_svol as ref  # noqa: E402
from ssme_tpu_torch.examples import estimate_factor_svol  # noqa: E402
from ssme_tpu_torch.models import factor_svol  # noqa: E402
from ssme_tpu_torch.ops import filter_megakernel as fm  # noqa: E402

torch.set_num_threads(1)
CELL = "factor_svol_5.pmmh_k2_parity"
DATA = os.path.join(ROOT, "benchmark", "data", "factor_svol_5_returns.csv")


def _params(seed, rows, n=5, k=2, dtype=torch.float64):
    """Constrained rows near a plausible posterior: (rows, 3k + nk + n)."""
    g = torch.Generator().manual_seed(seed)
    kw = dict(generator=g, dtype=dtype)
    phi = 0.5 + 0.45 * torch.rand(rows, k, **kw)
    mu = -1.0 + 0.5 * torch.randn(rows, k, **kw)
    sigma = 0.1 + 0.2 * torch.rand(rows, k, **kw)
    loadings = 0.6 * torch.randn(rows, n * k, **kw)
    d = 0.2 + 0.3 * torch.rand(rows, n, **kw)
    return torch.cat([phi, mu, sigma, loadings, d], -1)


def _direct_log_density(params, x, y, n, k):
    """log N(y; 0, L diag(e^x) L' + diag(d)) by a dense (n, n) Cholesky."""
    _, _, _, loadings, d = ref.unpack(params, n, k)
    cov = (torch.einsum("bia,bna,bja->bnij", loadings, torch.exp(x),
                        loadings) + torch.diag_embed(d)[:, None])
    mvn = torch.distributions.MultivariateNormal(torch.zeros(n, dtype=x.dtype),
                                                 covariance_matrix=cov)
    return mvn.log_prob(y)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_reference_woodbury_is_the_dense_gaussian(k):
    """The reference's general-k Woodbury form against the dense density
    in float64: the two differ by rounding only (1e-9 on ~10 nats)."""
    n, b, m = 5, 8, 16
    p = _params(k, b, n, k)
    x = -1.0 + torch.randn(b, m, k, dtype=torch.float64,
                           generator=torch.Generator().manual_seed(1))
    y = torch.randn(n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    _, _, _, loadings, d = ref.unpack(p, n, k)
    got = ref.Woodbury(loadings, d).log_density(x.permute(2, 0, 1), y)
    torch.testing.assert_close(got, _direct_log_density(p, x, y, n, k),
                               rtol=1e-9, atol=1e-9)


def test_reference_density_matches_the_port_model_and_k2_instance():
    """At seeded parameters and states, in float64: K2's factor_svol_5
    plain hook (its explicit 2 x 2 formulas) to rounding (1e-9), and
    models/factor_svol.log_g to 1e-6 nats (its Cholesky adds 1e-8 to M's
    diagonal)."""
    n, k, b, m = 5, 2, 16, 32
    p = _params(7, b)
    x = -1.0 + torch.randn(b, m, k, dtype=torch.float64,
                           generator=torch.Generator().manual_seed(3))
    y = torch.randn(n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    _, _, _, loadings, d = ref.unpack(p, n, k)
    want = ref.Woodbury(loadings, d).log_density(x.permute(2, 0, 1), y)
    k2 = fm.factor_svol_kernel_model(n).log_weight(p, tuple(x.unbind(-1)),
                                                   tuple(y.unbind()), ())
    torch.testing.assert_close(k2, want, rtol=1e-9, atol=1e-9)
    model = factor_svol.make_model(n, k)
    torch.testing.assert_close(model.log_g(p, y, x, None), want, rtol=0,
                               atol=1e-6)


def test_reference_model_prior_transforms_and_jacobian_match_the_port():
    """reference.factor_svol.Model built from the configuration against
    make_model(5, 2): transforms in float64 to 1e-12, the prior plus
    Jacobian (the port's in float32) to 1e-4 nats on ~40, and -inf on a
    negative sigma or d on both sides."""
    cell = load_cell(CELL)
    rm = ref.Model(cell.config["pmmh"])
    pm = factor_svol.make_model(5, 2)
    assert rm.dim == pm.dim_param == 21
    p = _params(11, 64)
    z = pm.transform.unconstrain(p)
    torch.testing.assert_close(rm.unconstrain(p), z, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(rm.constrain(z), p, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(rm.log_jacobian(z),
                               pm.transform.log_det_jacobian(z),
                               rtol=1e-12, atol=1e-12)
    want = (pm.log_prior(p.float()).double()
            + pm.transform.log_det_jacobian(z))
    torch.testing.assert_close(rm.log_target_prior(z), want, rtol=0,
                               atol=1e-4)
    for col in (4, 5, 16, 20):       # sigma1, sigma2, d1, d5
        bad = p.clone()
        bad[:2, col] = -0.1
        assert torch.isneginf(rm.log_prior(bad)[:2]).all()
        assert torch.isneginf(pm.log_prior(bad.float())[:2]).all()


def test_likelihood_estimates_agree_in_distribution():
    """K2's factor_svol_5 plain filter and the float64 reference at
    T=64, N=256, every-step resampling, 128 rows at each of two
    parameter points: the mean estimates within 4 combined standard
    errors (independent draws, so only their spread may differ)."""
    ys = torch.as_tensor(np.loadtxt(DATA, delimiter=",")[:64],
                         dtype=torch.float32)
    for seed in (21, 22):
        p = _params(seed, 1).expand(128, -1)
        prog = fm.filter_megakernel(fm.factor_svol_kernel_model(5), seed,
                                    p.float().contiguous(), ys,
                                    num_particles=256,
                                    ess_threshold=1.0)[0].double()
        want = ref.bootstrap_log_likes(seed, p, ys.double(), 256, 2,
                                       torch.float64)
        se = math.sqrt(float(prog.var()) / 128 + float(want.var()) / 128)
        assert abs(float(prog.mean() - want.mean())) <= 4 * se, \
            (float(prog.mean()), float(want.mean()), se)


def test_follow_replays_a_pmmh_run_over_the_factor_hook(tmp_path):
    """The benchmark's driver on the CPU at T=64, N=64, C=4, R=2: the
    window crosses t0, so the Haario recursion at d = 21 is replayed too;
    0 mismatched decisions, proposals and positions within float32
    rounding of the float64 replay (1e-4 transformed)."""
    ys = np.loadtxt(DATA, delimiter=",")[:64]
    np.savetxt(tmp_path / "ys.csv", ys, delimiter=",")
    c = load_cell(CELL)
    cfg = dict(c.config, num_particles=64, data=str(tmp_path / "ys.csv"))
    tr = dict(c.traffic, chains=4, replicates=2, start_iteration=145,
              check_iterations=4, warmup_iterations=1)
    cell = Cell(c.name, c.chips, cfg, tr, c.end_to_end, c.per_layer)
    limits = {"ll_mean_gap": math.inf, "ll_rms_gap": math.inf,
              "proposal_gap": 1e-4, "state_gap": 1e-4, "mismatches": 0}
    run = cell.driver().run(cell, 3_000_000_019, 1.0, False, 0.0,
                            torch.device("cpu"), limits)
    checks = {n: v for n, v, _ in run.checks}
    assert run.iterations >= 6, run.iterations
    assert checks["mismatches"] == 0, checks
    assert checks["proposal_gap"] <= 1e-4 and checks["state_gap"] <= 1e-4
    assert math.isfinite(checks["ll_mean_gap"]), checks
    assert run.failed == 0 and run.notes["kernel_instance"] == "factor_svol_5"


def test_estimator_runs_on_the_cpu(tmp_path, capsys):
    """examples/estimate_factor_svol.py at a tiny size: one JSON object
    summarising 21 parameters, and the kept draws, 21 columns a row."""
    np.savetxt(tmp_path / "ys.csv", np.loadtxt(DATA, delimiter=",")[:30],
               delimiter=",")
    out = tmp_path / "s.csv"
    estimate_factor_svol.main([
        "--device", "cpu", "--datafile", str(tmp_path / "ys.csv"),
        "--iters", "6", "--burn", "2", "--chains", "2", "--particles", "32",
        "--replicates", "2", "--samples-out", str(out)])
    res = json.loads(capsys.readouterr().out)
    assert len(res["posterior"]) == 21 and res["T"] == 30
    assert res["device"] == "cpu" and res["launches"] == 0
    draws = np.loadtxt(out, delimiter=",")
    assert draws.shape == (4 * 2, 21)
    assert np.isfinite(draws).all()


def test_estimator_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        estimate_factor_svol.main(["--iters", "1"])
