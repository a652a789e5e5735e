"""Factor SV as Pitt & Shephard publish it (stochastic idiosyncratic
variances; the benchmark's ``factor_svol_sv_10`` configuration: 10 assets,
2 factors, a 12-leaf state, 56 parameters) against the port, on the CPU:
the plain reference's Woodbury density against its dense one and against
the port's model and K2 hook, the reference's prior and transforms
against the port's, the two filters' likelihoods in distribution, the
benchmark's driver end to end at T = 200, the estimator's ``--idio-sv``
entry point at a tiny size, and the instance's place in K2's tables."""

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
from benchmark.reference import factor_svol_sv as ref  # noqa: E402
from ssme_tpu_torch.examples import estimate_factor_svol  # noqa: E402
from ssme_tpu_torch.models import factor_svol  # noqa: E402
from ssme_tpu_torch.ops import filter_megakernel as fm  # noqa: E402

torch.set_num_threads(1)
CELL = "factor_svol_sv_10.pmmh_sv_parity"
DATA = os.path.join(ROOT, "benchmark", "data",
                    "factor_svol_sv_10_returns.csv")
N_ASSETS, K = 10, 2


def _params(seed, rows, dtype=torch.float64):
    """Constrained rows (rows, 56) near the panel's generating point:
    persistent leaves, idiosyncratic levels about -1.2, loadings of 0.6."""
    g = torch.Generator().manual_seed(seed)
    kw = dict(generator=g, dtype=dtype)
    m = N_ASSETS + K
    phi = 0.85 + 0.13 * torch.rand(rows, m, **kw)
    mu = -1.2 + 0.4 * torch.randn(rows, m, **kw)
    sigma = 0.08 + 0.15 * torch.rand(rows, m, **kw)
    loadings = 0.6 * torch.randn(rows, N_ASSETS * K, **kw)
    return torch.cat([phi, mu, sigma, loadings], -1)


def _states(seed, rows, particles, dtype=torch.float64):
    """States (12, rows, particles) about the idiosyncratic levels."""
    g = torch.Generator().manual_seed(seed)
    return -1.0 + 0.8 * torch.randn(N_ASSETS + K, rows, particles,
                                    generator=g, dtype=dtype)


def _y(seed, dtype=torch.float64):
    return torch.randn(N_ASSETS, dtype=dtype,
                       generator=torch.Generator().manual_seed(seed))


def test_reference_woodbury_is_its_dense_density():
    """The reference's per-particle Woodbury density against the 10 x 10
    Cholesky of Sigma itself, in float64: rounding only (1e-9 on ~20
    nats)."""
    p, h, y = _params(1, 8), _states(2, 8, 32), _y(3)
    loadings = ref.unpack(p, N_ASSETS, K)[3]
    torch.testing.assert_close(ref.log_density(loadings, h, y),
                               ref.dense_log_density(loadings, h, y),
                               rtol=1e-9, atol=1e-9)


def test_port_density_is_the_dense_density_and_constant_d_is_not():
    """At seeded parameters and states: K2's plain hook for the instance
    (the kernel's float operations and order) to rounding in float64
    (1e-9), and in float32 within 2e-3 nats (float32's 6e-8 unit roundoff
    over the ~100 operations of a particle's density, on terms of up to
    ~50 nats); ``make_sv_model``'s log_g within 1e-6 (its Cholesky adds
    1e-8 to M's diagonal).  The constant-d density at the idiosyncratic
    leaves' stationary means, d = e^{mu_u} (the model this one replaces),
    misses the dense density by far more than those tolerances."""
    p, h, y = _params(7, 16), _states(8, 16, 32), _y(9)
    want = ref.dense_log_density(ref.unpack(p, N_ASSETS, K)[3], h, y)
    km = fm.factor_svol_sv_kernel_model(N_ASSETS)
    got = km.log_weight(p, tuple(h.unbind(0)), tuple(y.unbind()), ())
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)
    got32 = km.log_weight(p.float(), tuple(h.float().unbind(0)),
                          tuple(y.float().unbind()), ())
    torch.testing.assert_close(got32.double(), want, rtol=0, atol=2e-3)
    model = factor_svol.make_sv_model(N_ASSETS, K)
    torch.testing.assert_close(model.log_g(p, y, h.permute(1, 2, 0), None),
                               want, rtol=0, atol=1e-6)
    _, mu, _, loadings = ref.unpack(p, N_ASSETS, K)
    ell = [(loadings[:, i, 0:1], loadings[:, i, 1:2])
           for i in range(N_ASSETS)]
    d = [torch.exp(mu[:, K + i:K + i + 1]) for i in range(N_ASSETS)]
    const_d = factor_svol.two_factor_log_g(ell, d, h[0], h[1], y.unbind())
    gap = (const_d - want).abs()
    assert float(gap.median()) > 100 * 2e-3, float(gap.median())
    with pytest.raises(AssertionError):
        torch.testing.assert_close(const_d, want, rtol=0, atol=2e-3)


def test_kernel_hooks_are_the_model_transition():
    """The instance's plain init and propagate at zero normals: the
    stationary means and the AR(1) transition means of
    ``make_sv_model`` (its prop_mu), leaf for leaf, clamped to +-40."""

    class Zero:
        def normal(self, shape):
            return torch.zeros(shape, dtype=torch.float64)

    p = _params(4, 6)
    km = fm.factor_svol_sv_kernel_model(N_ASSETS)
    model = factor_svol.make_sv_model(N_ASSETS, K)
    x0 = torch.stack(km.init(Zero(), p, (), (), (6, 5)), -1)
    torch.testing.assert_close(x0, p[:, None, 12:24].expand(6, 5, 12))
    h = _states(5, 6, 5).permute(1, 2, 0)
    h[0, 0, 3] = -1e3
    x1 = torch.stack(km.propagate(Zero(), p, tuple(h.unbind(-1)), (), ()),
                     -1)
    want = model.prop_mu(p, h, None).clamp(-40.0, 40.0)
    torch.testing.assert_close(x1, want)
    assert float(x1[0, 0, 3]) == -40.0


def test_reference_model_prior_transforms_and_jacobian_match_the_port():
    """reference.factor_svol_sv.Model built from the configuration against
    make_sv_model(10, 2): transforms in float64 to 1e-12, the prior plus
    Jacobian (the port's in float32) to 1e-3 nats on ~100, and -inf on a
    negative sigma or a phi past 1 on both sides."""
    cell = load_cell(CELL)
    rm = ref.Model(cell.config["pmmh"])
    pm = factor_svol.make_sv_model(N_ASSETS, K)
    assert rm.dim == pm.dim_param == 56
    assert tuple(cell.config["pmmh"]["transforms"]) == \
        factor_svol.sv_transforms(N_ASSETS, K)
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
                               atol=1e-3)
    for col, v in ((24, -0.1), (35, -0.1), (0, 1.5), (11, -1.5)):
        bad = p.clone()
        bad[:2, col] = v
        assert torch.isneginf(rm.log_prior(bad)[:2]).all()
        assert torch.isneginf(pm.log_prior(bad.float())[:2]).all()


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_likelihood_estimates_agree_in_distribution(seed):
    """K2's factor_svol_sv_10 plain filter (float32, the kernel's Philox
    bits) and the float64 reference (its own draws) at T=60, N=128,
    every-step resampling, 64 rows at one parameter point a seed: the
    mean estimates within 4 combined standard errors (independent draws,
    so only their spread may differ)."""
    ys = torch.as_tensor(np.loadtxt(DATA, delimiter=",")[:60],
                         dtype=torch.float32)
    p = _params(seed, 1).expand(64, -1)
    prog = fm.filter_megakernel(fm.factor_svol_sv_kernel_model(N_ASSETS),
                                seed, p.float().contiguous(), ys,
                                num_particles=128,
                                ess_threshold=1.0)[0].double()
    want = ref.bootstrap_log_likes(seed, p, ys.double(), 128, K,
                                   torch.float64)
    se = math.sqrt(float(prog.var()) / 64 + float(want.var()) / 64)
    assert abs(float(prog.mean() - want.mean())) <= 4 * se, \
        (float(prog.mean()), float(want.mean()), se)


def _small_cell(tmp_path, t_len=200):
    """The cell cut to the CPU: the panel's first t_len steps, N = 64,
    C = 4 chains x R = 2, a window that crosses t0 (so the Haario
    recursion at d = 56 is replayed too), four sampled iterations."""
    np.savetxt(tmp_path / "ys.csv", np.loadtxt(DATA, delimiter=",")[:t_len],
               delimiter=",")
    c = load_cell(CELL)
    cfg = dict(c.config, num_particles=64, data=str(tmp_path / "ys.csv"))
    tr = dict(c.traffic, chains=4, replicates=2, start_iteration=148,
              check_iterations=4, warmup_iterations=1)
    return Cell(c.name, c.chips, cfg, tr, c.end_to_end, c.per_layer)


def test_driver_runs_on_the_cpu_and_replays_the_chain(tmp_path):
    """The cell's driver end to end at T = 200: 0 mismatched decisions,
    proposals and positions within float32 rounding of the float64 replay
    (1e-4 transformed), finite likelihood gaps, the run's notes naming
    the instance and its frozen count."""
    cell = _small_cell(tmp_path)
    limits = {"ll_mean_gap": math.inf, "ll_rms_gap": math.inf,
              "proposal_gap": 1e-4, "state_gap": 1e-4, "mismatches": 0}
    run = cell.driver().run(cell, 3_000_000_019, 1.0, False, 0.0,
                            torch.device("cpu"), limits)
    checks = {n: v for n, v, _ in run.checks}
    assert run.iterations >= 2, run.iterations
    assert checks["mismatches"] == 0, checks
    assert checks["proposal_gap"] <= 1e-4 and checks["state_gap"] <= 1e-4
    assert math.isfinite(checks["ll_mean_gap"]), checks
    assert run.failed == 0 and run.notes["kernel_instance"] == \
        "factor_svol_sv_10"
    assert run.layer["ops_per_prop"] == 850
    assert run.launch_shape == dict(B=8, N=64, T=200)


def test_estimator_runs_the_published_model_on_the_cpu(tmp_path, capsys):
    """examples/estimate_factor_svol.py --idio-sv at a tiny size: one
    JSON object summarising 56 parameters over K2's factor_svol_sv_10
    instance, and the kept draws, 56 columns a row."""
    np.savetxt(tmp_path / "ys.csv", np.loadtxt(DATA, delimiter=",")[:30],
               delimiter=",")
    out = tmp_path / "s.csv"
    estimate_factor_svol.main([
        "--idio-sv", "--device", "cpu",
        "--datafile", str(tmp_path / "ys.csv"), "--iters", "4", "--burn",
        "2", "--chains", "2", "--particles", "32", "--replicates", "2",
        "--samples-out", str(out)])
    res = json.loads(capsys.readouterr().out)
    assert len(res["posterior"]) == 56 and res["T"] == 30
    assert res["model"] == "factor_svol_sv_10" and res["launches"] == 0
    assert "sigma_u10" in res["posterior"] and "l102" in res["posterior"]
    draws = np.loadtxt(out, delimiter=",")
    assert draws.shape == (2 * 2, 56) and np.isfinite(draws).all()


def test_start_point_is_the_data_scripts_generating_row():
    """The estimator's START_SV is the row the committed panel was
    simulated from (benchmark/data/make_factor_svol_sv_10.py), and the
    configuration's ``assumed.generating`` holds the same numbers."""
    import importlib.util
    path = os.path.join(ROOT, "benchmark", "data", "make_factor_svol_sv_10.py")
    spec = importlib.util.spec_from_file_location("make_sv", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    np.testing.assert_array_equal(mod.generating_row(),
                                  np.asarray(estimate_factor_svol.START_SV))
    gen = load_cell(CELL).config["assumed"]["generating"]
    assert {k: gen[k] for k in mod.GENERATING} == mod.GENERATING


def test_factor_asset_counts_read_the_constant_d_family_only():
    """FACTOR_ASSET_COUNTS stays (3, 4, 5) beside factor_svol_sv_10: a
    constant-d kernel model of 10 assets names no CUDA instance, and the
    new instance names its own."""
    assert fm.FACTOR_ASSET_COUNTS == (3, 4, 5)
    assert "factor_svol_sv_10" in fm.CUDA_MODEL_IDS
    ten = fm.factor_svol_kernel_model(10)
    with pytest.raises(ValueError, match="3, 4, 5 assets"):
        fm._model_id(ten)
    sv = fm.factor_svol_sv_kernel_model(10)
    assert fm.factor_svol_sv_kernel_model(10) is sv
    assert (sv.num_state, sv.dim_obs, sv.num_params) == (12, 10, 56)
    assert fm._model_id(sv) == fm.CUDA_MODEL_IDS["factor_svol_sv_10"]


def test_only_the_shared_state_instance_is_systematic_only():
    """The kernel model carries the refusal of the roll resamplers: of
    every kernel model the module builds, the 12-leaf instance alone is
    systematic_only, and its twin is the systematic family's only; on CPU
    tensors the plain version runs it under a roll resampler all the
    same (finite totals, one per row)."""
    models = [fm.svol_kernel_model(), fm.svol_leverage_kernel_model(),
              fm.svol_t_kernel_model(), fm.poisson_ar_kernel_model()] + [
        fm.factor_svol_kernel_model(n) for n in fm.FACTOR_ASSET_COUNTS]
    assert not any(km.systematic_only for km in models)
    sv = fm.factor_svol_sv_kernel_model(10)
    assert sv.systematic_only
    assert ("factor_svol_sv_10", "bootstrap") in fm.SPAN_TWINS["systematic"]
    assert all(name != "factor_svol_sv_10" for name, _ in fm.SPAN_TWINS["roll"])
    ys = torch.as_tensor(np.loadtxt(DATA, delimiter=",")[:12],
                         dtype=torch.float32).contiguous()
    rows = _params(3, 2, torch.float32).contiguous()
    tot = fm.filter_megakernel(sv, 1, rows, ys, num_particles=64,
                               resampler="rejection")[0]
    assert tot.shape == (2,) and bool(torch.isfinite(tot).all())
