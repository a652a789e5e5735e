"""The plain reference against known answers, on the CPU.

With phi = 0 the SVOL state is independent from step to step, so the
likelihood factorises into one-dimensional integrals that Gauss-Hermite
quadrature gives to 1e-10; the particle filters must meet them within
their Monte-Carlo error.  The Haario recursion must give the sample
moments, and the Jacobians the derivatives of the transforms."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import filters, liu_west
from benchmark.reference.pmmh import Model, SD_SCALE, EPS, cholesky, follow

torch.set_num_threads(2)
YS = torch.tensor(np.random.default_rng(5).standard_normal(40) * 1.3,
                  dtype=torch.float32)


def _quadrature_log_like(ys, beta, mus, sigma, deg=80):
    """sum_t log int N(y_t; 0, beta^2 e^x) N(x; mu_t, sigma^2) dx."""
    nodes, weights = np.polynomial.hermite_e.hermegauss(deg)
    total = 0.0
    for y, mu in zip(ys.double().numpy(), mus):
        x = mu + sigma * nodes
        var = beta * beta * np.exp(x)
        dens = np.exp(-0.5 * y * y / var) / np.sqrt(2 * np.pi * var)
        total += math.log((weights * dens).sum() / math.sqrt(2 * math.pi))
    return total


def _mc_check(est, exact):
    """The mean of the rows' likelihoods (in exp-space, relative to the
    largest) within 4 standard errors of the exact value."""
    w = torch.exp(est - est.max())
    mean = w.mean()
    se = w.std() / math.sqrt(len(w))
    exact_w = math.exp(exact - float(est.max()))
    assert abs(float(mean) - exact_w) < 4 * float(se) + 1e-12, \
        (float(mean), exact_w, float(se))


@pytest.mark.parametrize("ess, stride", [(1.0, 1), (0.5, 8)])
def test_svol_filter_meets_quadrature(ess, stride):
    beta, sigma = 0.9, 0.6
    b = 64
    params = torch.tensor([[beta, 0.0, sigma * sigma]] * b,
                          dtype=torch.float64)
    est = filters.bootstrap_log_likes("svol", 11, params, YS, 2048, ess,
                                      stride, torch.float64)
    exact = _quadrature_log_like(YS, beta, [0.0] * len(YS), sigma)
    _mc_check(est, exact)


def test_leverage_filter_meets_quadrature():
    mu, sigma = 0.3, 0.5
    b = 64
    # phi = 0, rho = 0: x_t ~ N(mu, sigma^2) for t >= 1, x_0 ~ N(0, sigma^2)
    params = torch.tensor([[0.0, mu, sigma, 0.0]] * b, dtype=torch.float64)
    est = filters.bootstrap_log_likes("svol_leverage", 3, params, YS, 2048,
                                      0.5, 8, torch.float64)
    exact = _quadrature_log_like(YS, 1.0, [0.0] + [mu] * (len(YS) - 1),
                                 sigma)
    _mc_check(est, exact)


def test_liu_west_with_a_point_prior_meets_quadrature():
    """A prior box too narrow to matter pins theta: the Liu-West filter
    is then an auxiliary particle filter of a model with phi ~ 0."""
    mu, sigma = 0.2, 0.5
    bounds = ((1e-6, 1.000001e-6), (mu, mu + 1e-9), (sigma, sigma + 1e-9),
              (-1e-6, -0.999999e-6))
    ll, cloud = liu_west.liu_west_apf(5, YS, 64, 2048, 0.99, bounds,
                                      torch.float64, "cpu")
    exact = _quadrature_log_like(YS, 1.0, [0.0] + [mu] * (len(YS) - 1),
                                 sigma)
    _mc_check(ll, exact)
    assert cloud.shape == (64, 2048, 4)
    assert torch.allclose(cloud[..., 1].mean(), torch.tensor(mu,
                          dtype=torch.float64), atol=1e-3)


def test_systematic_ancestors_count_offspring():
    w = torch.tensor([[0.1, 0.0, 0.6, 0.3]], dtype=torch.float64)
    anc = filters.systematic_ancestors(w, torch.tensor([0.5],
                                                       dtype=torch.float64))
    # points 0.125, 0.375, 0.625, 0.875 on the CDF 0.1, 0.1, 0.7, 1.0
    assert anc.tolist() == [[2, 2, 2, 3]]


def test_haario_recursion_gives_the_sample_moments():
    spec = {"params": ["a", "b"], "transforms": ["null", "null"],
            "prior": [["normal", 0.0, 1.0], ["normal", 0.0, 1.0]]}
    model = Model(spec)
    rng = np.random.default_rng(1)
    n_iter, c, d = 12, 3, 2
    thetas = torch.as_tensor(rng.standard_normal((n_iter, c, d)))
    eps = torch.as_tensor(rng.standard_normal((n_iter, c, d)))
    start = dict(theta=torch.zeros(c, d, dtype=torch.float64),
                 log_like=torch.zeros(c, dtype=torch.float64),
                 mean=torch.zeros(c, d, dtype=torch.float64),
                 sigma_hat=torch.zeros(c, d, d, dtype=torch.float64),
                 ct=torch.eye(d, dtype=torch.float64).expand(c, d, d),
                 iteration=0)
    rec = dict(eps=eps, log_u=torch.zeros(n_iter, c, dtype=torch.float64),
               theta=thetas, log_like=torch.zeros(n_iter, c),
               new_log_like=torch.zeros(n_iter, c))
    out = follow(model, start, rec, 0, 10 ** 9, torch.float64)
    seen = torch.cat([start["theta"][None], thetas])
    for i in range(3, n_iter):
        cov = torch.stack([torch.cov(seen[:i, k].T) for k in range(c)])
        ct = SD_SCALE / d * (cov + EPS * torch.eye(d, dtype=torch.float64))
        want = seen[i - 1] + (torch.linalg.cholesky(ct)
                              @ eps[i - 1][..., None])[..., 0]
        assert torch.allclose(out["proposal"][i - 1], want, atol=1e-12)


def test_cholesky_matches_linalg():
    a = torch.as_tensor(np.random.default_rng(2).standard_normal((5, 4, 4)))
    c = a @ a.transpose(-1, -2) + 0.1 * torch.eye(4, dtype=torch.float64)
    assert torch.allclose(cholesky(c), torch.linalg.cholesky(c), atol=1e-12)


@pytest.mark.parametrize("name", ["null", "log", "logit", "twice_fisher"])
def test_log_jacobians_are_the_transforms_derivatives(name):
    spec = {"params": ["a"], "transforms": [name],
            "prior": [["uniform", -10.0, 10.0]]}
    m = Model(spec)
    z = torch.linspace(-3, 3, 13, dtype=torch.float64)[:, None]
    h = 1e-6
    slope = (m.constrain(z + h) - m.constrain(z - h))[:, 0] / (2 * h)
    assert torch.allclose(m.log_jacobian(z), torch.log(slope.abs()),
                          atol=1e-6)
    assert torch.allclose(m.unconstrain(m.constrain(z)), z, atol=1e-9)


def test_priors_against_closed_forms():
    m = Model({"params": ["beta", "phi", "ss"],
               "transforms": ["null", "twice_fisher", "log"],
               "prior": [["normal", 1.0, 1.0], ["uniform", 0.0, 1.0],
                         ["inv_gamma", 0.001, 0.001]]})
    p = torch.tensor([[0.8, 0.97, 0.004]], dtype=torch.float64)
    from scipy import stats
    want = (stats.norm(1, 1).logpdf(0.8) + 0.0
            + stats.invgamma(0.001, scale=0.001).logpdf(0.004))
    assert abs(float(m.log_prior(p)[0]) - want) < 1e-9
    assert float(m.log_prior(torch.tensor([[0.8, 1.2, 0.004]],
                                          dtype=torch.float64))[0]) \
        == -math.inf


def test_draws_follow_the_seed():
    """The same seed gives the same estimates, another seed others: the
    reference's draws are its own, from the seed it is handed."""
    params = torch.tensor([[0.9, 0.95, 0.04]] * 4, dtype=torch.float64)
    run = [filters.bootstrap_log_likes("svol", s, params, YS, 128, 1.0, 1,
                                       torch.float64) for s in (7, 7, 8)]
    assert torch.equal(run[0], run[1])
    assert not torch.equal(run[0], run[2])
    assert filters.stream_seed(2 ** 33 + 1, 2) != filters.stream_seed(
        2 ** 33 + 1, 3)
