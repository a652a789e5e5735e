"""The port's auxiliary particle filter (``filters/auxiliary.py``) and the
generic kernel's plain APF mode against exact Kalman likelihoods and
against the JAX package's auxiliary filter.

A particle filter's log-evidence is biased low by about var/2 (Jensen);
each Kalman check allows that plus 4 standard errors of the mean and a
0.2-nat margin.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu.filters import AuxiliaryParticleFilter as JaxAPF
from ssme_tpu.models import lgssm as jlg
from ssme_tpu_torch.filters import AuxiliaryParticleFilter, BootstrapFilter
from ssme_tpu_torch.models import lgssm
from ssme_tpu_torch.models.base import StateSpaceModel
from ssme_tpu_torch.ops import filter_megakernel as fm
from ssme_tpu_torch.transforms import ParamTransform

torch.set_num_threads(1)

PARAMS = np.array([0.9, 0.3, 0.6], np.float32)  # smooth state, noisy obs


@pytest.fixture(scope="module")
def data():
    _, ys = jlg.simulate(jax.random.key(0), jnp.asarray(PARAMS), 80)
    ys = np.asarray(ys, np.float32)
    lls, _, _ = lgssm.kalman_filter(torch.from_numpy(PARAMS),
                                    torch.from_numpy(ys))
    return ys, float(lls.sum())


def _near_exact(vals, exact):
    v = np.asarray(vals, np.float64)
    se = v.std(ddof=1) / math.sqrt(v.size)
    assert abs(exact - v.mean()) < v.var(ddof=1) / 2 + 4 * se + 0.2, (
        v.mean(), v.std(), exact)


def test_apf_loglike_matches_kalman(data):
    ys, exact = data
    apf = AuxiliaryParticleFilter(lgssm.make_model(), num_particles=4096)
    got = float(apf.run(torch.Generator().manual_seed(1),
                        torch.from_numpy(PARAMS),
                        torch.from_numpy(ys)).log_likelihood)
    assert abs(got - exact) < 1.5, (got, exact)


def test_apf_matches_jax_in_distribution(data):
    """16 filters each (a batch here, vmap over keys there), N=256: mean
    log-likelihoods within 4 combined standard errors."""
    ys, _ = data
    p = torch.from_numpy(PARAMS)[None].expand(16, 3)
    got = AuxiliaryParticleFilter(lgssm.make_model(), 256).run(
        torch.Generator().manual_seed(2), p,
        torch.from_numpy(ys)).log_likelihood.double().numpy()
    japf = JaxAPF(jlg.make_model(), 256)
    want = np.asarray(jax.vmap(lambda k: japf.run(
        k, jnp.asarray(PARAMS), ys).log_likelihood)(
        jax.random.split(jax.random.key(3), 16)), np.float64)
    se = math.sqrt(got.var(ddof=1) / 16 + want.var(ddof=1) / 16)
    assert abs(got.mean() - want.mean()) < 4 * se + 0.05, (got.mean(),
                                                           want.mean())


def test_apf_functionals_and_resample_every(data):
    ys, _ = data
    apf = AuxiliaryParticleFilter(
        lgssm.make_model(), num_particles=128,
        functionals=(lambda x, p: torch.full(x.shape[:-1] + (1,), 42.0),))
    res = apf.run(torch.Generator().manual_seed(4), torch.from_numpy(PARAMS),
                  torch.from_numpy(ys))
    torch.testing.assert_close(res.expectations[0],
                               torch.full((80, 1), 42.0))
    assert res.ess.shape == (80,) and res.last_particles.shape == (128, 1)
    # every other step: finite, and ESS falls between the resamples
    res2 = AuxiliaryParticleFilter(lgssm.make_model(), 128,
                                   resample_every=2).run(
        torch.Generator().manual_seed(5), torch.from_numpy(PARAMS),
        torch.from_numpy(ys))
    assert math.isfinite(float(res2.log_likelihood))
    assert float(res2.ess.min()) < 128.0


def test_apf_requires_a_lookahead():
    m = lgssm.make_model()
    no_look = StateSpaceModel(**{**m.__dict__, "prop_mu": None})
    with pytest.raises(ValueError, match="prop_mu"):
        AuxiliaryParticleFilter(no_look, 64)


# ---------------------------------------------------------------------------
# two leaves: x = (x1, x2) independent AR(1) with state noise q, y = x1 +
# x2 + noise r (the JAX package's examples/validate_tpu.py check 7, whose
# point (a, q, r) = (0.7, 1, 0.5) holds the bootstrap mode).  There the
# lookahead density, of variance r^2, is far narrower than the predictive
# one, 2 q^2 + r^2: the second-stage weights are heavy-tailed and the APF
# sits 10-15 nats under the exact evidence at N=512-1024, converging
# slowly.  The APF checks use the same model at (0.9, 0.3, 0.6), the
# smooth-state, noisy-observation point of the JAX package's APF test.
# ---------------------------------------------------------------------------

CHECK7, APF_POINT, T_LG = (0.7, 1.0, 0.5), (0.9, 0.3, 0.6), 100
HALF_LOG_2PI = 0.9189385332046727


def _lg2_data(a, q, r):
    rng = np.random.default_rng(0)
    x = rng.normal(size=2) * q / math.sqrt(1 - a * a)
    ys = np.empty(T_LG)
    for t in range(T_LG):
        if t:
            x = a * x + q * rng.normal(size=2)
        ys[t] = x.sum() + r * rng.normal()
    # exact 2-D Kalman, float64
    cov, mean, h = np.eye(2) * q * q / (1 - a * a), np.zeros(2), np.ones(2)
    exact = 0.0
    for t, yv in enumerate(ys):
        if t:
            mean, cov = a * mean, a * a * cov + q * q * np.eye(2)
        s = h @ cov @ h + r * r
        v = yv - h @ mean
        exact += -0.5 * math.log(2 * math.pi * s) - 0.5 * v * v / s
        gain = cov @ h / s
        mean, cov = mean + gain * v, cov - np.outer(gain, h @ cov)
    return ys.astype(np.float32), exact


def _lg2_kernel_model(a, q, r):
    sd0 = q / math.sqrt(1.0 - a * a)

    def init(rng, p, y, z, shape):
        return (rng.normal(shape) * sd0, rng.normal(shape) * sd0)

    def propagate(rng, p, state, y, z):
        x1, x2 = state
        return (a * x1 + q * rng.normal(x1.shape),
                a * x2 + q * rng.normal(x2.shape))

    def log_weight(p, state, y, z):
        e = (y[0] - (state[0] + state[1])) / r
        return -HALF_LOG_2PI - math.log(r) - 0.5 * e * e

    def prop_mu(p, state, y, z):
        return (a * state[0], a * state[1])

    return fm.KernelModel(num_params=1, init=init, propagate=propagate,
                          log_weight=log_weight, num_state=2, prop_mu=prop_mu,
                          name="lg2")


def _lg2_model(a, q, r):
    sd0 = q / math.sqrt(1.0 - a * a)

    def sample_q1(gen, params, y1, n):
        return torch.randn(params.shape[:-1] + (n, 2), generator=gen) * sd0

    def log_mu(params, x):
        return (-2 * HALF_LOG_2PI - 2 * math.log(sd0)
                - 0.5 * ((x / sd0) ** 2).sum(-1))

    def sample_f(gen, params, x, z):
        return a * x + q * torch.randn(x.shape, generator=gen)

    def log_g(params, y, x, z):
        e = (y[..., 0:1] - x.sum(-1)) / r
        return -HALF_LOG_2PI - math.log(r) - 0.5 * e * e

    return StateSpaceModel(
        dim_state=2, dim_obs=1, transform=ParamTransform(("null",)),
        log_g=log_g, sample_f=sample_f, sample_q1=sample_q1,
        log_q1=lambda params, x, y: log_mu(params, x), log_mu=log_mu,
        prop_mu=lambda params, x, z: a * x, name="lg2")


@pytest.mark.parametrize("mode,point", [("bootstrap", CHECK7),
                                        ("apf", APF_POINT)])
def test_two_leaf_plain_kernel_modes_match_kalman(mode, point):
    """The generic kernel's plain version on a two-leaf model with Python
    hooks (CPU tensors run any KernelModel), B=32 N=512."""
    ys, exact = _lg2_data(*point)
    tot, lcl, _ = fm.filter_megakernel(_lg2_kernel_model(*point), 23,
                                       torch.zeros(32, 1),
                                       torch.from_numpy(ys),
                                       num_particles=512, mode=mode)
    torch.testing.assert_close(lcl.sum(-1), tot, rtol=1e-5, atol=1e-4)
    _near_exact(tot.numpy(), exact)


def test_two_leaf_auxiliary_filter_matches_kalman():
    ys, exact = _lg2_data(*APF_POINT)
    vals = AuxiliaryParticleFilter(_lg2_model(*APF_POINT), 512).run(
        torch.Generator().manual_seed(6), torch.zeros(16, 1),
        torch.from_numpy(ys)).log_likelihood
    _near_exact(vals.numpy(), exact)
    ys, exact = _lg2_data(*CHECK7)
    boot = BootstrapFilter(_lg2_model(*CHECK7), 512).run(
        torch.Generator().manual_seed(7), torch.zeros(16, 1),
        torch.from_numpy(ys)).log_likelihood
    _near_exact(boot.numpy(), exact)
