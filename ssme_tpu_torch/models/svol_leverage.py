"""Hull-White stochastic volatility with leverage (covariate model).

PyTorch counterpart of ``ssme_tpu/models/svol_leverage.py``:

    x_t = mu + phi (x_{t-1} - mu) + z_t rho sigma e^{-x_{t-1}/2}
          + sigma sqrt(1 - rho^2) eps_t
    y_t ~ N(0, e^{x_t})
    x_1 ~ N(0, sigma^2 / (1 - phi^2))

where the covariate z_t is the previous observation y_{t-1} (leverage).
Parameters (constrained), order (phi, mu, sigma, rho); transforms
{logit, null, log, twice_fisher}; a uniform prior over a box.

The transition mean is clamped to [-STATE_CLAMP, STATE_CLAMP]: the
leverage term z rho sigma e^{-x/2} is explosive for very negative x, and
one deep-tail draw can otherwise start a runaway x -> -inf whose next
mean is inf - inf = NaN in float32 (non-finite evidence at the SPY
posterior mean).  The clamp is the identity on every physical path; the
kernel instance (``ops/filter_megakernel.py::svol_leverage_kernel_model``
and ``csrc/kernel_models.cuh``) applies it at the same place.

Hooks take the whole batch (``models/base.py``); a covariate ``z`` is
either one step's (dim_cov,) row shared by every particle or a
(..., N, dim_cov) array of per-particle values (future simulation with
fed-back observations).
"""

from __future__ import annotations

import torch

from ssme_tpu_torch import rv
from ssme_tpu_torch.models.base import StateSpaceModel, bcol
from ssme_tpu_torch.transforms import ParamTransform

TRANSFORMS = ("logit", "null", "log", "twice_fisher")

DEFAULT_PRIOR_BOUNDS = (
    (0.8, 0.99),    # phi
    (-0.1, 0.1),    # mu
    (0.01, 0.1),    # sigma
    (-0.5, -0.01),  # rho
)

STATE_CLAMP = 40.0


def _stationary_sd(params):
    phi, sigma = params[..., 0], params[..., 2]
    return sigma / torch.sqrt(1.0 - phi * phi)


def _trans_mean(params, x_prev, z):
    """Clamped transition mean (..., N, 1) of clouds (..., N, 1)."""
    phi, mu = bcol(params[..., 0]), bcol(params[..., 1])
    sigma, rho = bcol(params[..., 2]), bcol(params[..., 3])
    mean = mu + phi * (x_prev - mu)
    if z is not None:
        mean = mean + z[..., 0:1] * rho * sigma * torch.exp(-0.5 * x_prev)
    return torch.clamp(mean, -STATE_CLAMP, STATE_CLAMP)


def _trans_sd(params):
    sigma, rho = params[..., 2], params[..., 3]
    return sigma * torch.sqrt(1.0 - rho * rho)


def _randn(gen, shape, like):
    return torch.randn(shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def log_mu(params, x1):
    return rv.norm_logpdf(x1[..., 0], 0.0, _stationary_sd(params)[..., None])


def sample_q1(gen, params, y1, n):
    return (_randn(gen, params.shape[:-1] + (n, 1), params)
            * bcol(_stationary_sd(params)))


def log_q1(params, x1, y1):
    return log_mu(params, x1)


def sample_f(gen, params, x_prev, z):
    return (_trans_mean(params, x_prev, z)
            + _randn(gen, x_prev.shape, x_prev) * bcol(_trans_sd(params)))


def log_f(params, x, x_prev, z):
    return rv.norm_logpdf(x[..., 0], _trans_mean(params, x_prev, z)[..., 0],
                          _trans_sd(params)[..., None])


def sample_q(gen, params, x_prev, y, z):
    # the proposal is the transition
    return sample_f(gen, params, x_prev, z)


def log_q(params, x, x_prev, y, z):
    return log_f(params, x, x_prev, z)


def prop_mu(params, x_prev, z):
    # APF lookahead: the conditional mean
    return _trans_mean(params, x_prev, z)


def log_g(params, y, x, z):
    return rv.norm_logpdf(y[..., 0:1], 0.0, torch.exp(0.5 * x[..., 0]))


def sample_g(gen, params, x):
    return _randn(gen, x.shape[:-1] + (1,), x) * torch.exp(0.5 * x)


def lagged_covariates(ys):
    """The covariates (T, 1) of a series ys (T,) or (T, 1): z_t = y_{t-1},
    z_0 = 0, on the device of ys."""
    ys = ys.reshape(-1, 1)
    return torch.cat([torch.zeros_like(ys[:1]), ys[:-1]]).contiguous()


def make_uniform_prior(bounds=DEFAULT_PRIOR_BOUNDS):
    """(sample_prior(gen, shape=()) -> (*shape, P), log_prior(params
    (..., P)) -> (...)) of the uniform prior over the box ``bounds``: one
    (lo, hi) pair of Python floats per parameter, evaluated as host
    constants."""
    bounds = tuple((float(lo), float(hi)) for lo, hi in bounds)

    def sample_prior(gen, shape=()):
        u = torch.rand(tuple(shape) + (len(bounds),), generator=gen,
                       device=gen.device)
        return torch.stack([lo + (hi - lo) * u[..., k]
                            for k, (lo, hi) in enumerate(bounds)], dim=-1)

    def log_prior(params):
        return rv.box_uniform_logpdf(params, bounds).sum(-1)

    return sample_prior, log_prior


def make_model(prior_bounds=DEFAULT_PRIOR_BOUNDS) -> StateSpaceModel:
    sample_prior, log_prior = make_uniform_prior(prior_bounds)
    return StateSpaceModel(
        dim_state=1,
        dim_obs=1,
        dim_cov=1,
        transform=ParamTransform(TRANSFORMS),
        log_mu=log_mu,
        sample_q1=sample_q1,
        log_q1=log_q1,
        sample_f=sample_f,
        log_f=log_f,
        sample_q=sample_q,
        log_q=log_q,
        log_g=log_g,
        sample_g=sample_g,
        prop_mu=prop_mu,
        log_prior=log_prior,
        sample_prior=sample_prior,
        name="svol_leverage",
    )


__all__ = ["make_model", "make_uniform_prior", "lagged_covariates",
           "TRANSFORMS", "DEFAULT_PRIOR_BOUNDS", "STATE_CLAMP", "log_mu", "sample_q1",
           "log_q1", "sample_f", "log_f", "sample_q", "log_q", "prop_mu",
           "log_g", "sample_g"]
