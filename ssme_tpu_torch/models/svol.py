"""Univariate stochastic-volatility model (batched PyTorch hooks).

PyTorch counterpart of ``ssme_tpu/models/svol.py``:

    x_t = phi * x_{t-1} + sigma * eps_t,          eps ~ N(0,1)
    y_t ~ N(0, (beta * exp(x_t / 2))^2)
    x_1 ~ N(0, sigma^2 / (1 - phi^2))             (stationary init)

theta = (beta, phi, ss) with sigma = sqrt(ss); transforms {null,
twice_fisher, log}; priors beta ~ N(1, 1), phi ~ U(0, 1),
ss ~ InvGamma(.001, .001).

Every hook already takes the whole cloud (see ``models/base.py``), so the
JAX module's ``*_batch`` fast-path samplers are the samplers below.
"""

from __future__ import annotations

import math

import torch

from ssme_tpu_torch import rv
from ssme_tpu_torch.models.base import StateSpaceModel, bcol
from ssme_tpu_torch.transforms import ParamTransform

TRANSFORMS = ("null", "twice_fisher", "log")

# chain start of the reference driver: transformed theta0 =
# (1.0, twiceFisher(.5), log(2e-4))
START_TRANS_THETA = (1.0, 1.0986122886681098, -8.517193191416238)


def _unpack(params):
    return params[..., 0], params[..., 1], torch.sqrt(params[..., 2])


def _stationary_sd(params):
    _, phi, sigma = _unpack(params)
    return sigma / torch.sqrt(1.0 - phi * phi)


def log_mu(params, x1):
    return rv.norm_logpdf(x1[..., 0], 0.0, _stationary_sd(params)[..., None])


def sample_q1(gen, params, y1, n):
    sd = bcol(_stationary_sd(params))
    eps = torch.randn(params.shape[:-1] + (n, 1), generator=gen,
                      dtype=params.dtype, device=params.device)
    return eps * sd


def log_q1(params, x1, y1):
    return rv.norm_logpdf(x1[..., 0], 0.0, _stationary_sd(params)[..., None])


def sample_f(gen, params, x_prev, z):
    _, phi, sigma = _unpack(params)
    eps = torch.randn(x_prev.shape, generator=gen, dtype=x_prev.dtype,
                      device=x_prev.device)
    return bcol(phi) * x_prev + eps * bcol(sigma)


def log_f(params, x, x_prev, z):
    _, phi, sigma = _unpack(params)
    return rv.norm_logpdf(x[..., 0], phi[..., None] * x_prev[..., 0],
                          sigma[..., None])


def log_g(params, y, x, z):
    beta, _, _ = _unpack(params)
    return rv.norm_logpdf(y[..., 0:1], 0.0,
                          beta[..., None] * torch.exp(0.5 * x[..., 0]))


def sample_g(gen, params, x):
    beta, _, _ = _unpack(params)
    eps = torch.randn(x.shape[:-1] + (1,), generator=gen, dtype=x.dtype,
                      device=x.device)
    return eps * bcol(beta) * torch.exp(0.5 * x)


def prop_mu(params, x_prev, z):
    _, phi, _ = _unpack(params)
    return bcol(phi) * x_prev


def log_prior(params):
    beta, phi, ss = params[..., 0], params[..., 1], params[..., 2]
    return (rv.norm_logpdf(beta, 1.0, 1.0)
            + rv.uniform_logpdf(phi, 0.0, 1.0)
            + rv.invgamma_logpdf(ss, 1e-3, 1e-3))


# Gamma(1e-3)'s draws below the smallest normal float32 flush to 0 in
# JAX's float32 sampler, so their ss = 1e-3 / 0 is +inf
_LOG_FLOAT32_TINY = math.log(torch.finfo(torch.float32).tiny)


def sample_prior(gen, shape=()):
    """Draws from :func:`log_prior`'s distribution, (*shape, 3), as
    ``ssme_tpu/models/svol.py::sample_prior`` makes them: beta = 1 + N(0,
    1), phi ~ U(0, 1), ss = 1e-3 / G with G ~ Gamma(1e-3).  G is drawn in
    log space (G = Gamma(1 + a) U^(1 / a)) and, as JAX's float32 draw,
    flushed to 0 below the smallest normal float32, which gives ss = +inf
    on about 92% of the draws (the reference never samples this prior)."""
    shape = tuple(shape)
    kw = dict(generator=gen, device=gen.device)
    beta = 1.0 + torch.randn(shape, **kw)
    phi = torch.rand(shape, **kw)
    a = 1e-3
    boost = torch._standard_gamma(torch.full(shape, 1.0 + a,
                                             dtype=torch.float64,
                                             device=gen.device),
                                  generator=gen)
    log_g = torch.log(boost) + torch.log(
        torch.rand(shape, dtype=torch.float64, **kw)) / a
    ss = torch.where(log_g < _LOG_FLOAT32_TINY, math.inf,
                     torch.exp(math.log(1e-3) - log_g))
    return torch.stack([beta, phi, ss.to(beta.dtype)], dim=-1)


def kernel_rows(params):
    """Constrained (beta, phi, ss) rows -> the filter kernels' (beta, phi,
    sigma) rows."""
    return torch.stack([params[..., 0], params[..., 1],
                        torch.sqrt(params[..., 2])], dim=-1)


def make_model() -> StateSpaceModel:
    return StateSpaceModel(
        dim_state=1,
        dim_obs=1,
        dim_cov=0,
        transform=ParamTransform(TRANSFORMS),
        log_mu=log_mu,
        sample_q1=sample_q1,
        log_q1=log_q1,
        sample_f=sample_f,
        log_f=log_f,
        log_g=log_g,
        sample_g=sample_g,
        prop_mu=prop_mu,
        log_prior=log_prior,
        sample_prior=sample_prior,
        name="univ_svol",
    )


__all__ = ["make_model", "TRANSFORMS", "START_TRANS_THETA", "log_prior",
           "sample_prior", "kernel_rows"]
