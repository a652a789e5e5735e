"""Poisson count state-space model with AR(1) log-intensity.

PyTorch counterpart of ``ssme_tpu/models/poisson_ar.py``:

    x_t = mu + phi (x_{t-1} - mu) + sigma eps_t     (log-intensity)
    y_t ~ Poisson(e^{x_t})
    x_1 ~ N(mu, sigma^2 / (1 - phi^2))

Parameters (constrained) (phi, mu, sigma); transforms {twice_fisher,
null, log}.  Priors (sampled and scored): phi ~ U(-0.99, 0.99),
mu ~ N(0, 2), sigma ~ HalfNormal(0.5).  Counts are drawn with
``torch.poisson(rates, generator=gen)``.
"""

from __future__ import annotations

import torch

from ssme_tpu_torch import rv
from ssme_tpu_torch.models.base import StateSpaceModel, bcol
from ssme_tpu_torch.transforms import ParamTransform

TRANSFORMS = ("twice_fisher", "null", "log")


def _stationary_sd(params):
    phi, sigma = params[..., 0], params[..., 2]
    return sigma / torch.sqrt(1.0 - phi * phi)


def _trans_mean(params, x_prev):
    phi, mu = bcol(params[..., 0]), bcol(params[..., 1])
    return mu + phi * (x_prev - mu)


def _randn(gen, shape, like):
    return torch.randn(shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def log_mu(params, x1):
    return rv.norm_logpdf(x1[..., 0], params[..., 1:2],
                          _stationary_sd(params)[..., None])


def sample_q1(gen, params, y1, n):
    return (bcol(params[..., 1])
            + _randn(gen, params.shape[:-1] + (n, 1), params)
            * bcol(_stationary_sd(params)))


def log_q1(params, x1, y1):
    return log_mu(params, x1)


def sample_f(gen, params, x_prev, z):
    return (_trans_mean(params, x_prev)
            + _randn(gen, x_prev.shape, x_prev) * bcol(params[..., 2]))


def log_f(params, x, x_prev, z):
    return rv.norm_logpdf(x[..., 0], _trans_mean(params, x_prev)[..., 0],
                          params[..., 2:3])


def sample_q(gen, params, x_prev, y, z):
    return sample_f(gen, params, x_prev, z)      # the proposal is f


def log_q(params, x, x_prev, y, z):
    return log_f(params, x, x_prev, z)


def prop_mu(params, x_prev, z):
    return _trans_mean(params, x_prev)           # APF lookahead


def log_g(params, y, x, z):
    return rv.poisson_logpmf(y[..., 0:1], x[..., 0])


def sample_g(gen, params, x):
    return torch.poisson(torch.exp(x), generator=gen)


def log_prior(params):
    phi, mu, sigma = params[..., 0], params[..., 1], params[..., 2]
    return (rv.uniform_logpdf(phi, -0.99, 0.99)
            + rv.norm_logpdf(mu, 0.0, 2.0)
            + rv.halfnorm_logpdf(sigma, 0.5))


def sample_prior(gen, shape=()):
    """Exact draws from :func:`log_prior`'s distribution, (*shape, 3)."""
    shape = tuple(shape)
    kw = dict(generator=gen, device=gen.device)
    phi = -0.99 + 1.98 * torch.rand(shape, **kw)
    mu = torch.randn(shape, **kw) * 2.0
    sigma = torch.abs(torch.randn(shape, **kw)) * 0.5
    return torch.stack([phi, mu, sigma], dim=-1)


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
        sample_q=sample_q,
        log_q=log_q,
        prop_mu=prop_mu,
        log_g=log_g,
        sample_g=sample_g,
        log_prior=log_prior,
        sample_prior=sample_prior,
        name="poisson_ar",
    )


def simulate(gen, params, num_steps):
    """(xs, ys), each (num_steps, 1): a stationary draw, then num_steps
    transitions each followed by a count (as the JAX package)."""
    model = make_model()
    params = torch.as_tensor(params, dtype=torch.float32)
    x = model.sample_q1(gen, params, None, 1)[0]
    xs, ys = [], []
    for _ in range(int(num_steps)):
        x = model.sample_f(gen, params, x[None], None)[0]
        xs.append(x)
        ys.append(model.sample_g(gen, params, x[None])[0])
    return torch.stack(xs), torch.stack(ys)


__all__ = ["make_model", "simulate", "TRANSFORMS", "log_prior",
           "sample_prior"]
