"""Stochastic volatility with Student-t observation tails.

PyTorch counterpart of ``ssme_tpu/models/svol_t.py``:

    x_t = phi x_{t-1} + sigma eps_t
    y_t ~ beta e^{x_t / 2} * t_nu          (Student-t, nu dof)
    x_1 ~ N(0, sigma^2 / (1 - phi^2))

Parameters (constrained) (beta, phi, ss, nu), sigma = sqrt(ss);
transforms {null, twice_fisher, log, log}.  Priors (sampled and scored):
beta ~ N(1, 1), phi ~ U(0, 1), ss ~ InvGamma(2, 0.2), nu ~ Exp(mean 10).

The prior stays on the device: the nu > 0 support is a ``torch.where``,
never a host branch.  The Student-t and Gamma draws are built from the
generator's normals and uniforms (``rv.student_t_sample``; the prior's
Gamma(2) is the sum of two exponentials), since ``torch.distributions``
samplers take no generator.
"""

from __future__ import annotations

import math

import torch

from ssme_tpu_torch import rv
from ssme_tpu_torch.models.base import StateSpaceModel, bcol
from ssme_tpu_torch.transforms import ParamTransform

TRANSFORMS = ("null", "twice_fisher", "log", "log")


def _stationary_sd(params):
    phi, sigma = params[..., 1], torch.sqrt(params[..., 2])
    return sigma / torch.sqrt(1.0 - phi * phi)


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
    phi, sigma = bcol(params[..., 1]), bcol(torch.sqrt(params[..., 2]))
    return phi * x_prev + _randn(gen, x_prev.shape, x_prev) * sigma


def log_f(params, x, x_prev, z):
    phi, sigma = params[..., 1:2], torch.sqrt(params[..., 2:3])
    return rv.norm_logpdf(x[..., 0], phi * x_prev[..., 0], sigma)


def sample_q(gen, params, x_prev, y, z):
    return sample_f(gen, params, x_prev, z)


def log_q(params, x, x_prev, y, z):
    return log_f(params, x, x_prev, z)


def prop_mu(params, x_prev, z):
    return bcol(params[..., 1]) * x_prev


def log_g(params, y, x, z):
    beta, nu = params[..., 0:1], params[..., 3:4]
    return rv.t_logpdf(y[..., 0:1], nu, 0.0, beta * torch.exp(0.5 * x[..., 0]))


def sample_g(gen, params, x):
    beta, nu = bcol(params[..., 0]), bcol(params[..., 3])
    shape = x.shape[:-1] + (1,)
    return (rv.student_t_sample(gen, nu.expand(shape), shape) * beta
            * torch.exp(0.5 * x))


def log_prior(params):
    beta, phi, ss, nu = (params[..., 0], params[..., 1], params[..., 2],
                         params[..., 3])
    return (rv.norm_logpdf(beta, 1.0, 1.0)
            + rv.uniform_logpdf(phi, 0.0, 1.0)
            + rv.invgamma_logpdf(ss, 2.0, 0.2)
            + torch.where(nu > 0, -nu / 10.0 - math.log(10.0),
                          torch.full_like(nu, -math.inf)))


def sample_prior(gen, shape=()):
    """Exact draws from :func:`log_prior`'s distribution, (*shape, 4)."""
    shape = tuple(shape)
    kw = dict(generator=gen, device=gen.device)
    beta = 1.0 + torch.randn(shape, **kw)
    phi = torch.rand(shape, **kw)
    u = torch.rand((3,) + shape, **kw)
    gamma2 = -torch.log1p(-u[0]) - torch.log1p(-u[1])   # Gamma(2, 1)
    ss = 0.2 / gamma2                                   # InvGamma(2, 0.2)
    nu = -torch.log1p(-u[2]) * 10.0                     # Exp(mean 10)
    return torch.stack([beta, phi, ss, nu], dim=-1)


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
        name="svol_t",
    )


def simulate(gen, params, num_steps):
    """(xs, ys), each (num_steps, 1): a stationary draw, then num_steps
    transitions each followed by an observation (as the JAX package)."""
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
