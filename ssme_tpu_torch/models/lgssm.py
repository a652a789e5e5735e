"""Linear-Gaussian state-space model, for exact validation against Kalman.

PyTorch counterpart of ``ssme_tpu/models/lgssm.py``:

    x_t = a x_{t-1} + q eps_t
    y_t = c x_t     + r eta_t
    x_1 ~ N(0, q^2 / (1 - a^2))

Parameters (constrained): (a, q, r) with transforms {twice_fisher, log,
log}.  :func:`kalman_filter` and :func:`kalman_smoother` are the exact
answers the particle filters are held to.
"""

from __future__ import annotations

import torch

from ssme_tpu_torch import rv
from ssme_tpu_torch.models.base import StateSpaceModel, bcol
from ssme_tpu_torch.transforms import ParamTransform

TRANSFORMS = ("twice_fisher", "log", "log")
C_OBS = 1.0  # fixed observation loading


def _stationary_sd(params):
    a, q = params[..., 0], params[..., 1]
    return q / torch.sqrt(1.0 - a * a)


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
    a, q = bcol(params[..., 0]), bcol(params[..., 1])
    return a * x_prev + _randn(gen, x_prev.shape, x_prev) * q


def log_f(params, x, x_prev, z):
    a, q = params[..., 0:1], params[..., 1:2]
    return rv.norm_logpdf(x[..., 0], a * x_prev[..., 0], q)


def sample_q(gen, params, x_prev, y, z):
    return sample_f(gen, params, x_prev, z)


def log_q(params, x, x_prev, y, z):
    return log_f(params, x, x_prev, z)


def prop_mu(params, x_prev, z):
    return bcol(params[..., 0]) * x_prev


def log_g(params, y, x, z):
    return rv.norm_logpdf(y[..., 0:1], C_OBS * x[..., 0], params[..., 2:3])


def sample_g(gen, params, x):
    return (C_OBS * x + _randn(gen, x.shape[:-1] + (1,), x)
            * bcol(params[..., 2]))


def log_prior(params):
    a, q, r = params[..., 0], params[..., 1], params[..., 2]
    return (rv.uniform_logpdf(a, -1.0, 1.0) + rv.halfnorm_logpdf(q, 1.0)
            + rv.halfnorm_logpdf(r, 1.0))


def sample_prior(gen, shape=()):
    kw = dict(generator=gen, device=gen.device)
    shape = tuple(shape)
    a = torch.rand(shape, **kw) * 2.0 - 1.0
    q = torch.abs(torch.randn(shape, **kw))
    r = torch.abs(torch.randn(shape, **kw))
    return torch.stack([a, q, r], dim=-1)


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
        name="lgssm",
    )


def simulate(gen, params, num_steps):
    """(xs, ys), each (num_steps, 1), from the model; x_1 is the
    stationary draw and y_1 measures it."""
    params = torch.as_tensor(params, dtype=torch.float32)
    a, q, r = params[0], params[1], params[2]
    x = _randn(gen, (), params) * _stationary_sd(params)
    xs, ys = [], []
    for t in range(int(num_steps)):
        if t:
            x = a * x + _randn(gen, (), params) * q
        xs.append(x)
        ys.append(C_OBS * x + _randn(gen, (), params) * r)
    return torch.stack(xs)[:, None], torch.stack(ys)[:, None]


def kalman_filter(params, ys):
    """Exact filter: (log_cond_likes (T,), filter_means (T,),
    filter_vars (T,)), float32 like the JAX package's."""
    params = torch.as_tensor(params, dtype=torch.float32)
    a, q, r = params[0], params[1], params[2]
    c = C_OBS
    ys = torch.as_tensor(ys, dtype=torch.float32)[..., 0]
    mean_pred = torch.zeros((), dtype=torch.float32, device=ys.device)
    var_pred = q * q / (1.0 - a * a)
    lls, means, variances = [], [], []
    for y in ys:
        s = c * c * var_pred + r * r
        lls.append(rv.norm_logpdf(y, c * mean_pred, torch.sqrt(s)))
        gain = var_pred * c / s
        mean_filt = mean_pred + gain * (y - c * mean_pred)
        var_filt = (1.0 - gain * c) * var_pred
        means.append(mean_filt)
        variances.append(var_filt)
        mean_pred, var_pred = a * mean_filt, a * a * var_filt + q * q
    return torch.stack(lls), torch.stack(means), torch.stack(variances)


def kalman_smoother(params, ys):
    """Exact RTS smoother: (smoothed_means (T,), smoothed_vars (T,))."""
    params = torch.as_tensor(params, dtype=torch.float32)
    a, q = params[0], params[1]
    _, means, variances = kalman_filter(params, ys)
    m_s, v_s = means[-1], variances[-1]
    out_m, out_v = [m_s], [v_s]
    for m_f, v_f in zip(reversed(means[:-1]), reversed(variances[:-1])):
        m_pred = a * m_f
        v_pred = a * a * v_f + q * q
        gain = v_f * a / v_pred
        m_s = m_f + gain * (m_s - m_pred)
        v_s = v_f + gain * gain * (v_s - v_pred)
        out_m.append(m_s)
        out_v.append(v_s)
    return torch.stack(out_m[::-1]), torch.stack(out_v[::-1])


__all__ = ["make_model", "simulate", "kalman_filter", "kalman_smoother",
           "TRANSFORMS", "C_OBS"]
