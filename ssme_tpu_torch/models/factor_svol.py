"""Multivariate factor stochastic-volatility model.

PyTorch counterpart of ``ssme_tpu/models/factor_svol.py``.  k latent
AR(1) log-volatility factors drive n observed return series:

    x_{t,i} = mu_i + phi_i (x_{t-1,i} - mu_i) + sigma_i eps_{t,i}
    f_t ~ N(0, diag(e^{x_t}))                      (factor returns)
    y_t = L f_t + D^{1/2} eta_t                    (n-dim observation)

so y_t | x_t ~ N(0, L diag(e^{x_t}) L' + diag(d)).  The observation
density uses the Woodbury identity: one k x k Cholesky per particle.
Its contractions run in IEEE float32: the package switches TF32 off
(``ssme_tpu_torch/__init__.py``), and on the TPU the reduced-precision
default put a +3.4-nat bias into this density over 500 steps.

Parameter vector (constrained), length 3k + nk + n:
    [phi (k), mu (k), sigma (k), vec(L) (nk, row-major), d (n)]
with transforms {twice_fisher x k, null x k, log x k, null x nk, log x n}.

:func:`make_sv_model` is the model as Pitt & Shephard publish it: the
idiosyncratic variances follow AR(1) log-variances of their own, so the
state is h_t = (f_t, u_t), k factor and n idiosyncratic leaves, and

    y_t | h_t ~ N(0, L diag(e^{f_t}) L' + diag(e^{u_t})),

D_t = diag(e^{u_t}) now a particle's own in the Woodbury density.
Parameter vector (constrained), length 3(k + n) + nk:
    [phi (k + n), mu (k + n), sigma (k + n), vec(L) (nk, row-major)]
with transforms {twice_fisher x (k + n), null x (k + n), log x (k + n),
null x nk}.
"""

from __future__ import annotations

import torch

from ssme_tpu_torch import rv
from ssme_tpu_torch.models.base import StateSpaceModel
from ssme_tpu_torch.transforms import ParamTransform

_HALF_LOG_2PI = 0.9189385332046727


def transforms(n_assets: int, k_factors: int):
    return (("twice_fisher",) * k_factors + ("null",) * k_factors
            + ("log",) * k_factors + ("null",) * (n_assets * k_factors)
            + ("log",) * n_assets)


def sv_transforms(n_assets: int, k_factors: int):
    """The transforms of :func:`make_sv_model`'s parameters."""
    m = n_assets + k_factors
    return (("twice_fisher",) * m + ("null",) * m + ("log",) * m
            + ("null",) * (n_assets * k_factors))


def _unpack(params, n, k, leaves=None):
    """(phi, mu, sigma) (..., 1, m) columns against (..., N, m) clouds of
    m = ``leaves`` state leaves (k by default), loadings (..., n, k) and d
    (..., n) (empty where the variances are states)."""
    m = k if leaves is None else leaves
    phi = params[..., None, :m]
    mu = params[..., None, m:2 * m]
    sigma = params[..., None, 2 * m:3 * m]
    loadings = params[..., 3 * m:3 * m + n * k].reshape(
        params.shape[:-1] + (n, k))
    d = params[..., 3 * m + n * k:]
    return phi, mu, sigma, loadings, d


def _ar1_hooks(n, k, m):
    """The AR(1) hooks of m independent leaves, h_j' = mu_j + phi_j (h_j -
    mu_j) + sigma_j eps_j from the stationary law, on the rows' first 3m
    parameters."""

    def stationary_sd(params):
        phi, _, sigma, _, _ = _unpack(params, n, k, m)
        return sigma / torch.sqrt(1.0 - phi * phi)

    def log_mu(params, x1):
        _, mu, _, _, _ = _unpack(params, n, k, m)
        return rv.norm_logpdf(x1, mu, stationary_sd(params)).sum(-1)

    def sample_q1(gen, params, y1, n_particles):
        _, mu, _, _, _ = _unpack(params, n, k, m)
        eps = torch.randn(params.shape[:-1] + (n_particles, m), generator=gen,
                          dtype=params.dtype, device=params.device)
        return mu + eps * stationary_sd(params)

    def trans_mean(params, x_prev):
        phi, mu, _, _, _ = _unpack(params, n, k, m)
        return mu + phi * (x_prev - mu)

    def sample_f(gen, params, x_prev, z):
        _, _, sigma, _, _ = _unpack(params, n, k, m)
        eps = torch.randn(x_prev.shape, generator=gen, dtype=x_prev.dtype,
                          device=x_prev.device)
        return trans_mean(params, x_prev) + eps * sigma

    def log_f(params, x, x_prev, z):
        _, _, sigma, _, _ = _unpack(params, n, k, m)
        return rv.norm_logpdf(x, trans_mean(params, x_prev), sigma).sum(-1)

    return dict(log_mu=log_mu, sample_q1=sample_q1,
                log_q1=lambda params, x1, y1: log_mu(params, x1),
                sample_f=sample_f, log_f=log_f,
                prop_mu=lambda params, x_prev, z: trans_mean(params, x_prev))


def make_model(n_assets: int = 5, k_factors: int = 2) -> StateSpaceModel:
    n, k = n_assets, k_factors

    def log_g(params, y, x, z):
        """log N(y; 0, L S L' + D), S = diag(e^x), by the Woodbury identity
        and the matrix determinant lemma: M = S^-1 + L' D^-1 L (k x k),
        logdet = logdet(M) + sum(x) + sum(log d), quad = y' D^-1 y -
        v' M^-1 v with v = L' D^-1 y."""
        _, _, _, loadings, d = _unpack(params, n, k)
        dinv = 1.0 / d                                        # (..., n)
        ldl = torch.einsum("...ia,...ib->...ab", loadings * dinv[..., None],
                           loadings)                           # (..., k, k)
        eye = torch.eye(k, dtype=x.dtype, device=x.device)
        m_mat = ((1.0 / torch.exp(x))[..., None] * eye + ldl[..., None, :, :]
                 + 1e-8 * eye)                                 # (..., N, k, k)
        chol, _ = torch.linalg.cholesky_ex(m_mat)
        logdet = (2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1))
                  .sum(-1) + x.sum(-1) + torch.log(d).sum(-1)[..., None])
        ydi = y * dinv                                        # (..., n)
        v = torch.einsum("...ia,...i->...a", loadings, ydi)     # (..., k)
        w = torch.cholesky_solve(
            v[..., None, :, None].expand(x.shape + (1,)), chol)[..., 0]
        quad = (y * ydi).sum(-1)[..., None] - (v[..., None, :] * w).sum(-1)
        return -n * _HALF_LOG_2PI - 0.5 * logdet - 0.5 * quad

    def sample_g(gen, params, x):
        _, _, _, loadings, d = _unpack(params, n, k)
        kw = dict(generator=gen, dtype=x.dtype, device=x.device)
        f = torch.randn(x.shape, **kw) * torch.exp(0.5 * x)
        eta = torch.randn(x.shape[:-1] + (n,), **kw)
        return (torch.einsum("...ia,...na->...ni", loadings, f)
                + eta * torch.sqrt(d)[..., None, :])

    def log_prior(params):
        phi, mu, sigma, loadings, d = _unpack(params, n, k)
        return (rv.uniform_logpdf(phi[..., 0, :], -1.0, 1.0).sum(-1)
                + rv.norm_logpdf(mu[..., 0, :], 0.0, 1.0).sum(-1)
                + rv.halfnorm_logpdf(sigma[..., 0, :], 0.5).sum(-1)
                + rv.norm_logpdf(loadings, 0.0, 1.0).sum((-2, -1))
                + rv.invgamma_logpdf(d, 2.0, 0.1).sum(-1))

    def sample_prior(gen, shape=()):
        """(*shape, 3k + nk + n) draws; d = 0.1 / Gamma(2), Gamma(2) the
        sum of two exponentials."""
        shape = tuple(shape)
        kw = dict(generator=gen, device=gen.device)
        phi = 0.5 + 0.49 * torch.rand(shape + (k,), **kw)
        mu = torch.randn(shape + (k,), **kw)
        sigma = torch.abs(torch.randn(shape + (k,), **kw)) * 0.3 + 0.05
        loadings = torch.randn(shape + (n * k,), **kw) * 0.5
        u = torch.rand((2,) + shape + (n,), **kw)
        d = 0.1 / (-torch.log1p(-u[0]) - torch.log1p(-u[1]))
        return torch.cat([phi, mu, sigma, loadings, d], dim=-1)

    return StateSpaceModel(
        dim_state=k,
        dim_obs=n,
        dim_cov=0,
        transform=ParamTransform(transforms(n, k)),
        log_g=log_g,
        sample_g=sample_g,
        log_prior=log_prior,
        sample_prior=sample_prior,
        name=f"factor_svol_{n}x{k}",
        **_ar1_hooks(n, k, k),
    )


def make_sv_model(n_assets: int = 10, k_factors: int = 2) -> StateSpaceModel:
    """Factor SV with stochastic idiosyncratic variances (Pitt & Shephard
    1999 as published): k factor and n idiosyncratic AR(1) log-variance
    leaves, state h = (f, u), y ~ N(0, L diag(e^f) L' + diag(e^u)).  Prior:
    every leaf's phi U(-1, 1), mu N(0, 1), sigma half-normal(0.5) (the
    factors' prior of :func:`make_model`, taken for the idiosyncratic
    leaves too), each loading N(0, 1)."""
    n, k = n_assets, k_factors
    m = n + k

    def log_g(params, y, x, z):
        """log N(y; 0, L S L' + D) with S = diag(e^f), D = diag(e^u) a
        particle's own: M = S^-1 + L' D^-1 L (k x k) per particle, logdet
        = logdet(M) + sum(f) + sum(u), quad = y' D^-1 y - v' M^-1 v with v
        = L' D^-1 y."""
        _, _, _, loadings, _ = _unpack(params, n, k, m)
        f, u = x[..., :k], x[..., k:]
        lw = loadings[..., None, :, :]                       # (..., 1, n, k)
        dinv = torch.exp(-u)                                  # (..., N, n)
        ldl = torch.einsum("...ia,...ib->...ab", lw * dinv[..., None], lw)
        eye = torch.eye(k, dtype=x.dtype, device=x.device)
        m_mat = (1.0 / torch.exp(f))[..., None] * eye + ldl + 1e-8 * eye
        chol, _ = torch.linalg.cholesky_ex(m_mat)
        logdet = (2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1))
                  .sum(-1) + f.sum(-1) + u.sum(-1))
        ydi = y * dinv                                        # (..., N, n)
        v = torch.einsum("...ia,...i->...a", lw, ydi)         # (..., N, k)
        w = torch.cholesky_solve(v[..., None], chol)[..., 0]
        quad = (y * ydi).sum(-1) - (v * w).sum(-1)
        return -n * _HALF_LOG_2PI - 0.5 * logdet - 0.5 * quad

    def log_prior(params):
        phi, mu, sigma, loadings, _ = _unpack(params, n, k, m)
        return (rv.uniform_logpdf(phi[..., 0, :], -1.0, 1.0).sum(-1)
                + rv.norm_logpdf(mu[..., 0, :], 0.0, 1.0).sum(-1)
                + rv.halfnorm_logpdf(sigma[..., 0, :], 0.5).sum(-1)
                + rv.norm_logpdf(loadings, 0.0, 1.0).sum((-2, -1)))

    def sample_prior(gen, shape=()):
        """(*shape, 3(k + n) + nk) draws: each leaf's phi in (0.5, 0.99),
        mu N(0, 1), sigma 0.05 + 0.3 |N(0, 1)|, loadings N(0, 0.25)."""
        shape = tuple(shape)
        kw = dict(generator=gen, device=gen.device)
        phi = 0.5 + 0.49 * torch.rand(shape + (m,), **kw)
        mu = torch.randn(shape + (m,), **kw)
        sigma = torch.abs(torch.randn(shape + (m,), **kw)) * 0.3 + 0.05
        loadings = torch.randn(shape + (n * k,), **kw) * 0.5
        return torch.cat([phi, mu, sigma, loadings], dim=-1)

    return StateSpaceModel(
        dim_state=m,
        dim_obs=n,
        dim_cov=0,
        transform=ParamTransform(sv_transforms(n, k)),
        log_g=log_g,
        log_prior=log_prior,
        sample_prior=sample_prior,
        name=f"factor_svol_sv_{n}x{k}",
        **_ar1_hooks(n, k, m),
    )


def _two_factor_solve(n, a11, a12, a22, sum_log_d, v1, v2, yy, x1, x2):
    """The 2 x 2 part of the kernels' Woodbury density (``csrc/
    kernel_models.cuh`` FactorWoodbury::solve): det and inverse of M =
    diag(e^-x) + A written out, from A, v, y' D^-1 y and log det D."""
    m11 = torch.exp(-x1) + a11
    m22 = torch.exp(-x2) + a22
    det = m11 * m22 - a12 * a12
    quad_corr = (m22 * v1 * v1 - 2.0 * a12 * v1 * v2 + m11 * v2 * v2) / det
    logdet = torch.log(det) + x1 + x2 + sum_log_d
    return -n * _HALF_LOG_2PI - 0.5 * logdet - 0.5 * (yy - quad_corr)


def two_factor_log_g(loadings, d, x1, x2, y):
    """log N(y; 0, L diag(e^x) L' + diag(d)) at k = 2 by the explicit 2 x 2
    Woodbury of the kernels (``csrc/kernel_models.cuh`` FactorWoodbury), in
    their float operations and order: M = diag(e^-x) + A with A =
    L' D^-1 L, v = L' D^-1 y and y' D^-1 y, det and inverse written out.
    ``loadings``: n pairs (l_i1, l_i2), ``d``: n entries, ``y``: n
    observation scalars, each entry a tensor (or float) broadcasting
    against the states ``x1``, ``x2``.  K2's factor hook (one parameter
    row a filter) and K3's (one a particle) share it."""
    n = len(d)
    a11 = a12 = a22 = v1 = v2 = yy = sum_log_d = 0.0
    for i in range(n):
        l1, l2 = loadings[i]
        dinv = 1.0 / d[i]
        a11 = a11 + l1 * l1 * dinv
        a12 = a12 + l1 * l2 * dinv
        a22 = a22 + l2 * l2 * dinv
        v1 = v1 + l1 * dinv * y[i]
        v2 = v2 + l2 * dinv * y[i]
        yy = yy + y[i] * y[i] * dinv
        sum_log_d = sum_log_d + torch.log(d[i])
    return _two_factor_solve(n, a11, a12, a22, sum_log_d, v1, v2, yy, x1, x2)


def two_factor_sv_log_g(loadings, products, x1, x2, u, y):
    """log N(y; 0, L diag(e^x) L' + diag(e^u)) at k = 2 with D = diag(e^u)
    a particle's own, in the float operations and order of K2's
    ``FactorSvolSvModel`` (``csrc/kernel_models.cuh``): per asset e^-u_i,
    then A = L' D^-1 L from the row's products (l1 l1, l1 l2, l2 l2), v =
    L' D^-1 y and y' D^-1 y through y_i e^-u_i, then
    :func:`two_factor_log_g`'s 2 x 2 solve with sum u for log det D.
    ``loadings``: n pairs (l_i1, l_i2), ``products``: n triples, ``u``: n
    idiosyncratic leaves, ``y``: n observation scalars, each entry a
    tensor (or float) broadcasting against the states."""
    n = len(u)
    a11 = a12 = a22 = v1 = v2 = yy = sum_u = 0.0
    for i in range(n):
        (l1, l2), (p11, p12, p22) = loadings[i], products[i]
        dinv = torch.exp(-u[i])
        a11 = a11 + p11 * dinv
        a12 = a12 + p12 * dinv
        a22 = a22 + p22 * dinv
        yd = y[i] * dinv
        v1 = v1 + l1 * yd
        v2 = v2 + l2 * yd
        yy = yy + y[i] * yd
        sum_u = sum_u + u[i]
    return _two_factor_solve(n, a11, a12, a22, sum_u, v1, v2, yy, x1, x2)


def simulate(gen, params, num_steps, n_assets=5, k_factors=2):
    """(xs (num_steps, k), ys (num_steps, n)): a stationary draw, then
    num_steps transitions each followed by an observation."""
    model = make_model(n_assets, k_factors)
    params = torch.as_tensor(params, dtype=torch.float32)
    x = model.sample_q1(gen, params, None, 1)
    xs, ys = [], []
    for _ in range(int(num_steps)):
        x = model.sample_f(gen, params, x, None)
        xs.append(x[0])
        ys.append(model.sample_g(gen, params, x)[0])
    return torch.stack(xs), torch.stack(ys)


__all__ = ["make_model", "make_sv_model", "simulate", "sv_transforms",
           "transforms", "two_factor_log_g", "two_factor_sv_log_g"]
