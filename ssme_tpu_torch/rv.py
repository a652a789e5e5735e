"""Log-density evaluation and MVN sampling.

PyTorch counterpart of the parts of ``ssme_tpu/rv.py`` the PMMH main
path uses.  Every sampler takes an explicit ``torch.Generator``;
out-of-domain arguments yield ``-inf`` instead of raising.
"""

from __future__ import annotations

import math

import torch

_HALF_LOG_2PI = 0.9189385332046727  # 0.5 * log(2*pi)


def _f32(v, like=None):
    """``v`` as a float32 tensor on ``like``'s device.  A Python number
    becomes a device-side fill, never a host-to-device copy (such a copy
    waits for the device, and PMMH calls these every iteration)."""
    if isinstance(v, torch.Tensor):
        return v
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.full((), float(v), dtype=torch.float32, device=device)


def norm_logpdf(x, mu=0.0, sigma=1.0):
    """log N(x; mu, sigma^2); -inf where sigma <= 0."""
    x = _f32(x)
    mu, sigma = _f32(mu, x), _f32(sigma, x)
    safe = sigma > 0
    s = torch.where(safe, sigma, torch.ones_like(sigma))
    z = (x - mu) / s
    lp = -_HALF_LOG_2PI - torch.log(s) - 0.5 * z * z
    return torch.where(safe, lp, torch.full_like(lp, -math.inf))


def uniform_logpdf(x, lower=0.0, upper=1.0):
    """log U(x; lower, upper); -inf outside the support.

    Python-number bounds stay host constants; tensor bounds (on ``x``'s
    device) are evaluated with tensor operations, never read back to the
    host.  For one box per last-axis column given as Python floats, see
    :func:`box_uniform_logpdf`.
    """
    x = _f32(x)
    if isinstance(lower, torch.Tensor) or isinstance(upper, torch.Tensor):
        lo, hi = _f32(lower, x), _f32(upper, x)
        inside = (x >= lo) & (x <= hi) & (hi > lo)
        return torch.where(inside, -torch.log(hi - lo),
                           torch.full_like(x, -math.inf))
    lower, upper = float(lower), float(upper)
    inside = (x >= lower) & (x <= upper) & (upper > lower)
    val = torch.full_like(x, -math.log(upper - lower)
                          if upper > lower else -math.inf)
    return torch.where(inside, val, torch.full_like(x, -math.inf))


def box_uniform_logpdf(x, bounds):
    """Per-column log U(x[..., k]; lo_k, hi_k) for ``bounds`` a sequence
    of (lo, hi) Python floats, one per last-axis column; returns the
    (..., d) log-densities (JAX ``rv.uniform_logpdf`` with vector bounds).
    Each column is evaluated against host constants, so nothing is copied
    to the device."""
    x = _f32(x)
    if len(bounds) != x.shape[-1]:
        raise ValueError(f"{len(bounds)} bounds for {x.shape[-1]} columns")
    return torch.stack([uniform_logpdf(x[..., k], lo, hi)
                        for k, (lo, hi) in enumerate(bounds)], dim=-1)


def invgamma_logpdf(x, alpha, beta):
    """log InvGamma(x; shape alpha, scale beta); -inf for x <= 0."""
    x = _f32(x)
    safe = x > 0
    xs = torch.where(safe, x, torch.ones_like(x))
    a = _f32(alpha, x)
    b = _f32(beta, x)
    lp = (a * torch.log(b) - torch.lgamma(a)
          - (a + 1.0) * torch.log(xs) - b / xs)
    return torch.where(safe, lp, torch.full_like(lp, -math.inf))


def twice_fisher(p):
    """z = log((1+p)/(1-p))."""
    p = _f32(p)
    return torch.log1p(p) - torch.log1p(-p)


def chol_with_jitter(cov, jitter=1e-8):
    """Cholesky of a PSD matrix with a tiny relative ridge.

    ``torch.linalg.cholesky`` raises on a matrix that is not positive
    definite, where ``jnp.linalg.cholesky`` returns NaN.  PMMH relies on
    the NaN (a NaN proposal makes the MH step reject), so this uses
    ``cholesky_ex`` and NaN-fills every factor whose decomposition
    failed, without a host sync.
    """
    cov = _f32(cov)
    d = cov.shape[-1]
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
    scale = torch.clamp(tr / d, min=1.0)
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    chol, info = torch.linalg.cholesky_ex(
        cov + (jitter * scale)[..., None, None] * eye)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(chol, math.nan), chol)


def mvn_sample(generator, mean, cov=None, chol=None):
    """Draw one MVN(mean, cov) sample per leading batch entry; pass
    ``chol`` to reuse a factor."""
    mean = _f32(mean)
    if chol is None:
        chol = chol_with_jitter(cov)
    eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                      device=mean.device)
    return mean + torch.matmul(chol, eps[..., None])[..., 0]


__all__ = ["norm_logpdf", "uniform_logpdf", "box_uniform_logpdf",
           "invgamma_logpdf", "twice_fisher", "chol_with_jitter", "mvn_sample"]
