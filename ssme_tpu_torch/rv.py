"""Log-density evaluation and sampling.

PyTorch counterpart of ``ssme_tpu/rv.py``.  Every sampler takes an
explicit ``torch.Generator``; out-of-domain arguments yield ``-inf``
instead of raising.  The Gamma and Student-t samplers, which the JAX
package takes from ``jax.random``, are built here from the generator's
normals and uniforms.
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


def halfnorm_logpdf(x, sigma=1.0):
    """log half-normal(x; sigma) on [0, inf)."""
    x = _f32(x)
    lp = math.log(2.0) + norm_logpdf(x, 0.0, sigma)
    return torch.where(x >= 0, lp, torch.full_like(lp, -math.inf))


def beta_logpdf(x, a, b):
    """log Beta(x; a, b) on (0, 1)."""
    x = _f32(x)
    a, b = _f32(a, x), _f32(b, x)
    safe = (x > 0) & (x < 1)
    xs = torch.where(safe, x, torch.full_like(x, 0.5))
    lp = ((a - 1.0) * torch.log(xs) + (b - 1.0) * torch.log1p(-xs)
          + torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b))
    return torch.where(safe, lp, torch.full_like(lp, -math.inf))


def twice_fisher(p):
    """z = log((1+p)/(1-p))."""
    p = _f32(p)
    return torch.log1p(p) - torch.log1p(-p)


def t_logpdf(x, df, loc=0.0, scale=1.0):
    """log Student-t density with ``df`` degrees of freedom; -inf where
    df <= 0 or scale <= 0.

    gammaln((df+1)/2) - gammaln(df/2) cancels catastrophically in float32
    for large df, so above df = 200 the constant is the asymptotic
    log[Gamma(a+1/2)/Gamma(a)] ~ 0.5 log a + log1p(-1/(8a) + 1/(128 a^2)),
    a = df/2, chosen by ``torch.where`` (no host read of df)."""
    x = _f32(x)
    df, loc, scale = _f32(df, x), _f32(loc, x), _f32(scale, x)
    z = (x - loc) / scale
    a = 0.5 * df
    const_exact = (torch.lgamma(a + 0.5) - torch.lgamma(a)
                   - 0.5 * torch.log(df * math.pi))
    const_asym = (0.5 * torch.log(a) - 0.5 * torch.log(df * math.pi)
                  + torch.log1p(-1.0 / (8.0 * a) + 1.0 / (128.0 * a * a)))
    const = torch.where(df > 200.0, const_asym, const_exact)
    val = const - torch.log(scale) - 0.5 * (df + 1.0) * torch.log1p(
        z * z / df)
    return torch.where((df > 0) & (scale > 0), val,
                       torch.full_like(val, -math.inf))


def poisson_logpmf(k, log_rate):
    """log Poisson(k; rate = e^{log_rate}); -inf for a negative or
    non-integer k."""
    k = _f32(k)
    log_rate = _f32(log_rate, k)
    val = k * log_rate - torch.exp(log_rate) - torch.lgamma(k + 1.0)
    ok = (k >= 0) & (k == torch.floor(k))
    return torch.where(ok, val, torch.full_like(val, -math.inf))


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


def mvn_logpdf(x, mean, cov=None, chol=None):
    """log MVN density over the last axis (triangular solve with the
    Cholesky factor; no explicit inverse)."""
    x = _f32(x)
    mean = _f32(mean, x)
    if chol is None:
        chol = chol_with_jitter(cov)
    d = x.shape[-1]
    diff = (x - mean)[..., None]
    chol = chol.expand(diff.shape[:-2] + chol.shape[-2:])
    sol = torch.linalg.solve_triangular(chol, diff, upper=False)[..., 0]
    logdet = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (sol * sol).sum(-1) - logdet - d * _HALF_LOG_2PI


def categorical_from_log_weights(generator, log_weights, shape=None):
    """Indices drawn proportional to ``exp(log_weights)`` over the last
    axis, one (default) per weight; ``shape`` is the number of draws per
    row (an int or a one-element tuple)."""
    log_weights = _f32(log_weights)
    n = log_weights.shape[-1]
    m = n if shape is None else int(shape[-1] if isinstance(
        shape, tuple) else shape)
    probs = torch.softmax(log_weights, dim=-1).reshape(-1, n)
    idx = torch.multinomial(probs, m, replacement=True, generator=generator)
    return idx.reshape(log_weights.shape[:-1] + (m,))


# candidates proposed at once per Gamma draw (see gamma_sample)
_GAMMA_ROUNDS = 16


def gamma_sample(generator, alpha, shape=None):
    """Gamma(alpha, scale 1) draws from the generator's normals and
    uniforms (``torch.distributions`` samplers take no generator).

    Marsaglia and Tsang (2000) for shape a = alpha + 1 when alpha < 1
    (then times U^(1/alpha)), else a = alpha: d = a - 1/3, c = 1/sqrt(9d),
    v = (1 + c z)^3, accept when log u < z^2/2 + d - d v + d log v.  Each
    draw proposes ``_GAMMA_ROUNDS`` candidates at once and keeps the first
    accepted one, so the host never waits on a loop.  Every candidate is
    accepted with probability > 0.95, so all of them fail with
    probability < 1e-20; such a draw keeps the last candidate."""
    alpha = _f32(alpha)
    shape = alpha.shape if shape is None else tuple(shape)
    alpha = alpha.expand(shape)
    kw = dict(generator=generator, dtype=torch.float32, device=alpha.device)
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    z = torch.randn((_GAMMA_ROUNDS,) + shape, **kw)
    u = torch.rand((_GAMMA_ROUNDS,) + shape, **kw)
    v = (1.0 + c * z) ** 3
    vs = torch.where(v > 0, v, torch.ones_like(v))
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * vs
                    + d * torch.log(vs))
    ok[-1] = True
    first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)
    g = d * torch.gather(vs, 0, first)[0]
    ub = torch.rand(shape, **kw)
    return torch.where(boost, g * ub ** (1.0 / alpha), g)


def student_t_sample(generator, df, shape=None):
    """Standard Student-t draws z / sqrt(chi2_df / df), chi2_df =
    2 Gamma(df / 2)."""
    df = _f32(df)
    shape = df.shape if shape is None else tuple(shape)
    z = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=df.device)
    chi2 = 2.0 * gamma_sample(generator, 0.5 * df.expand(shape))
    return z / torch.sqrt(chi2 / df)


__all__ = ["norm_logpdf", "uniform_logpdf", "box_uniform_logpdf",
           "invgamma_logpdf", "halfnorm_logpdf", "beta_logpdf",
           "twice_fisher", "t_logpdf", "poisson_logpmf", "chol_with_jitter",
           "mvn_sample", "mvn_logpdf", "categorical_from_log_weights",
           "gamma_sample", "student_t_sample"]
