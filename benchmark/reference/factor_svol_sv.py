"""Plain bootstrap particle filter of factor stochastic volatility with
stochastic idiosyncratic variances, as Pitt & Shephard (1999) publish
it, and its PMMH model, in any precision.

The model: Pitt & Shephard (1999), "Time-varying covariances: a factor
stochastic volatility approach" (Bayesian Statistics 6, 547-570).  The
state h_t = (f_t, u_t) holds k factor log-variances and n idiosyncratic
ones, each an AR(1) h_{t,j} = mu_j + phi_j (h_{t-1,j} - mu_j) + sigma_j e
from its stationary law, and

    y_t | h_t ~ N(0, L diag(e^{f_t}) L' + diag(e^{u_t})).

Parameter rows (constrained): [phi (k + n), mu (k + n), sigma (k + n),
vec L (n k, row-major)], the factors' leaves first.  The one departure
kept from ``factor_svol.py``: L is unrestricted.

The observation density is the Woodbury form with D_t = diag(e^{u_t}) a
particle's own: M = diag(e^{-f}) + L' D^-1 L (k x k), v = L' D^-1 y,
log det(Sigma) = log det(M) + sum(f) + sum(u) and y' Sigma^-1 y =
y' D^-1 y - v' M^-1 v, M's Cholesky factor written out element by
element over the particles (so it runs in any precision).
``dense_log_density`` computes the same density from the n x n Cholesky
of Sigma itself; it serves only to check the Woodbury one.  The filter
resamples every step, systematically, with one offset a row and step;
its draws come from its own generator, seeded by the caller.  Rows are
filtered in blocks of at most ``ROW_ELEMENTS`` particles, with matrix
products in full float32 where the precision is float32 (TF32 off).

``follow`` is ``reference.pmmh.follow`` with the proposal's Cholesky
factor computed once for each proposal covariance: written out at d = 56
it takes ~0.3 s on the host, and past t1 the covariance is fixed.

Nothing here imports the program.  ``dtype`` is the working precision:
float64 for the reference, a lower one for the control.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import pmmh
from benchmark.reference.factor_svol import Model, no_tf32
from benchmark.reference.filters import (HALF_LOG_2PI, draw_dtype,
                                         generator, systematic_ancestors)

# particles (rows x N) filtered at once
ROW_ELEMENTS = 1 << 22


def unpack(params, n, k):
    """(phi, mu, sigma) each (B, k + n), loadings (B, n, k)."""
    m = n + k
    b = params.shape[0]
    return (params[:, :m], params[:, m:2 * m], params[:, 2 * m:3 * m],
            params[:, 3 * m:3 * m + n * k].reshape(b, n, k))


def transition(params, h, eps, n, k):
    """h' = mu + phi (h - mu) + sigma eps for states h and normals eps
    (k + n, B, N)."""
    phi, mu, sigma, _ = unpack(params, n, k)
    leaf = lambda t: t.T[:, :, None]
    return torch.addcmul(torch.addcmul(leaf(mu * (1.0 - phi)), leaf(phi), h),
                         leaf(sigma), eps)


def stationary(params, eps, n, k):
    """h_0 from each leaf's stationary law, for normals eps (k + n, B, N)."""
    phi, mu, sigma, _ = unpack(params, n, k)
    leaf = lambda t: t.T[:, :, None]
    return torch.addcmul(leaf(mu), leaf(sigma / torch.sqrt(1.0 - phi * phi)),
                         eps)


def log_density(loadings, h, y):
    """log N(y; 0, L diag(e^f) L' + diag(e^u)) (B, N) by Woodbury, for
    loadings (B, n, k), states h (k + n, B, N) and one observation y
    (n,)."""
    n, k = loadings.shape[1], loadings.shape[2]
    f, u = h[:k], h[k:]
    dinv = torch.exp(-u)                                     # (n, B, N)
    # A = L' D^-1 L (k, k, B, N), v = L' D^-1 y (k, B, N), y' D^-1 y
    a = torch.einsum("bia,bic,ibn->acbn", loadings, loadings, dinv)
    v = torch.einsum("bia,i,ibn->abn", loadings, y, dinv)
    yy = torch.einsum("i,ibn->bn", y * y, dinv)
    inv = torch.exp(-f)
    # Cholesky of M = diag(e^-f) + A, element by element over (B, N)
    chol = [[None] * k for _ in range(k)]
    log_det = 0.0
    for j in range(k):
        s = inv[j] + a[j, j]
        for c in range(j):
            s = s - chol[j][c] * chol[j][c]
        chol[j][j] = torch.sqrt(s)
        log_det = log_det + torch.log(chol[j][j])
        for i in range(j + 1, k):
            s = a[i, j]
            for c in range(j):
                s = s - chol[i][c] * chol[j][c]
            chol[i][j] = s / chol[j][j]
    # w = chol^-1 v by forward substitution; v' M^-1 v = |w|^2
    w, quad = [], 0.0
    for i in range(k):
        s = v[i]
        for c in range(i):
            s = s - chol[i][c] * w[c]
        w.append(s / chol[i][i])
        quad = quad + w[i] * w[i]
    return (-n * HALF_LOG_2PI - log_det - 0.5 * (f.sum(0) + u.sum(0))
            - 0.5 * (yy - quad))


def dense_log_density(loadings, h, y):
    """The same density from Sigma = L diag(e^f) L' + diag(e^u) itself:
    its n x n Cholesky factor, log det and a triangular solve (float64;
    only to check :func:`log_density`)."""
    n, k = loadings.shape[1], loadings.shape[2]
    f, u = h[:k], h[k:]
    sigma = (torch.einsum("bia,abn,bja->bnij", loadings, torch.exp(f),
                          loadings)
             + torch.diag_embed(torch.exp(u).permute(1, 2, 0)))
    chol = torch.linalg.cholesky(sigma)                       # (B, N, n, n)
    z = torch.linalg.solve_triangular(
        chol, y.expand(sigma.shape[:-1])[..., None], upper=False)[..., 0]
    log_det = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -n * HALF_LOG_2PI - log_det - 0.5 * (z * z).sum(-1)


def bootstrap_log_likes(seed, params, ys, n, k, dtype):
    """Each row's log-likelihood estimate (B,): a bootstrap filter of N
    particles resampling every step.

    seed: the reference generator's seed (an int); params: (B, P)
    constrained rows; ys: (T, n_obs) observations; k: the factors."""
    dev = params.device
    gen = generator(seed, dev)
    dd = draw_dtype(dtype)
    ys = ys.to(dtype)
    log_n = math.log(float(n))
    block = max(1, ROW_ELEMENTS // n)
    out = []
    with no_tf32():
        for lo in range(0, params.shape[0], block):
            p = params[lo:lo + block].to(dtype)
            out.append(_filter(gen, dd, p, ys, n, k, log_n))
    return torch.cat(out)


def _filter(gen, dd, p, ys, n, k, log_n):
    b = p.shape[0]
    n_obs = ys.shape[1]
    m = n_obs + k
    loadings = unpack(p, n_obs, k)[3]
    total = torch.zeros((b,), dtype=p.dtype, device=p.device)
    h = wn = None
    for t in range(ys.shape[0]):
        eps = torch.randn((m, b, n), generator=gen, dtype=dd,
                          device=p.device).to(p.dtype)
        if t == 0:
            h = stationary(p, eps, n_obs, k)
        else:
            u0 = torch.rand((b,), generator=gen, dtype=dd,
                            device=p.device).to(p.dtype)
            anc = systematic_ancestors(wn, u0).expand(m, b, n)
            h = transition(p, torch.gather(h, 2, anc), eps, n_obs, k)
        lw = log_density(loadings, h, ys[t])
        mx = torch.amax(lw, dim=-1, keepdim=True)
        wn = torch.exp(lw - mx)
        total = total + (mx[:, 0] + torch.log(wn.sum(-1))) - log_n
    return total


def follow(model, start, rec, t0, t1, dtype):
    """``reference.pmmh.follow`` (the same arguments, the same returns),
    with chol(C_t) computed once a distinct C_t: the Haario recursion
    changes C_t only while t0 < i < t1."""
    kw = dict(dtype=dtype)
    d = model.dim
    theta = start["theta"].to(**kw)
    ll = start["log_like"].to(**kw)
    mean = start["mean"].to(**kw)
    sig = start["sigma_hat"].to(**kw)
    ct = start["ct"].to(**kw)
    chol = pmmh.cholesky(ct)
    it = int(start["iteration"])
    eye = torch.eye(d, **kw)
    sd = pmmh.SD_SCALE / d
    out = {k: [] for k in ("proposal", "log_accept", "decision",
                           "margin", "previous")}
    for i in range(rec["eps"].shape[0]):
        it += 1
        fi = float(it)
        if it >= 2:
            diff = theta - mean
            sig = sig * (max(fi - 2.0, 0.0) / max(fi - 1.0, 1.0)) \
                + diff[:, :, None] * diff[:, None, :] / fi
        if it >= 1:
            mean = ((fi - 1.0) * mean + theta) / fi
        if t0 < it < t1:
            ct = sd * (sig + pmmh.EPS * eye)
            chol = pmmh.cholesky(ct)
        prop = theta + (chol @ rec["eps"][i].to(**kw)[..., None])[..., 0]
        new_ll = rec["new_log_like"][i].to(**kw)
        log_acc = (model.log_target_prior(prop) + new_ll
                   - model.log_target_prior(theta) - ll)
        log_u = rec["log_u"][i].to(**kw)
        out["proposal"].append(prop)
        out["log_accept"].append(log_acc)
        out["decision"].append(log_u < log_acc)
        out["margin"].append(torch.abs(log_u - log_acc))
        out["previous"].append(theta)
        theta = rec["theta"][i].to(**kw)
        ll = rec["log_like"][i].to(**kw)
    return {k: torch.stack(v) for k, v in out.items()}


__all__ = ["Model", "bootstrap_log_likes", "dense_log_density", "follow",
           "log_density", "stationary", "transition", "unpack"]
