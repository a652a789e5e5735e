"""Plain bootstrap particle filter of factor stochastic volatility, and
its PMMH model, written from the published model in any precision.

The model is Pitt & Shephard (1999), "Time-varying covariances: a factor
stochastic volatility approach" (Bayesian Statistics 6, 547-570), with
the port's two departures (``ssme_tpu_torch/models/factor_svol.py``):
constant idiosyncratic variances d and an unrestricted loading matrix L.
k AR(1) log-volatility factors x_{t,j} = mu_j + phi_j (x_{t-1,j} - mu_j)
+ sigma_j e, x_0 from their stationary law, and n observed series
y_t ~ N(0, L diag(e^{x_t}) L' + diag(d)).  Parameter rows (constrained):
[phi (k), mu (k), sigma (k), vec L (n k, row-major), d (n)].

The observation density is the general Woodbury form for any k: with
M = diag(e^{-x}) + L' D^-1 L (k x k) and v = L' D^-1 y,
log det(Sigma) = log det(M) + sum(x) + sum(log d) and
y' Sigma^-1 y = y' D^-1 y - v' M^-1 v, M's Cholesky factor written out
element by element over the particles (so it runs in any precision).
The filter resamples every step, systematically, with one offset a row
and step; its draws come from its own generator, seeded by the caller.
Rows are filtered in blocks of at most ``ROW_ELEMENTS`` particles.

Nothing here imports the program.  ``dtype`` is the working precision:
float64 for the reference, a lower one for the control.
"""

from __future__ import annotations

import contextlib
import math

import torch

from benchmark.reference import pmmh
from benchmark.reference.filters import (HALF_LOG_2PI, draw_dtype,
                                         generator, systematic_ancestors)

# particles (rows x N) filtered at once
ROW_ELEMENTS = 1 << 23


@contextlib.contextmanager
def no_tf32():
    """Matrix products and convolutions in full float32 inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def unpack(params, n, k):
    """(phi, mu, sigma) each (B, k), loadings (B, n, k) and d (B, n)."""
    b = params.shape[0]
    return (params[:, :k], params[:, k:2 * k], params[:, 2 * k:3 * k],
            params[:, 3 * k:3 * k + n * k].reshape(b, n, k),
            params[:, 3 * k + n * k:3 * k + n * k + n])


class Woodbury:
    """The observation density of a block of rows: the row constants
    once, then ``log_density(x, y)`` for particle states x (k, B, N), the
    k leaves of every row's particles, and one observation y (n,)."""

    def __init__(self, loadings, d):
        self.k = loadings.shape[-1]
        self.n = loadings.shape[-2]
        self.ld = loadings / d[:, :, None]                      # L' D^-1
        # A = L' D^-1 L (B, k, k), and the constant terms
        self.a = torch.einsum("bia,bic->bac", self.ld, loadings)
        self.dinv = 1.0 / d
        self.const = -self.n * HALF_LOG_2PI - 0.5 * torch.log(d).sum(-1)

    def log_density(self, x, y):
        k = self.k
        v = torch.einsum("bia,i->ba", self.ld, y)                # (B, k)
        yy = (self.dinv * y * y).sum(-1)                         # (B,)
        col = lambda t: t[:, None]                               # (B, 1)
        inv = torch.exp(-x)                                      # S^-1
        # Cholesky of M = diag(e^-x) + A, element by element over (B, N)
        chol = [[None] * k for _ in range(k)]
        log_det = 0.0
        for j in range(k):
            s = inv[j] + col(self.a[:, j, j])
            for c in range(j):
                s = s - chol[j][c] * chol[j][c]
            chol[j][j] = torch.sqrt(s)
            log_det = log_det + torch.log(chol[j][j])
            for i in range(j + 1, k):
                s = col(self.a[:, i, j])
                for c in range(j):
                    s = s - chol[i][c] * chol[j][c]
                chol[i][j] = s / chol[j][j]
        # w = chol^-1 v by forward substitution; v' M^-1 v = |w|^2
        w, quad = [], 0.0
        for i in range(k):
            s = col(v[:, i])
            for c in range(i):
                s = s - chol[i][c] * w[c]
            w.append(s / chol[i][i])
            quad = quad + w[i] * w[i]
        return (col(self.const) - log_det - 0.5 * x.sum(0)
                - 0.5 * (col(yy) - quad))


def bootstrap_log_likes(seed, params, ys, n, k, dtype):
    """Each row's log-likelihood estimate (B,): a bootstrap filter of N
    particles resampling every step.

    seed: the reference generator's seed (an int); params: (B, P)
    constrained rows; ys: (T, n) observations; k: the factors."""
    dev = params.device
    gen = generator(seed, dev)
    dd = draw_dtype(dtype)
    ys = ys.to(dtype)
    n_obs = ys.shape[1]
    log_n = math.log(float(n))
    block = max(1, ROW_ELEMENTS // n)
    out = []
    with no_tf32():
        for lo in range(0, params.shape[0], block):
            p = params[lo:lo + block].to(dtype)
            out.append(_filter(gen, dd, p, ys, n, n_obs, k, log_n))
    return torch.cat(out)


def _filter(gen, dd, p, ys, n, n_obs, k, log_n):
    b = p.shape[0]
    phi, mu, sigma, loadings, d = unpack(p, n_obs, k)
    dens = Woodbury(loadings, d)
    dtype, dev = p.dtype, p.device
    # per leaf (k, B, 1): the transition x' = c + phi x + sigma e with
    # c = mu (1 - phi), and the stationary law's mean and sd
    leaf = lambda t: t.T[:, :, None]
    c, ph, sg = leaf(mu * (1.0 - phi)), leaf(phi), leaf(sigma)
    m0, sd0 = leaf(mu), leaf(sigma / torch.sqrt(1.0 - phi * phi))
    total = torch.zeros((b,), dtype=dtype, device=dev)
    x = wn = None
    for t in range(ys.shape[0]):
        eps = torch.randn((k, b, n), generator=gen, dtype=dd,
                          device=dev).to(dtype)
        if t == 0:
            x = torch.addcmul(m0, sd0, eps)
        else:
            u0 = torch.rand((b,), generator=gen, dtype=dd,
                            device=dev).to(dtype)
            anc = systematic_ancestors(wn, u0).expand(k, b, n)
            x = torch.addcmul(torch.addcmul(c, ph, torch.gather(x, 2, anc)),
                              sg, eps)
        lw = dens.log_density(x, ys[t])
        m = torch.amax(lw, dim=-1, keepdim=True)
        wn = torch.exp(lw - m)
        total = total + (m[:, 0] + torch.log(wn.sum(-1))) - log_n
    return total


class Model(pmmh.Model):
    """``reference.pmmh.Model`` with one more prior,
    ``["half_normal", sd, null]``: log 2 + log N(x; 0, sd) on x >= 0."""

    def __init__(self, spec):
        super().__init__(spec)
        self.half = tuple(k for k, p in enumerate(self.prior)
                          if p[0] == "half_normal")
        self.prior = tuple(("normal", 0.0, p[1]) if p[0] == "half_normal"
                           else p for p in self.prior)

    def log_prior(self, p):
        out = super().log_prior(p) + len(self.half) * math.log(2.0)
        for k in self.half:
            out = torch.where(p[..., k] >= 0, out,
                              torch.full_like(out, -math.inf))
        return out
