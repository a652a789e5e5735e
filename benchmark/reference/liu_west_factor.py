"""Plain Liu-West auxiliary particle filters of two-factor stochastic
volatility over a panel of returns, in any precision.

Liu and West (2001), "Combined parameter and state estimation in
simulation-based filtering" (Sequential Monte Carlo Methods in Practice,
197-223), on the factor SV model of Pitt & Shephard (1999) as
``reference/factor_svol.py`` writes it: x_{t,j} = mu_j + phi_j
(x_{t-1,j} - mu_j) + sigma_j e, y_t ~ N(0, L diag(e^{x_t}) L' + diag(d)).
Each of F filters carries a joint cloud of N (state, theta) particles,
theta = [phi (2), mu (2), sigma (2), vec L (2n, row-major), d (n)] in the
transformed space (phi twice-Fisher, mu and L null, sigma and d log).
Per step, the published shrinkage: the weighted mean and covariance V of
theta, a = (3 delta - 1) / (2 delta), h^2 = 1 - a^2; the lookahead
mu_i = E[x_t | x_{t-1}^i, theta^i] and first-stage weights w_i
g(y_t | mu_i; m_i) at the shrunk m_i = a theta_i + (1 - a) theta_bar, a
systematic selection on them; the kernel draw theta' = m + chol(h^2 V) e
(the diagonal floored at 1e-9); the transition; second-stage weights
g(y_t | x_t; theta') / g(y_t | mu; m); and a systematic resample every
step.  At t = 0 theta comes from the uniform prior box and x from its
stationary law.  The state and the lookahead are held to +-40 (the
leverage model's clamp, as the program holds them): the kernel moves
sigma freely, and past 40 a factor's log-variance changes no density.  The density is ``reference/factor_svol.py``'s Woodbury
form, each particle a row of its own.  The draws (the prior uniforms, P
normals for theta and two for the state a particle and step, the two
offsets of a step) come from the reference's own generator, seeded by the
caller.  The F filters run as one batch.

Nothing here imports the program.  ``dtype`` is the working precision:
float64 for the reference, a lower one for the control.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.factor_svol import Woodbury, no_tf32
from benchmark.reference.filters import (STATE_CLAMP, draw_dtype,
                                         generator, systematic_ancestors)

EPS_CHOL = 1e-9
RANK_REL = 1e-4
K_FACTORS = 2
# elements of normal draws made at once (a block of steps)
BLOCK_ELEMENTS = 1 << 24


def transform_kinds(n_assets):
    """Each parameter's transform: "fisher", "null" or "log"."""
    k = K_FACTORS
    return (("fisher",) * k + ("null",) * k + ("log",) * k
            + ("null",) * (n_assets * k) + ("log",) * n_assets)


def _rows(kinds, kind):
    return [i for i, c in enumerate(kinds) if c == kind]


def to_constrained(th, kinds):
    """(P, ...) transformed -> constrained (a few whole-block operations:
    the reference's step is host-bound)."""
    out = th.clone()
    fi, li = _rows(kinds, "fisher"), _rows(kinds, "log")
    out[fi] = torch.tanh(0.5 * th[fi])
    out[li] = torch.exp(th[li])
    return out


def to_transformed(cp, kinds):
    out = cp.clone()
    fi, li = _rows(kinds, "fisher"), _rows(kinds, "log")
    out[fi] = torch.log1p(cp[fi]) - torch.log1p(-cp[fi])
    out[li] = torch.log(cp[li])
    return out


def _log_g(cp, x, y, n_assets):
    """log g(y | x; theta) of every particle: cp (P, F, N) constrained, x
    (2, F, N), y (n,); a Woodbury row per particle."""
    k, n = K_FACTORS, n_assets
    p, f, m = cp.shape
    rows = cp.reshape(p, f * m).T                                # (B, P)
    loadings = rows[:, 3 * k:3 * k + n * k].reshape(f * m, n, k)
    d = rows[:, 3 * k + n * k:]
    dens = Woodbury(loadings, d)
    return dens.log_density(x.reshape(k, f * m, 1), y).reshape(f, m)


def _mean(cp, x):
    """The transition's mean mu + phi (x - mu), (2, F, N)."""
    k = K_FACTORS
    phi, mu = cp[:k], cp[k:2 * k]
    return mu + phi * (x - mu)


def _clamp(x):
    """The state (and the lookahead) held to +-STATE_CLAMP."""
    return torch.clamp(x, -STATE_CLAMP, STATE_CLAMP)


def _cholesky(gram, h2):
    """Lower Cholesky factors (F, P, P) of h^2 gram (F, P, P), column by
    column, the diagonal floored at EPS_CHOL; a pivot at or below RANK_REL
    of its column's diagonal leaves the rest of the column 0 (a direction
    the cloud does not span: the semi-definite factor)."""
    p = gram.shape[-1]
    a = h2 * gram
    lmat = torch.zeros_like(a)
    for j in range(p):
        row = lmat[:, j, :j]
        s = a[:, j, j] - (row * row).sum(-1)
        dj = torch.sqrt(torch.clamp(s, min=EPS_CHOL))
        lmat[:, j, j] = dj
        if j + 1 < p:
            below = a[:, j + 1:, j] - torch.einsum(
                "fik,fk->fi", lmat[:, j + 1:, :j], row)
            spans = (s > RANK_REL * a[:, j, j])[:, None]
            lmat[:, j + 1:, j] = torch.where(spans, below / dj[:, None],
                                             torch.zeros_like(below))
    return lmat


def liu_west_apf(seed, ys, num_filters, n, delta, prior_bounds, dtype,
                 device):
    """(log-likelihood (F,), constrained parameter cloud (F, N, P)) of F
    filters over ``ys`` (T, n_assets), their draws from a generator seeded
    by ``seed`` (an int)."""
    with no_tf32():
        return _run(seed, ys, num_filters, n, delta, prior_bounds, dtype,
                    device)


def _run(seed, ys, num_filters, n, delta, prior_bounds, dtype, device):
    f = int(num_filters)
    k = K_FACTORS
    gen = generator(seed, device)
    dd = draw_dtype(dtype)
    ys = ys.to(device=device, dtype=dtype)
    t_len, n_assets = ys.shape
    kinds = transform_kinds(n_assets)
    p = len(kinds)
    a = (3.0 * delta - 1.0) / (2.0 * delta)
    h2 = 1.0 - a * a
    log_n = math.log(float(n))
    kw = dict(dtype=dtype, device=device)
    block = max(1, BLOCK_ELEMENTS // (f * n * (p + k)))
    cache = {}

    def rand(*shape, normal=False):
        fn = torch.randn if normal else torch.rand
        return fn(shape, generator=gen, dtype=dd, device=device).to(dtype)

    def draws(t):
        """The P + 2 normals of each particle, the resampling and the
        selection offsets of step t, made for a block of steps at once."""
        if cache.get("start") is None or not \
                cache["start"] <= t < cache["start"] + block:
            size = min(block, t_len - t)
            cache.update(start=t, e=rand(size, p + k, f, n, normal=True),
                         off=rand(size, f), sel=rand(size, f))
        i = t - cache["start"]
        return cache["e"][i], cache["off"][i], cache["sel"][i]

    def resample(w, u0, leaves):
        """Leaves (L, F, N) moved by one systematic selection on w."""
        anc = systematic_ancestors(w, u0)
        return torch.gather(leaves, 2, anc[None].expand_as(leaves))

    def lse(v):
        m = torch.amax(v, -1, keepdim=True)
        return m + torch.log(torch.exp(v - m).sum(-1, keepdim=True))

    u = rand(p, f, n)
    cp = torch.stack([lo + (hi - lo) * u[i]
                      for i, (lo, hi) in enumerate(prior_bounds)])
    th = to_transformed(cp, kinds)
    e, off, _ = draws(0)
    phi, mu, sig = cp[:k], cp[k:2 * k], cp[2 * k:3 * k]
    x = mu + e[p:] * (sig / torch.sqrt(1.0 - phi * phi))
    lw = _log_g(cp, x, ys[0], n_assets)
    total = lse(lw) - log_n
    wn = torch.exp(lw - torch.amax(lw, -1, keepdim=True))
    moved = resample(wn, off, torch.cat([x, th]))
    x, th = moved[:k], moved[k:]
    lw = torch.zeros((f, n), **kw)
    for t in range(1, t_len):
        e, off, sel = draws(t)
        y = ys[t]
        ww = torch.exp(lw)
        wsum = ww.sum(-1, keepdim=True)
        tbar = (th * ww).sum(-1, keepdim=True) / wsum          # (P, F, 1)
        cen = th - tbar
        gram = torch.einsum("ifn,jfn->fij", cen * ww, cen) / wsum[:, :, None]
        lmat = _cholesky(gram, h2)                             # (F, P, P)
        shrunk = a * th + (1.0 - a) * tbar
        look = _clamp(_mean(to_constrained(th, kinds), x))
        lg = _log_g(to_constrained(shrunk, kinds), look, y, n_assets)
        lfs = lw + lg
        mfs = torch.amax(lfs, -1, keepdim=True)
        wfs = torch.exp(lfs - mfs)
        lse_fs = mfs + torch.log(wfs.sum(-1, keepdim=True))
        moved = resample(wfs, sel, torch.cat([x, lg[None], shrunk]))
        x_a, lg_a, shrunk_a = moved[:k], moved[k], moved[k + 1:]
        th = shrunk_a + torch.einsum("fik,kfn->ifn", lmat, e[:p])
        cp = to_constrained(th, kinds)
        x = _clamp(_mean(cp, x_a) + cp[2 * k:3 * k] * e[p:])
        lw_new = _log_g(cp, x, y, n_assets) - lg_a
        total = total + (lse_fs - torch.log(wsum)) + lse(lw_new) - log_n
        wn = torch.exp(lw_new - torch.amax(lw_new, -1, keepdim=True))
        moved = resample(wn, off, torch.cat([x, th]))
        x, th = moved[:k], moved[k:]
        lw = torch.zeros((f, n), **kw)
    return total[:, 0], to_constrained(th, kinds).permute(1, 2, 0)
