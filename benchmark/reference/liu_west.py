"""Plain Liu-West auxiliary particle filters of SVOL with leverage, in any
precision.

Liu and West (2001), "Combined parameter and state estimation in
simulation-based filtering", as tbrown122387/ssme
``include/ssme/liu_west_filter.h`` runs it on the leverage model: each of
F filters carries a joint cloud of N (state, theta) particles, theta in
the transformed space (phi logit, mu null, sigma log, rho twice-Fisher).
Per step: the weighted mean and covariance of theta, shrinkage a =
(3 delta - 1) / (2 delta), h^2 = 1 - a^2, the lookahead
mu_i = E[x_t | x_{t-1}^i, theta^i], first-stage weights w_i g(y_t |
mu_i) and a systematic selection on them, the kernel draw theta' = a
theta + (1 - a) theta_bar + chol(h^2 V) e, the transition, second-stage
weights g(y_t | x_t) / g(y_t | mu), and a systematic resample every
step.  At t = 0 theta comes from the uniform prior box and x from its
stationary law.  The draws (the prior uniforms, four normals for theta
and one for the state a particle and step, the two offsets of a step)
come from the reference's own generator, seeded by the caller.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.filters import HALF_LOG_2PI, STATE_CLAMP, \
    draw_dtype, generator, systematic_ancestors

NUM_PARAMS = 4
EPS_CHOL = 1e-9


def to_constrained(th):
    """(4, ...) transformed (phi, mu, sigma, rho) -> constrained."""
    return torch.stack([torch.sigmoid(th[0]), th[1], torch.exp(th[2]),
                        torch.tanh(0.5 * th[3])])


def to_transformed(cp):
    return torch.stack([torch.log(cp[0]) - torch.log1p(-cp[0]), cp[1],
                        torch.log(cp[2]),
                        torch.log1p(cp[3]) - torch.log1p(-cp[3])])


def _mean(cp, x, z):
    phi, mu, sig, rho = cp[0], cp[1], cp[2], cp[3]
    return torch.clamp(mu + phi * (x - mu) + z * rho * sig
                       * torch.exp(-0.5 * x), -STATE_CLAMP, STATE_CLAMP)


def _log_g(x, y):
    v = y * torch.exp(-0.5 * x)
    return -HALF_LOG_2PI - 0.5 * x - 0.5 * v * v


def _cholesky(gram, h2):
    """Lower Cholesky factors (F, P, P) of h^2 gram (F, P, P), the
    diagonal floored at EPS_CHOL."""
    p = gram.shape[-1]
    lmat = [[torch.zeros_like(gram[:, 0, 0]) for _ in range(p)]
            for _ in range(p)]
    for j in range(p):
        s = h2 * gram[:, j, j] - sum(lmat[j][k] * lmat[j][k]
                                     for k in range(j))
        lmat[j][j] = torch.sqrt(torch.clamp(s, min=EPS_CHOL))
        for i in range(j + 1, p):
            s = h2 * gram[:, i, j] - sum(lmat[i][k] * lmat[j][k]
                                         for k in range(j))
            lmat[i][j] = s / lmat[j][j]
    return torch.stack([torch.stack(row, -1) for row in lmat], -2)


def liu_west_apf(seed, ys, num_filters, n, delta, prior_bounds, dtype,
                 device):
    """(log-likelihood (F,), constrained parameter cloud (F, N, 4)) of F
    filters over ``ys`` (T,), their draws from a generator seeded by
    ``seed`` (an int)."""
    f = int(num_filters)
    gen = generator(seed, device)
    dd = draw_dtype(dtype)
    ys = ys.to(device=device, dtype=dtype)
    zs = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    t_len = ys.shape[0]
    a = (3.0 * delta - 1.0) / (2.0 * delta)
    h2 = 1.0 - a * a
    log_n = math.log(float(n))
    kw = dict(dtype=dtype, device=device)

    block = max(1, (1 << 24) // (f * n * (NUM_PARAMS + 1)))
    cache = {}

    def rand(*shape, normal=False):
        fn = torch.randn if normal else torch.rand
        return fn(shape, generator=gen, dtype=dd, device=device).to(dtype)

    def draws(t):
        """The five normals of each particle, the resampling and the
        selection offsets of step t, made for a block of steps at once."""
        if cache.get("start") is None or not \
                cache["start"] <= t < cache["start"] + block:
            k = min(block, t_len - t)
            cache.update(start=t, e=rand(k, NUM_PARAMS + 1, f, n,
                                         normal=True),
                         off=rand(k, f), sel=rand(k, f))
        i = t - cache["start"]
        return (list(cache["e"][i]), cache["off"][i], cache["sel"][i])

    def resample(w, u0, leaves):
        """Leaves (L, F, N) moved by one systematic selection on w."""
        anc = systematic_ancestors(w, u0)
        return torch.gather(leaves, 2, anc[None].expand_as(leaves))

    u = rand(NUM_PARAMS, f, n)
    cp = torch.stack([lo + (hi - lo) * u[k]
                      for k, (lo, hi) in enumerate(prior_bounds)])
    th = to_transformed(cp)
    e, off, _ = draws(0)
    x = e[NUM_PARAMS] * (cp[2] / torch.sqrt(1.0 - cp[0] * cp[0]))
    lw = _log_g(x, ys[0])
    m = torch.amax(lw, -1, keepdim=True)
    wn = torch.exp(lw - m)
    total = m + torch.log(wn.sum(-1, keepdim=True)) - log_n
    moved = resample(wn, off, torch.cat([x[None], th]))
    x, th = moved[0], moved[1:]
    lw = torch.zeros((f, n), **kw)
    for t in range(1, t_len):
        e, off, sel = draws(t)
        y, z = ys[t], zs[t]
        ww = torch.exp(lw)
        wsum = ww.sum(-1, keepdim=True)
        tbar = (th * ww).sum(-1, keepdim=True) / wsum          # (P, F, 1)
        cen = th - tbar
        gram = torch.einsum("ifn,jfn->fij", cen * ww, cen) / wsum[:, :, None]
        lmat = _cholesky(gram, h2)                             # (F, P, P)
        shrunk = a * th + (1.0 - a) * tbar
        look = _mean(to_constrained(th), x, z)
        lfs = lw + _log_g(look, y)
        mfs = torch.amax(lfs, -1, keepdim=True)
        wfs = torch.exp(lfs - mfs)
        lse_fs = mfs + torch.log(wfs.sum(-1, keepdim=True))
        moved = resample(wfs, sel, torch.cat([x[None], look[None], shrunk]))
        x_a, look_a, shrunk_a = moved[0], moved[1], moved[2:]
        th = shrunk_a + torch.einsum("fik,kfn->ifn", lmat,
                                     torch.stack(e[:NUM_PARAMS]))
        cp = to_constrained(th)
        sd = cp[2] * torch.sqrt(1.0 - cp[3] * cp[3])
        x = _mean(cp, x_a, z) + sd * e[NUM_PARAMS]
        lw_new = _log_g(x, y) - _log_g(look_a, y)
        m = torch.amax(lw_new, -1, keepdim=True)
        wn = torch.exp(lw_new - m)
        total = total + (lse_fs - torch.log(wsum)) \
            + (m + torch.log(wn.sum(-1, keepdim=True))) - log_n
        moved = resample(wn, off, torch.cat([x[None], th]))
        x, th = moved[0], moved[1:]
        lw = torch.zeros((f, n), **kw)
    return total[:, 0], to_constrained(th).permute(1, 2, 0)
