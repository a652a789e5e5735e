"""Plain adaptive PMMH host step of the SVOL models, in any precision.

From tbrown122387/ssme ``example/estimate_univ_svol.h:95-175`` and its
``include/ssme/pmmh.h`` (Haario et al. 2001): a random-walk proposal
theta' = theta + chol(C_t) e in the transformed space; the MH ratio
log u < [log p(theta') + log|J(theta')| + log L(theta')] - [the same at
theta]; the running mean and covariance of the chain's transformed
positions, and C_t = 2.4^2 / d (Sigma_t + 0.01 I) while t0 < i < t1.

``follow`` replays a recorded window: at each iteration it starts from
the position the program held (the chain is random, so the reference
follows the program's own state), recomputes the moments, the proposal,
the prior and Jacobian and the MH decision from the program's
likelihood values and draws, and returns what each should have been.
Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

SD_SCALE = 2.4 * 2.4
EPS = 0.01


def _softplus(z):
    return torch.clamp(z, min=0) + torch.log1p(torch.exp(-torch.abs(z)))


# transform name -> (constrain, unconstrain, log |d constrained / d z|)
TRANSFORMS = {
    "null": (lambda z: z, lambda p: p, lambda z: torch.zeros_like(z)),
    "log": (torch.exp, torch.log, lambda z: z),
    "logit": (torch.sigmoid, lambda p: torch.log(p) - torch.log1p(-p),
              lambda z: -z - 2.0 * _softplus(-z)),
    "twice_fisher": (lambda z: torch.tanh(0.5 * z),
                     lambda p: torch.log1p(p) - torch.log1p(-p),
                     lambda z: math.log(2.0) + z - 2.0 * _softplus(z)),
}


class Model:
    """Transforms and prior of a configuration (its JSON ``pmmh``
    block): ``transforms`` one name a parameter, and ``prior`` one entry
    a parameter, ``["normal", mean, sd]``, ``["uniform", lo, hi]`` or
    ``["inv_gamma", shape, scale]``."""

    def __init__(self, spec):
        self.names = tuple(spec["params"])
        self.transforms = tuple(spec["transforms"])
        self.prior = tuple(tuple(p) for p in spec["prior"])

    @property
    def dim(self):
        return len(self.names)

    def constrain(self, z):
        return torch.stack([TRANSFORMS[t][0](z[..., k])
                            for k, t in enumerate(self.transforms)], -1)

    def unconstrain(self, p):
        return torch.stack([TRANSFORMS[t][1](p[..., k])
                            for k, t in enumerate(self.transforms)], -1)

    def log_jacobian(self, z):
        return sum(TRANSFORMS[t][2](z[..., k])
                   for k, t in enumerate(self.transforms))

    def log_prior(self, p):
        out = torch.zeros_like(p[..., 0])
        for k, (kind, a, b) in enumerate(self.prior):
            x = p[..., k]
            if kind == "normal":
                lp = -0.5 * math.log(2 * math.pi) - math.log(b) \
                    - 0.5 * ((x - a) / b) ** 2
            elif kind == "uniform":
                inside = (x >= a) & (x <= b)
                lp = torch.where(inside, torch.full_like(x, -math.log(b - a)),
                                 torch.full_like(x, -math.inf))
            elif kind == "inv_gamma":
                xs = torch.where(x > 0, x, torch.ones_like(x))
                lp = (a * math.log(b) - math.lgamma(a)
                      - (a + 1.0) * torch.log(xs) - b / xs)
                lp = torch.where(x > 0, lp, torch.full_like(x, -math.inf))
            else:
                raise ValueError(f"unknown prior {kind!r}")
            out = out + lp
        return out

    def log_target_prior(self, z):
        """log prior at the constrained point plus the log-Jacobian."""
        return self.log_prior(self.constrain(z)) + self.log_jacobian(z)


def cholesky(c):
    """Lower Cholesky factors of (..., d, d) matrices, written out, so it
    runs in any precision."""
    d = c.shape[-1]
    lmat = [[torch.zeros_like(c[..., 0, 0]) for _ in range(d)]
            for _ in range(d)]
    for j in range(d):
        s = c[..., j, j] - sum(lmat[j][k] * lmat[j][k] for k in range(j))
        lmat[j][j] = torch.sqrt(s)
        for i in range(j + 1, d):
            s = c[..., i, j] - sum(lmat[i][k] * lmat[j][k] for k in range(j))
            lmat[i][j] = s / lmat[j][j]
    return torch.stack([torch.stack(row, -1) for row in lmat], -2)


def follow(model, start, rec, t0, t1, dtype):
    """Replay a recorded run.

    start: dict of ``theta`` (C, d) transformed, ``log_like`` (C,), the
    Haario ``mean`` (C, d), ``sigma_hat`` (C, d, d), ``ct`` (C, d, d) and
    ``iteration`` (completed iterations) the run started from.  rec: dict
    of (I, ...) tensors of the I recorded iterations: ``eps`` (I, C, d)
    and ``log_u`` (I, C), the draws the program took; ``theta`` (I, C, d)
    and ``log_like`` (I, C), the chain after each iteration;
    ``new_log_like`` (I, C) the hook's values.
    Returns dict of (I, ...) tensors in ``dtype``: ``proposal`` (the
    transformed proposal), ``log_accept``, ``decision`` (log u <
    log_accept), ``margin`` (|log u - log_accept|) and ``previous`` (the
    position the iteration started from).
    """
    kw = dict(dtype=dtype)
    d = model.dim
    theta = start["theta"].to(**kw)
    ll = start["log_like"].to(**kw)
    mean = start["mean"].to(**kw)
    sig = start["sigma_hat"].to(**kw)
    ct = start["ct"].to(**kw)
    it = int(start["iteration"])
    eye = torch.eye(d, **kw)
    sd = SD_SCALE / d
    out = {k: [] for k in ("proposal", "log_accept", "decision",
                           "margin", "previous")}
    n_iter = rec["eps"].shape[0]
    for i in range(n_iter):
        it += 1
        fi = float(it)
        if it >= 2:
            diff = theta - mean
            sig = sig * (max(fi - 2.0, 0.0) / max(fi - 1.0, 1.0)) \
                + diff[:, :, None] * diff[:, None, :] / fi
        if it >= 1:
            mean = ((fi - 1.0) * mean + theta) / fi
        if t0 < it < t1:
            ct = sd * (sig + EPS * eye)
        prop = theta + (cholesky(ct) @ rec["eps"][i].to(**kw)[..., None])[
            ..., 0]
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
