"""Plain bootstrap particle filters of univariate SVOL and SVOL with
leverage, written from the published models in any precision.

The model densities follow tbrown122387/ssme
(``example/univ_svol_bootstrap_filter.h``: x_t = phi x_{t-1} + sigma e_t,
y_t ~ N(0, beta^2 e^{x_t}), x_0 ~ N(0, sigma^2 / (1 - phi^2))) and the
leverage model (x_t = mu + phi (x_{t-1} - mu) + z_t rho sigma
e^{-x_{t-1}/2} + sigma sqrt(1 - rho^2) e_t with the mean clamped to
+-40, y_t ~ N(0, e^{x_t}), z_t = y_{t-1}).  The schedule is the
filters' documented one: every step, or an ESS check every ``stride``
steps (and at the last step) with the weights carried between checks; a
systematic resample draws one offset a row and step.  The random draws
come from the reference's own ``torch.Generator``, seeded by the caller:
the reference estimates the same likelihoods as the program with draws
of its own, so nothing ties it to the program's random streams.

Nothing here imports the program.  ``dtype`` is the working precision:
float64 for the reference, a lower one for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
STATE_CLAMP = 40.0
# elements of random draws made at once (a block of steps)
BLOCK_ELEMENTS = 1 << 24


def generator(seed, device):
    """The reference's own generator on ``device``, seeded by ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def stream_seed(*words):
    """A 64-bit generator seed from whole numbers (a run's seed, then the
    words that name a stream of it)."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


def draw_dtype(dtype):
    """The precision draws are made in: float64 for the reference, float32
    for a lower working precision (they are then rounded to it)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def systematic_ancestors(w, u0):
    """Ancestors (B, N): the first i with cdf_i >= (j + u0) total / N."""
    n = w.shape[-1]
    cdf = torch.cumsum(w, dim=-1)
    total = cdf[:, -1:]
    j = torch.arange(n, dtype=w.dtype, device=w.device)[None]
    pts = torch.minimum((j + u0[:, None]) * (total / n), total)
    if cdf.dtype not in (torch.float32, torch.float64):
        cdf, pts = cdf.float(), pts.float()
    idx = torch.searchsorted(cdf.contiguous(), pts.contiguous())
    return torch.clamp(idx, max=n - 1)


def _stationary_init(p, eps):
    phi, sigma = p["phi"], p["sigma"]
    return eps * (sigma / torch.sqrt(1.0 - phi * phi))


def _svol_step(p, x, z, eps):
    return p["phi"] * x + p["sigma"] * eps


def _svol_logw(p, x, y):
    v = (y / p["beta"]) * torch.exp(-0.5 * x)
    return (-HALF_LOG_2PI - torch.log(p["beta"])) - 0.5 * x - 0.5 * v * v


def _lev_mean(p, x, z):
    m = p["mu"] + p["phi"] * (x - p["mu"]) + z * p["rho"] * p["sigma"] \
        * torch.exp(-0.5 * x)
    return torch.clamp(m, -STATE_CLAMP, STATE_CLAMP)


def _lev_step(p, x, z, eps):
    sd = p["sigma"] * torch.sqrt(1.0 - p["rho"] * p["rho"])
    return _lev_mean(p, x, z) + sd * eps


def _lev_logw(p, x, y):
    v = y * torch.exp(-0.5 * x)
    return -HALF_LOG_2PI - 0.5 * x - 0.5 * v * v


MODELS = {
    # constrained parameter columns, and the hooks
    "svol": (("beta", "phi", "ss"), _stationary_init, _svol_step,
             _svol_logw),
    "svol_leverage": (("phi", "mu", "sigma", "rho"), _stationary_init,
                      _lev_step, _lev_logw),
}


def bootstrap_log_likes(model, seed, params, ys, n, ess_threshold, stride,
                        dtype):
    """Each row's log-likelihood estimate (B,) of ``model``.

    seed: the reference generator's seed (an int); params: (B, P)
    constrained parameters in the model's column order; ys: (T,)
    observations.  ``ess_threshold`` >= 1 resamples every step (stride
    1); below it a row resamples where ESS < ess_threshold N at a check.
    """
    names, init, step, logw = MODELS[model]
    dev = params.device
    gen = generator(seed, dev)
    dd = draw_dtype(dtype)
    p = {k: params[:, i:i + 1].to(dtype) for i, k in enumerate(names)}
    if "ss" in p:
        p["sigma"] = torch.sqrt(p["ss"])
    ys = ys.to(dtype)
    zs = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    b, t_len = params.shape[0], ys.shape[0]
    log_n = math.log(float(n))
    always = ess_threshold >= 1.0
    limit = float(ess_threshold) * n
    g = 1 if always else int(stride)
    block = max(1, BLOCK_ELEMENTS // (b * n))
    total = torch.zeros((b, 1), dtype=dtype, device=dev)
    carry = torch.full((b, 1), log_n, dtype=dtype, device=dev)
    ess_ok = torch.ones((b, 1), dtype=torch.bool, device=dev)
    for t in range(t_len):
        if t % block == 0:
            k = min(block, t_len - t)
            eps = torch.randn((k, b, n), generator=gen, dtype=dd,
                              device=dev).to(dtype)
            u0 = torch.rand((k, b), generator=gen, dtype=dd,
                            device=dev).to(dtype)
        if t == 0:
            x = init(p, eps[0])
            lw = torch.zeros_like(x)
            wn = torch.ones_like(x)
        else:
            if g == 1:
                fire = torch.ones_like(ess_ok) if always else ~ess_ok
                x, lw, carry = _resample(fire, wn, u0[t % block], x, lw,
                                         carry, log_n)
            x = step(p, x, zs[t], eps[t % block])
        lw = lw + logw(p, x, ys[t])
        if not (g == 1 or t % g == g - 1 or t == t_len - 1):
            continue
        m = torch.amax(lw, dim=-1, keepdim=True)
        wn = torch.exp(lw - m)
        s = wn.sum(-1, keepdim=True)
        s2 = (wn * wn).sum(-1, keepdim=True)
        total = total + ((m + torch.log(s)) - carry)
        lw = lw - m
        carry = torch.log(s)
        ess_ok = s * s / s2 >= limit
        if g > 1:
            x, lw, carry = _resample(~ess_ok, wn, u0[t % block], x, lw,
                                     carry, log_n)
    return total[:, 0]


def _resample(fire, wn, u0, x, lw, carry, log_n):
    """Resample the rows where ``fire`` (B, 1): their weights reset."""
    anc = systematic_ancestors(wn, u0)
    x = torch.where(fire, torch.gather(x, 1, anc), x)
    lw = torch.where(fire, torch.zeros_like(lw), lw)
    carry = torch.where(fire, torch.full_like(carry, log_n), carry)
    return x, lw, carry


def log_mean_exp(v, dim=-1):
    m = torch.amax(v, dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (m + torch.log(torch.exp(v - m).mean(dim=dim, keepdim=True))
            ).squeeze(dim)
