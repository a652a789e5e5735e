"""Fixed-lag particle smoothing: E[x_t | y_{1:t+L}].

PyTorch counterpart of ``ssme_tpu/filters/smoothing.py``.  The standard
fixed-lag smoother keeps an (L+1)-step window of each particle's recent
path beside the particles; every resampling gathers the WHOLE window with
the same ancestors (``resampling.maybe_resample`` over both), so after the
step at time t the window's oldest slot holds genealogy-consistent draws
of x_{t-L} weighted by the current weights.  For geometrically mixing
state-space models a modest lag already approximates the full smoother
E[x_s | y_{1:T}] (held to the exact RTS Kalman smoother on the
linear-Gaussian model in ``tests/test_torch_smoothing.py``).

The window is kept particle-major, (..., N, L+1, dim_state), so the
resampler gathers it along the particle axis as it is; JAX keeps (L+1,
N, dim_state) and swaps the axes around each resampling.

Index accounting (0-based time): at step t (t = 1..T-1) the window slides
and its newest slot takes the just-propagated particles, so slot j holds
x_{max(0, t-L+j)}; the emitted smoothed value is the weighted mean of
slot 0, i.e. E[x_{t-L} | y_{0:t}] once t >= L.  After the last step,
slots 1..L hold x_{T-L}..x_{T-1}, providing the tail estimates
E[x_s | y_{0:T-1}] for the last L times.
"""

from __future__ import annotations

import math

import torch

from ssme_tpu_torch import resampling
from ssme_tpu_torch.models.base import StateSpaceModel
from ssme_tpu_torch.utils import ess, logsumexp, weighted_expectation


def fixed_lag_smoother(model: StateSpaceModel, num_particles: int,
                       lag: int, resampler: str = "systematic",
                       ess_threshold: float = 0.5):
    """Build ``smooth(gen, params, ys[, zs]) -> (smoothed, filtered,
    log_likelihood)``.

    ``smoothed``: (T, dim_state), E[x_t | y_{1:min(t+lag, T)}] (each state
    smoothed with ``lag`` future observations; the last ``lag`` entries
    use however much future is available).  ``filtered``: (T, dim_state),
    E[x_t | y_{1:t}] for comparison.  ``params`` (P,) constrained, or
    (..., P) for a batch of smoothers (outputs then lead with ...);
    ``ys`` (T,) or (T, dim_obs); ``gen`` a ``torch.Generator`` on the
    device of ``params``.  ESS-adaptive resampling by default (matching
    the filters).
    """
    m = model
    m.require("sample_q1", "log_q1", "log_mu", "log_g", "sample_f")
    n = num_particles
    lag = int(lag)
    if lag < 1:
        raise ValueError("lag must be >= 1")

    def smooth(gen, params, ys, zs=None):
        ys = torch.as_tensor(ys)
        if ys.ndim == 1:
            ys = ys[:, None]
        t_len = ys.shape[0]
        if m.has_covariates and zs is None:
            raise ValueError(f"model {m.name!r} requires covariates zs")
        z_at = (lambda t: zs[t]) if m.has_covariates else (lambda t: None)

        particles = m.sample_q1(gen, params, ys[0], n)
        log_w = (m.log_mu(params, particles)
                 + m.log_g(params, ys[0], particles, z_at(0))
                 - m.log_q1(params, particles, ys[0]))
        lcl0 = logsumexp(log_w) - math.log(float(n))
        filtered = [weighted_expectation(particles, log_w)]

        # slot 0 = oldest, slot lag = current particles
        window = particles.unsqueeze(-2).expand(
            particles.shape[:-1] + (lag + 1, particles.shape[-1]))
        smoothed, lcls = [], []
        for t in range(1, t_len):
            z = z_at(t)
            # ESS-gated joint resample of the particles AND the window
            do_rs = ess(log_w) < ess_threshold * n
            (particles, window), log_w = resampling.maybe_resample(
                gen, log_w, (particles, window), do_rs, kind=resampler)

            # propagate and weight (carried-weight accounting, as
            # filters/bootstrap.py)
            old_lse = logsumexp(log_w)
            particles = m.sample_f(gen, params, particles, z)
            log_w = log_w + m.log_g(params, ys[t], particles, z)
            lcls.append(logsumexp(log_w) - old_lse)

            # slide the window FIRST (slot j now holds x_{t-L+j}), then
            # emit slot 0 = E[x_{t-L} | y_{0:t}]
            window = torch.cat([window[..., 1:, :],
                                particles.unsqueeze(-2)], dim=-2)
            smoothed.append(weighted_expectation(window[..., 0, :], log_w))
            filtered.append(weighted_expectation(particles, log_w))

        # smoothed[k] (step t = k+1) estimates x_{t-L}: the lag-L entries
        # start at k = L-1 (x_0).  The tail x_{T-L}..x_{T-1} comes from
        # window slots 1..L under the final weights.
        tail = [weighted_expectation(window[..., j, :], log_w)
                for j in range(1, lag + 1)]
        smoothed = smoothed[lag - 1:] + tail if t_len > lag \
            else tail[-t_len:]
        log_likelihood = (lcl0 + torch.stack(lcls, dim=-1).sum(-1)
                          if lcls else lcl0)
        return (torch.stack(smoothed, dim=-2), torch.stack(filtered, dim=-2),
                log_likelihood)

    return smooth


__all__ = ["fixed_lag_smoother"]
