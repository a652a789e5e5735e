"""Shared numerics: stable log-sum-exp reductions, ESS, weight helpers.

PyTorch counterpart of ``ssme_tpu/utils.py``; same names, same -inf
conventions, float32 throughout.
"""

from __future__ import annotations

import math

import torch


def logsumexp(log_x, dim=-1, keepdim=False):
    """Numerically-stable log(sum(exp(log_x))); -inf-safe (an all -inf
    slice gives -inf, not NaN)."""
    log_x = torch.as_tensor(log_x)
    m = torch.amax(log_x, dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.sum(torch.exp(log_x - m), dim=dim, keepdim=True)
    out = m + torch.log(s)
    return out if keepdim else out.squeeze(dim)


def logmeanexp(log_x, dim=-1, keepdim=False):
    """log of the mean of exp(log_x): the replicate-averaging reduction."""
    log_x = torch.as_tensor(log_x)
    n = log_x.shape[dim]
    return logsumexp(log_x, dim=dim, keepdim=keepdim) - math.log(float(n))


def normalize_log_weights(log_w, dim=-1):
    """Self-normalized weights from log-unnormalized weights."""
    return torch.softmax(torch.as_tensor(log_w), dim=dim)


def ess(log_w, dim=-1):
    """Effective sample size 1 / sum(w_i^2) of normalized weights."""
    w = normalize_log_weights(log_w, dim=dim)
    return 1.0 / torch.sum(w * w, dim=dim)


def weighted_expectation(values, log_w):
    """Sum_i h_i * w~_i over the particle axis.

    ``log_w``: (..., N); ``values``: (..., N, *event) with the same
    leading batch shape.  Returns (..., *event).
    """
    values = torch.as_tensor(values)
    w = normalize_log_weights(log_w, dim=-1)
    particle_dim = w.ndim - 1
    w = w.reshape(w.shape + (1,) * (values.ndim - w.ndim))
    return torch.sum(values * w, dim=particle_dim)


__all__ = ["logsumexp", "logmeanexp", "normalize_log_weights", "ess",
           "weighted_expectation"]
