"""Particle resampling: multinomial / systematic / stratified.

PyTorch counterpart of ``ssme_tpu/resampling.py``.  Log-weights are
(..., N) with any leading batch shape (one filter per row); each kernel
returns ancestor indices (..., M), and ``resample``/``maybe_resample``
gather every leaf of a tuple along the particle axis with the SAME
indices (joint state + parameter resampling).
"""

from __future__ import annotations

import torch

from ssme_tpu_torch.utils import normalize_log_weights


def _weight_cdf(log_weights):
    cdf = torch.cumsum(normalize_log_weights(log_weights, dim=-1), dim=-1)
    # force the last entry to exactly 1 so u < 1 never falls past it
    return cdf / cdf[..., -1:]


def searchsorted_cdf(cdf, u):
    """First i with cdf[i] >= u (``side='left'``), clipped to [0, N-1]."""
    n = cdf.shape[-1]
    if u.ndim < cdf.ndim:
        u = torch.broadcast_to(u, cdf.shape[:-1] + u.shape[-1:])
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), side="left")
    return torch.clamp(idx, max=n - 1)


def _uniform(gen, shape, like):
    return torch.rand(shape, generator=gen, dtype=like.dtype,
                      device=like.device)


def multinomial_indices(gen, log_weights, num_samples=None):
    """IID ancestors via sorted exponential spacings; returns sorted
    indices (exchangeable, so statistically identical)."""
    batch, n = log_weights.shape[:-1], log_weights.shape[-1]
    m = n if num_samples is None else num_samples
    e = -torch.log1p(-_uniform(gen, batch + (m + 1,), log_weights))
    g = torch.cumsum(e, dim=-1)
    sorted_u = g[..., :-1] / g[..., -1:]
    return searchsorted_cdf(_weight_cdf(log_weights), sorted_u)


def systematic_indices(gen, log_weights, num_samples=None):
    """Systematic resampling: one uniform offset per filter row."""
    batch, n = log_weights.shape[:-1], log_weights.shape[-1]
    m = n if num_samples is None else num_samples
    u0 = _uniform(gen, batch + (1,), log_weights)
    grid = (torch.arange(m, dtype=log_weights.dtype,
                         device=log_weights.device) + u0) / m
    return searchsorted_cdf(_weight_cdf(log_weights), grid)


def stratified_indices(gen, log_weights, num_samples=None):
    """Stratified resampling: one uniform per stratum."""
    batch, n = log_weights.shape[:-1], log_weights.shape[-1]
    m = n if num_samples is None else num_samples
    u = _uniform(gen, batch + (m,), log_weights)
    grid = (torch.arange(m, dtype=log_weights.dtype,
                         device=log_weights.device) + u) / m
    return searchsorted_cdf(_weight_cdf(log_weights), grid)


_KINDS = {
    "multinomial": multinomial_indices,
    "systematic": systematic_indices,
    "stratified": stratified_indices,
}


def ancestor_indices(gen, log_weights, kind="systematic", num_samples=None):
    try:
        fn = _KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown resampler kind {kind!r}; "
                         f"valid: {sorted(_KINDS)}") from None
    return fn(gen, log_weights, num_samples)


def _gather(leaf, idx):
    """Gather (..., N, *event) along the particle axis by (..., M)."""
    pdim = idx.ndim - 1
    extra = leaf.ndim - idx.ndim
    index = idx.reshape(idx.shape + (1,) * extra).expand(
        idx.shape + leaf.shape[pdim + 1:])
    return torch.gather(leaf, pdim, index)


def resample(gen, log_weights, tree, kind="systematic"):
    """Jointly resample every (..., N, ...) leaf of ``tree`` (a tuple)
    and reset the log-weights to zero."""
    idx = ancestor_indices(gen, log_weights, kind=kind)
    return (tuple(_gather(a, idx) for a in tree),
            torch.zeros_like(log_weights))


def maybe_resample(gen, log_weights, tree, do_resample, kind="systematic"):
    """Branch-free conditional resample; ``do_resample`` is a bool tensor
    of the batch shape (...,) or a Python bool.  For a tensor, random
    numbers are drawn whether or not a row resamples, so the stream never
    depends on the weights (and the host never waits for them)."""
    if isinstance(do_resample, bool):
        if not do_resample:
            return tuple(tree), log_weights
        return resample(gen, log_weights, tree, kind=kind)
    idx = ancestor_indices(gen, log_weights, kind=kind)
    do = torch.broadcast_to(do_resample, log_weights.shape[:-1])
    n = log_weights.shape[-1]
    ident = torch.arange(n, device=idx.device).expand_as(idx)
    idx = torch.where(do[..., None], idx, ident)
    new_logw = torch.where(do[..., None], torch.zeros_like(log_weights),
                           log_weights)
    return tuple(_gather(a, idx) for a in tree), new_logw


__all__ = [
    "searchsorted_cdf",
    "multinomial_indices", "systematic_indices", "stratified_indices",
    "ancestor_indices", "resample", "maybe_resample",
]
