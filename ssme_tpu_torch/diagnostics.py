"""MCMC convergence diagnostics for PMMH output.

The reference tracks only a moving-average acceptance rate
(``ada_pmmh_mvn.h:351,356``) and leaves ESS as an unimplemented TODO
(``liu_west_filter.h:1568-1571``).  With batched chains as a first-class
axis (``inference/pmmh.py``), cross-chain diagnostics become meaningful:
this module provides split-R̂ and autocorrelation ESS in the
Vehtari-Gelman-Simpson-Carpenter-Bürkner (2021) / Stan formulation.

Host-side numpy on purpose: diagnostics run once on (iters, chains, dim)
posterior draws after sampling, not in the hot path.  A copy of
``ssme_tpu/diagnostics.py`` for the port, which cannot import jax.
"""

from __future__ import annotations

import numpy as np

__all__ = ["split_rhat", "ess", "summarize"]


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(n, m) -> (n//2, 2m): each chain split into halves."""
    n = x.shape[0] // 2 * 2
    x = x[:n]
    half = n // 2
    return np.concatenate([x[:half], x[half:]], axis=1)


def _rhat_1d(x: np.ndarray) -> float:
    """Split-R̂ of draws (n_iters, n_chains) for one scalar quantity."""
    x = _split_chains(np.asarray(x, np.float64))
    n, m = x.shape
    if n < 4:
        return np.nan
    chain_means = x.mean(axis=0)
    chain_vars = x.var(axis=0, ddof=1)
    w = chain_vars.mean()
    b = n * chain_means.var(ddof=1)
    var_plus = (n - 1) / n * w + b / n
    if w <= 0:
        return 1.0 if var_plus <= 0 else np.inf
    return float(np.sqrt(var_plus / w))


def _autocov_fft(x: np.ndarray) -> np.ndarray:
    """Per-chain autocovariance (biased, as Stan) via FFT.
    x: (n, m) -> (n, m)."""
    n = x.shape[0]
    xc = x - x.mean(axis=0, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, size, axis=0)
    acov = np.fft.irfft(f * np.conj(f), size, axis=0)[:n].real
    return acov / n


def _ess_1d(x: np.ndarray) -> float:
    """Autocorrelation ESS of draws (n_iters, n_chains), split chains,
    Geyer initial-monotone truncation (Stan's algorithm)."""
    x = _split_chains(np.asarray(x, np.float64))
    n, m = x.shape
    if n < 4:
        return np.nan
    chain_vars = x.var(axis=0, ddof=1)
    w = chain_vars.mean()
    b = n * x.mean(axis=0).var(ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * w + b / n
    if var_plus <= 0 or not np.isfinite(var_plus):
        return np.nan

    acov = _autocov_fft(x).mean(axis=1)       # combined autocovariance
    rho = 1.0 - (w - acov) / var_plus         # Stan eq: cross-chain rho_t
    rho[0] = 1.0

    # Geyer initial positive sequence: pairs G_k = rho_{2k} + rho_{2k+1}
    # kept while positive (guaranteed positive in expectation for
    # reversible chains), then made monotone non-increasing; the
    # truncated sum estimates tau = sum_t rho_t over all integer t
    # = 2 * sum_k G_k - 1.
    pair_sums = []
    t = 0
    while t + 1 < n:
        g = rho[t] + rho[t + 1]
        if g <= 0:
            break
        pair_sums.append(g)
        t += 2
    if pair_sums:
        ps = np.minimum.accumulate(pair_sums)
        tau = 2.0 * float(np.sum(ps)) - 1.0
    else:
        tau = 1.0
    ess_val = m * n / max(tau, 1.0 / (m * n))
    # cap at m*n*log10(m*n) against antithetic super-efficiency (Stan)
    if m * n > 10:
        ess_val = min(ess_val, m * n * np.log10(m * n))
    return float(ess_val)


def _apply_per_dim(fn, samples: np.ndarray) -> np.ndarray:
    s = np.asarray(samples)
    if s.ndim == 1:
        s = s[:, None, None]
    elif s.ndim == 2:
        s = s[:, :, None]
    out = np.array([fn(s[:, :, d]) for d in range(s.shape[2])])
    return out


def split_rhat(samples) -> np.ndarray:
    """Split-R̂ per parameter.

    ``samples``: (n_iters, n_chains, dim) (or (n_iters, n_chains) /
    (n_iters,)).  Values near 1.0 (< ~1.01) indicate convergence.
    """
    return _apply_per_dim(_rhat_1d, samples)


def ess(samples) -> np.ndarray:
    """Bulk effective sample size per parameter (same shapes as
    :func:`split_rhat`).  Implements the reference's unimplemented ESS
    TODO (``liu_west_filter.h:1568-1571``) for the MCMC axis; the
    particle-weight ESS lives in ``ssme_tpu_torch.utils.ess``.
    """
    return _apply_per_dim(_ess_1d, samples)


def summarize(samples, names=None) -> dict:
    """Posterior summary: mean, sd, 5/50/95%, split-R̂, ESS per parameter.

    ``samples``: (n_iters, n_chains, dim) constrained draws.  Returns
    ``{name: {mean, sd, q5, median, q95, rhat, ess}}``.
    """
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[:, :, None]
    dim = s.shape[2]
    names = names or [f"theta[{i}]" for i in range(dim)]
    rhats = split_rhat(s)
    esses = ess(s)
    # float64 before reducing: numpy's f32 reductions over ~1e5+ MCMC
    # draws can accumulate naively along strided axes (a running sum of
    # n * theta has ulp ~ n * theta * 2^-24 — measured 2.3e-3 of bias
    # on a 5e5-draw phi mean in the round-4 accuracy gate)
    flat = s.reshape(-1, dim).astype(np.float64)
    out = {}
    for i, name in enumerate(names):
        q5, med, q95 = np.percentile(flat[:, i], [5.0, 50.0, 95.0])
        out[name] = {
            "mean": float(flat[:, i].mean()),
            "sd": float(flat[:, i].std(ddof=1)),
            "q5": float(q5), "median": float(med), "q95": float(q95),
            "rhat": float(rhats[i]), "ess": float(esses[i]),
        }
    return out
