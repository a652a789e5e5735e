"""The port's fixed-lag particle smoother
(``ssme_tpu_torch/filters/smoothing.py``) against the exact Kalman filter
and RTS smoother of the port's ``models/lgssm.py``, with the seven cases
and tolerances of ``tests/test_smoothing.py`` at its sizes (T=120, N=4096,
lag 8: the tolerances are Monte-Carlo errors at N=4096, and the port runs
it in well under a second), then against the JAX package's smoother on
the same numpy-made series, in distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu.filters import fixed_lag_smoother as jax_smoother
from ssme_tpu.models import lgssm as jlg
from ssme_tpu_torch.filters import fixed_lag_smoother
from ssme_tpu_torch.models import lgssm

torch.set_num_threads(1)

PARAMS = (0.8, 0.5, 0.7)  # (a, q, r): mixes fast, obs informative
T = 120
LAG = 8
N = 4096


def _simulate(seed, t_len, params=PARAMS):
    """(T, 1) float32 observations of the LGSSM, made with numpy."""
    a, q, r = params
    rng = np.random.default_rng(seed)
    x = rng.normal() * q / np.sqrt(1.0 - a * a)
    ys = np.empty((t_len, 1), np.float32)
    for t in range(t_len):
        if t:
            x = a * x + q * rng.normal()
        ys[t, 0] = x + r * rng.normal()
    return ys


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def fixture():
    ys = _simulate(7, T)
    smooth = fixed_lag_smoother(lgssm.make_model(), num_particles=N,
                                lag=LAG)
    smoothed, filtered, ll = smooth(_gen(3), torch.tensor(PARAMS),
                                    torch.from_numpy(ys))
    return ys, smoothed.numpy(), filtered.numpy(), float(ll)


def test_shapes_and_finiteness(fixture):
    ys, smoothed, filtered, ll = fixture
    assert smoothed.shape == (T, 1)
    assert filtered.shape == (T, 1)
    assert np.all(np.isfinite(smoothed))
    assert np.all(np.isfinite(filtered))
    assert np.isfinite(ll)


def test_filtered_means_match_kalman(fixture):
    ys, _, filtered, _ = fixture
    _, kf_means, _ = lgssm.kalman_filter(torch.tensor(PARAMS),
                                         torch.from_numpy(ys))
    err = np.abs(filtered[:, 0] - kf_means.numpy())
    # MC error of a 4096-particle weighted mean on an O(1)-variance state
    assert float(np.max(err)) < 0.12
    assert float(np.mean(err)) < 0.03


def test_smoothed_means_match_rts(fixture):
    """Lag 8 at a=0.8 retains a^L ~ 0.17 of the missing future info:
    interior estimates (full lag available) sit on the RTS curve within
    MC + truncation tolerance, and closer than the filtered means."""
    ys, smoothed, filtered, _ = fixture
    rts_means, _ = lgssm.kalman_smoother(torch.tensor(PARAMS),
                                         torch.from_numpy(ys))
    rts = rts_means.numpy()
    interior = slice(0, T - LAG)  # entries with the full lag of future obs
    err_sm = np.abs(smoothed[interior, 0] - rts[interior])
    err_filt = np.abs(filtered[interior, 0] - rts[interior])
    assert float(np.mean(err_sm)) < 0.05
    assert float(np.max(err_sm)) < 0.25
    assert float(np.mean(err_sm)) < 0.5 * float(np.mean(err_filt))


def test_tail_uses_available_future(fixture):
    """The last entry has no future: it equals the filtered mean (same
    weights, same particles)."""
    ys, smoothed, filtered, _ = fixture
    np.testing.assert_allclose(smoothed[-1], filtered[-1], rtol=1e-5,
                               atol=1e-6)


def test_short_series_lag_exceeds_t():
    """T <= lag runs the all-tail assembly branch."""
    ys = torch.from_numpy(_simulate(11, 5))
    smooth = fixed_lag_smoother(lgssm.make_model(), num_particles=512,
                                lag=8)
    smoothed, filtered, ll = smooth(_gen(1), torch.tensor(PARAMS), ys)
    assert smoothed.shape == (5, 1)
    assert filtered.shape == (5, 1)
    assert torch.isfinite(smoothed).all()
    rts, _ = lgssm.kalman_smoother(torch.tensor(PARAMS), ys)
    err = (smoothed[:, 0] - rts).abs()
    assert float(err.max()) < 0.3


def test_log_likelihood_matches_kalman(fixture):
    ys, _, _, ll = fixture
    kf_lls, _, _ = lgssm.kalman_filter(torch.tensor(PARAMS),
                                       torch.from_numpy(ys))
    assert abs(ll - float(kf_lls.sum())) < 1.5


def test_lag_validation():
    with pytest.raises(ValueError, match="lag"):
        fixed_lag_smoother(lgssm.make_model(), num_particles=64, lag=0)


def test_covariate_model_needs_zs():
    model = lgssm.make_model().replace(dim_cov=1)
    smooth = fixed_lag_smoother(model, num_particles=16, lag=2)
    with pytest.raises(ValueError, match="covariates"):
        smooth(_gen(0), torch.tensor(PARAMS), torch.zeros(4, 1))


# the JAX comparison: R independent smoothers a side on one series
R, T_JAX, N_JAX, LAG_JAX = 8, 100, 256, 6


def test_smoothed_means_agree_with_jax_in_distribution():
    """R replicate smoothers each (the port's as one batch of R parameter
    rows, JAX's vmapped over R keys) on one numpy-made series: per time,
    the two replicate means of the smoothed state differ by less than 4
    combined standard errors at 95% of the times; the series-averaged
    smoothed state and the log-likelihood (one value a replicate) within
    4 combined standard errors."""
    ys = _simulate(21, T_JAX)
    smooth = fixed_lag_smoother(lgssm.make_model(), num_particles=N_JAX,
                                lag=LAG_JAX)
    params = torch.tensor(PARAMS).expand(R, 3)
    sm_t, _, ll_t = smooth(_gen(5), params, torch.from_numpy(ys))
    sm_t, ll_t = sm_t[..., 0].numpy(), ll_t.numpy()
    jsmooth = jax_smoother(jlg.make_model(), num_particles=N_JAX,
                           lag=LAG_JAX)
    sm_j, _, ll_j = jax.jit(jax.vmap(jsmooth, in_axes=(0, None, None)))(
        jax.random.split(jax.random.key(5), R), jnp.asarray(PARAMS),
        jnp.asarray(ys))
    sm_j, ll_j = np.asarray(sm_j)[..., 0], np.asarray(ll_j)
    assert sm_t.shape == sm_j.shape == (R, T_JAX)

    def four_se(a, b, axis=0):
        return 4.0 * np.sqrt(a.var(axis=axis, ddof=1) / a.shape[axis]
                             + b.var(axis=axis, ddof=1) / b.shape[axis])

    per_t = np.abs(sm_t.mean(0) - sm_j.mean(0)) < four_se(sm_t, sm_j)
    assert per_t.mean() >= 0.95, per_t.mean()
    avg_t, avg_j = sm_t.mean(1), sm_j.mean(1)
    assert abs(avg_t.mean() - avg_j.mean()) < four_se(avg_t, avg_j)
    assert abs(ll_t.mean() - ll_j.mean()) < four_se(ll_t, ll_j)
