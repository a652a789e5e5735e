"""The port's foundations against the JAX package on identical inputs:
utils, transforms, log-densities, chol_with_jitter and the SVOL hooks.

Tolerance: 1e-5 relative (both sides float32; the two libraries' log,
exp, lgamma and softplus differ by a few ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu import rv as jrv
from ssme_tpu import transforms as jtr
from ssme_tpu import utils as jutils
from ssme_tpu.models import svol as jsvol
from ssme_tpu_torch import rv, transforms, utils
from ssme_tpu_torch.models import svol

torch.set_num_threads(1)
RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.fixture
def logw():
    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 3.0, (5, 64)).astype(np.float32)
    x[1, :] = -np.inf
    x[2, 10:] = -np.inf
    return x


@pytest.mark.parametrize("fn", ["logsumexp", "logmeanexp", "ess",
                                "normalize_log_weights"])
def test_utils_match_jax(logw, fn):
    got = getattr(utils, fn)(torch.from_numpy(logw))
    want = getattr(jutils, fn)(jnp.asarray(logw))
    if fn in ("ess", "normalize_log_weights"):
        got, want = np.asarray(got)[[0, 2, 3, 4]], np.asarray(want)[[0, 2, 3, 4]]
    _close(got, want)


def test_logsumexp_all_neg_inf_is_neg_inf(logw):
    assert utils.logsumexp(torch.from_numpy(logw))[1] == -np.inf


def test_weighted_expectation_matches_jax():
    rng = np.random.default_rng(1)
    lw = rng.normal(size=64).astype(np.float32)
    vals = rng.normal(size=(64, 3)).astype(np.float32)
    _close(utils.weighted_expectation(torch.from_numpy(vals),
                                      torch.from_numpy(lw)),
           jutils.weighted_expectation(jnp.asarray(vals), jnp.asarray(lw)))
    # a constant functional returns the constant exactly (the 42 invariant)
    assert torch.allclose(utils.weighted_expectation(
        torch.full((64, 1), 42.0), torch.from_numpy(lw)), torch.tensor(42.0))


NAMES = ("null", "log", "logit", "twice_fisher")
TRANS_VALS = np.array([1.0, -1.3, 9.5, 0.89], dtype=np.float32)


def test_transforms_golden_log_jacobian():
    pt = transforms.ParamTransform(NAMES)
    lj = pt.log_det_jacobian(torch.from_numpy(TRANS_VALS))
    assert abs(float(lj) - (-11.6851)) < 1e-3
    _close(pt.constrain(torch.from_numpy(TRANS_VALS)),
           [1.0, 0.2725318, 0.9999252, 0.4177803], atol=1e-4)


@pytest.mark.parametrize("op", ["constrain", "unconstrain",
                                "log_det_jacobian"])
def test_transforms_match_jax(op):
    rng = np.random.default_rng(2)
    z = rng.normal(0.0, 2.0, (32, 4)).astype(np.float32)
    if op == "unconstrain":   # constrained values inside each domain
        z = np.stack([z[:, 0], np.exp(z[:, 1]), rng.uniform(0.01, 0.99, 32),
                      rng.uniform(-0.99, 0.99, 32)], -1).astype(np.float32)
    got = getattr(transforms.ParamTransform(NAMES), op)(torch.from_numpy(z))
    want = getattr(jtr.ParamTransform(NAMES), op)(jnp.asarray(z))
    _close(got, want)


def test_unknown_transform_raises():
    with pytest.raises(ValueError):
        transforms.ParamTransform(("null", "sqrt"))


@pytest.mark.parametrize("case", ["norm", "uniform", "invgamma",
                                  "twice_fisher"])
def test_rv_logpdfs_match_jax(case):
    rng = np.random.default_rng(3)
    x = rng.normal(0.0, 1.5, 200).astype(np.float32)
    xt = torch.from_numpy(x)
    if case == "norm":
        sig = np.abs(rng.normal(size=200)).astype(np.float32)
        sig[:5] = 0.0                      # out of domain: -inf
        got = rv.norm_logpdf(xt, 0.3, torch.from_numpy(sig))
        want = jrv.norm_logpdf(jnp.asarray(x), 0.3, jnp.asarray(sig))
    elif case == "uniform":
        got = rv.uniform_logpdf(xt, -1.0, 2.0)
        want = jrv.uniform_logpdf(jnp.asarray(x), -1.0, 2.0)
    elif case == "invgamma":
        got = rv.invgamma_logpdf(xt, 1e-3, 1e-3)
        want = jrv.invgamma_logpdf(jnp.asarray(x), 1e-3, 1e-3)
    else:
        x = np.clip(x, -0.99, 0.99)
        got = rv.twice_fisher(torch.from_numpy(x))
        want = jrv.twice_fisher(jnp.asarray(x))
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])


def test_chol_with_jitter_matches_jax_and_nans_on_non_pd():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(6, 3, 3)).astype(np.float32)
    cov = a @ np.transpose(a, (0, 2, 1)) + 0.1 * np.eye(3, dtype=np.float32)
    cov[5] = np.diag([1.0, -2.0, 1.0]).astype(np.float32)   # not PD
    got = np.asarray(rv.chol_with_jitter(torch.from_numpy(cov)))
    want = np.stack([np.asarray(jrv.chol_with_jitter(jnp.asarray(c)))
                     for c in cov])
    _close(got[:5], want[:5], atol=1e-5)
    assert np.isnan(got[5]).any() and np.isnan(want[5]).any()


def test_mvn_sample_uses_the_factor():
    gen = torch.Generator().manual_seed(0)
    chol = torch.tensor([[2.0, 0.0], [1.0, 0.5]])
    draws = rv.mvn_sample(gen, torch.zeros(20000, 2), chol=chol)
    emp = torch.cov(draws.T)
    torch.testing.assert_close(emp, chol @ chol.T, rtol=0.05, atol=0.05)


def test_svol_hooks_match_jax():
    rng = np.random.default_rng(5)
    params = np.array([0.9, 0.95, 0.04], np.float32)
    x = rng.normal(size=(16, 1)).astype(np.float32)
    xp = rng.normal(size=(16, 1)).astype(np.float32)
    y = np.array([0.7], np.float32)
    pt, xt, xpt, yt = (torch.from_numpy(v) for v in (params, x, xp, y))
    jm = jsvol.make_model()
    for name, got, want in [
        ("log_mu", svol.log_mu(pt, xt),
         [jm.log_mu(jnp.asarray(params), jnp.asarray(r)) for r in x]),
        ("log_q1", svol.log_q1(pt, xt, yt),
         [jm.log_q1(jnp.asarray(params), jnp.asarray(r), y) for r in x]),
        ("log_g", svol.log_g(pt, yt, xt, None),
         [jm.log_g(jnp.asarray(params), y, jnp.asarray(r), None)
          for r in x]),
        ("log_f", svol.log_f(pt, xt, xpt, None),
         [jm.log_f(jnp.asarray(params), jnp.asarray(r), jnp.asarray(q),
                   None) for r, q in zip(x, xp)]),
    ]:
        _close(got, np.asarray(want))
    thetas = np.array([[1.0, 0.5, 2e-4], [0.8, 1.5, 0.1], [-0.2, 0.9, 0.3],
                       [1.0, 0.5, -1.0]], np.float32)
    got = np.asarray(svol.log_prior(torch.from_numpy(thetas)))
    want = np.asarray([jsvol.log_prior(jnp.asarray(t)) for t in thetas])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])
    assert svol.make_model().dim_param == 3
    np.testing.assert_allclose(svol.START_TRANS_THETA,
                               jsvol.START_TRANS_THETA)


@pytest.mark.parametrize("kind", ["multinomial", "systematic",
                                  "stratified"])
def test_resampling_frequencies_follow_the_weights(kind):
    from ssme_tpu_torch import resampling

    gen = torch.Generator().manual_seed(6)
    w = torch.linspace(1.0, 3.0, 32)
    lw = torch.log(w).expand(400, 32)            # 400 filter rows at once
    idx = resampling.ancestor_indices(gen, lw, kind=kind)
    freq = torch.bincount(idx.ravel(), minlength=32).double() / idx.numel()
    # 12800 draws: se(freq) <= sqrt(p / 12800) ~ 1.6e-3 at p ~ 1/32
    torch.testing.assert_close(freq, (w / w.sum()).double(), rtol=0,
                               atol=8e-3)


def test_maybe_resample_moves_only_flagged_rows_jointly():
    from ssme_tpu_torch import resampling

    gen = torch.Generator().manual_seed(7)
    lw = torch.randn(3, 16, generator=gen)
    ids = torch.arange(16.0).expand(3, 16).clone()
    vals = torch.randn(3, 16, 2, generator=gen)
    (pid, pv), new_lw = resampling.maybe_resample(
        gen, lw, (ids, vals), torch.tensor([True, False, True]))
    assert torch.equal(pid[1], ids[1]) and torch.equal(new_lw[1], lw[1])
    assert (new_lw[[0, 2]] == 0).all()
    anc = pid.long()
    assert torch.equal(pv, torch.gather(vals, 1, anc[..., None].expand(
        3, 16, 2)))
