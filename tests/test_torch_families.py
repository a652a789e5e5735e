"""The port's model families (svol_t, poisson_ar, factor_svol, lgssm), the
rest of ``rv`` and the generic kernel's new instance hooks, against the
JAX package on identical inputs (made with seeded numpy).

Deterministic pieces are compared to float32 tolerance; samplers in
distribution.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu import rv as jrv
from ssme_tpu.models import factor_svol as jfac
from ssme_tpu.models import lgssm as jlg
from ssme_tpu.models import poisson_ar as jpois
from ssme_tpu.models import svol_t as jsvt
from ssme_tpu.ops import filter_megakernel as jfm
from ssme_tpu_torch import rv
from ssme_tpu_torch.models import factor_svol, lgssm, poisson_ar, svol_t
from ssme_tpu_torch.ops import filter_megakernel as fm

torch.set_num_threads(1)

RTOL = ATOL = 1e-5    # float32 densities: a few ulp of the larger terms
# densities with log-gamma terms: torch.lgamma and jax.scipy's gammaln
# are different float32 implementations (a few 1e-5 apart near 1-10)
LGAMMA_TOL = 2e-4


def _np(x):
    return np.asarray(x, np.float64)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# rv, the rest of it
# ---------------------------------------------------------------------------

def test_scalar_log_densities_match_jax(rng):
    x = rng.normal(size=64).astype(np.float32)
    u = rng.uniform(0.01, 0.99, size=64).astype(np.float32)
    ks = rng.poisson(3.0, size=64).astype(np.float32)
    lr = rng.normal(size=64).astype(np.float32)
    t = torch.from_numpy
    _close(rv.halfnorm_logpdf(t(x), 0.7), jrv.halfnorm_logpdf(x, 0.7))
    lg = dict(rtol=LGAMMA_TOL, atol=LGAMMA_TOL)
    _close(rv.beta_logpdf(t(u), 2.5, 0.7), jrv.beta_logpdf(u, 2.5, 0.7), **lg)
    _close(rv.beta_logpdf(t(x), 2.0, 3.0), jrv.beta_logpdf(x, 2.0, 3.0), **lg)
    _close(rv.poisson_logpmf(t(ks), t(lr)), jrv.poisson_logpmf(ks, lr), **lg)
    bad = np.array([-1.0, 2.5, 3.0], np.float32)
    _close(rv.poisson_logpmf(t(bad), 0.3), jrv.poisson_logpmf(bad, 0.3),
           **lg)
    for df in (0.7, 4.0, 150.0, 500.0, -1.0):
        _close(rv.t_logpdf(t(x), df, 0.2, 1.3),
               jrv.t_logpdf(x, df, 0.2, 1.3), **lg)
    # tensor df across the nu > 200 switch, and a non-positive scale
    dfs = np.array([3.0, 199.0, 201.0, 5e3], np.float32)
    _close(rv.t_logpdf(t(x[:4]), t(dfs)), jrv.t_logpdf(x[:4], dfs), **lg)
    _close(rv.t_logpdf(t(x[:4]), 5.0, 0.0, -1.0),
           jrv.t_logpdf(x[:4], 5.0, 0.0, -1.0))


def test_mvn_logpdf_matches_jax(rng):
    a = rng.normal(size=(3, 3))
    cov = (a @ a.T + 0.5 * np.eye(3)).astype(np.float32)
    mean = rng.normal(size=3).astype(np.float32)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    _close(rv.mvn_logpdf(torch.from_numpy(x), torch.from_numpy(mean),
                         torch.from_numpy(cov)),
           jax.vmap(lambda v: jrv.mvn_logpdf(v, mean, cov))(x), rtol=1e-4,
           atol=1e-4)


def test_categorical_and_gamma_samplers_in_distribution():
    gen = torch.Generator().manual_seed(3)
    logw = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    idx = rv.categorical_from_log_weights(gen, logw, (40000,))
    freq = torch.bincount(idx, minlength=4).double() / idx.numel()
    # binomial sd of a frequency at 40000 draws < 0.0025
    assert torch.allclose(freq, torch.tensor([0.1, 0.2, 0.3, 0.4]).double(),
                          atol=0.01)
    assert rv.categorical_from_log_weights(gen, torch.zeros(3, 5)).shape \
        == (3, 5)
    for alpha in (0.5, 2.5, 7.0):
        g = rv.gamma_sample(gen, torch.full((40000,), alpha)).double()
        assert bool((g > 0).all())
        # mean alpha and variance alpha: 5 standard errors
        assert abs(float(g.mean()) - alpha) < 5 * math.sqrt(alpha / 40000)
        assert abs(float(g.var()) / alpha - 1.0) < 0.06
    tdraw = rv.student_t_sample(gen, torch.full((40000,), 6.0)).double()
    assert abs(float(tdraw.mean())) < 0.03
    assert abs(float(tdraw.var()) - 1.5) < 0.12     # nu / (nu - 2)


# ---------------------------------------------------------------------------
# the model families against JAX, hook by hook
# ---------------------------------------------------------------------------

def _per_particle(fn, xs):
    """JAX hook of one particle over a (B, N, d) cloud."""
    return jax.vmap(jax.vmap(fn))(jnp.asarray(xs))


SVOL_T_P = np.array([1.1, 0.93, 0.05, 6.0], np.float32)
POIS_P = np.array([0.85, 0.7, 0.35], np.float32)
LG_P = np.array([0.9, 0.3, 0.6], np.float32)


@pytest.mark.parametrize("family", ["svol_t", "poisson_ar", "lgssm"])
def test_univariate_hooks_match_jax(family, rng):
    mod, jmod, p = {"svol_t": (svol_t, jsvt, SVOL_T_P),
                    "poisson_ar": (poisson_ar, jpois, POIS_P),
                    "lgssm": (lgssm, jlg, LG_P)}[family]
    model = mod.make_model()
    xs = rng.normal(size=(2, 16, 1)).astype(np.float32)
    xp = rng.normal(size=(2, 16, 1)).astype(np.float32)
    y = np.array([3.0 if family == "poisson_ar" else 0.7], np.float32)
    pt = torch.from_numpy(p)[None].expand(2, -1)
    jp = jnp.asarray(p)
    t = torch.from_numpy
    _close(model.log_g(pt, t(y), t(xs), None),
           _per_particle(lambda x: jmod.log_g(jp, y, x, None), xs))
    _close(model.log_mu(pt, t(xs)),
           _per_particle(lambda x: jmod.log_mu(jp, x), xs))
    _close(model.log_f(pt, t(xs), t(xp), None),
           jax.vmap(jax.vmap(lambda x, x0: jmod.log_f(jp, x, x0, None)))(
               xs, xp))
    _close(model.prop_mu(pt, t(xp), None),
           _per_particle(lambda x: jmod.prop_mu(jp, x, None), xp))
    # priors on draws from the port's prior, and outside the support
    draws = model.sample_prior(torch.Generator().manual_seed(1), (32,))
    assert draws.shape == (32, model.dim_param)
    _close(model.log_prior(draws), jax.vmap(jmod.log_prior)(draws.numpy()),
           rtol=1e-5, atol=1e-4)
    assert bool(torch.isfinite(model.log_prior(draws)).all())
    _close(model.transform.unconstrain(draws),
           jmod.make_model().transform.unconstrain(draws.numpy()),
           rtol=1e-5, atol=1e-4)


def test_svol_t_prior_support_is_a_device_side_where():
    p = torch.tensor([[1.0, 0.9, 0.05, -2.0], [1.0, 0.9, 0.05, 4.0]])
    lp = svol_t.log_prior(p)
    assert math.isinf(float(lp[0])) and math.isfinite(float(lp[1]))
    _close(lp, jax.vmap(jsvt.log_prior)(p.numpy()))


def test_prior_samplers_in_distribution():
    gen = torch.Generator().manual_seed(2)
    d = svol_t.sample_prior(gen, (40000,)).double()
    # beta ~ N(1, 1), phi ~ U(0, 1), ss ~ InvGamma(2, .2) (median
    # .2 / 1.678), nu ~ Exp(mean 10): 5-SE bands or quantile checks
    assert abs(float(d[:, 0].mean()) - 1.0) < 0.03
    assert abs(float(d[:, 1].mean()) - 0.5) < 0.01
    assert abs(float(d[:, 2].median()) - 0.2 / 1.678347) < 0.004
    assert abs(float(d[:, 3].mean()) - 10.0) < 0.25
    p = poisson_ar.sample_prior(gen, (40000,)).double()
    assert float(p[:, 0].min()) >= -0.99 and float(p[:, 0].max()) <= 0.99
    assert abs(float(p[:, 1].std()) - 2.0) < 0.04
    assert abs(float(p[:, 2].mean()) - 0.5 * math.sqrt(2 / math.pi)) < 0.01
    f = factor_svol.make_model(4, 2).sample_prior(gen, (40000,)).double()
    assert f.shape == (40000, 18)
    # d = 0.1 / Gamma(2): median 0.1 / 1.678
    assert abs(float(f[:, 14:].median()) - 0.1 / 1.678347) < 0.002


def test_simulators_run_and_have_the_models_shapes():
    gen = torch.Generator().manual_seed(4)
    xs, ys = svol_t.simulate(gen, SVOL_T_P, 50)
    assert xs.shape == ys.shape == (50, 1) and bool(torch.isfinite(ys).all())
    xs, ys = poisson_ar.simulate(gen, POIS_P, 50)
    assert bool((ys == torch.floor(ys)).all()) and bool((ys >= 0).all())
    model = factor_svol.make_model(3, 2)
    xs, ys = factor_svol.simulate(gen, model.sample_prior(gen), 40, 3, 2)
    assert xs.shape == (40, 2) and ys.shape == (40, 3)
    xs, ys = lgssm.simulate(gen, LG_P, 30)
    assert xs.shape == ys.shape == (30, 1)


@pytest.mark.parametrize("n_assets", [3, 4, 5])
def test_factor_hooks_match_jax(n_assets, rng):
    model = factor_svol.make_model(n_assets, 2)
    jmodel = jfac.make_model(n_assets, 2)
    p = np.asarray(jmodel.sample_prior(jax.random.key(n_assets)), np.float32)
    xs = rng.normal(size=(2, 16, 2)).astype(np.float32)
    xp = rng.normal(size=(2, 16, 2)).astype(np.float32)
    y = rng.normal(size=n_assets).astype(np.float32)
    pt = torch.from_numpy(p)[None].expand(2, -1)
    jp = jnp.asarray(p)
    t = torch.from_numpy
    # the Woodbury density in IEEE float32 (TF32 is off in the package)
    _close(model.log_g(pt, t(y), t(xs), None),
           _per_particle(lambda x: jmodel.log_g(jp, y, x, None), xs),
           rtol=2e-5, atol=2e-4)
    _close(model.log_mu(pt, t(xs)),
           _per_particle(lambda x: jmodel.log_mu(jp, x), xs))
    _close(model.log_f(pt, t(xs), t(xp), None),
           jax.vmap(jax.vmap(lambda x, x0: jmodel.log_f(jp, x, x0, None)))(
               xs, xp))
    _close(model.prop_mu(pt, t(xp), None),
           _per_particle(lambda x: jmodel.prop_mu(jp, x, None), xp))
    _close(model.log_prior(t(p)), jmodel.log_prior(jp), atol=1e-4)
    assert model.transform.names == jmodel.transform.names
    assert model.name == jmodel.name


def test_kalman_filter_and_smoother_match_jax():
    _, ys = jlg.simulate(jax.random.key(0), jnp.asarray(LG_P), 60)
    ys = np.asarray(ys, np.float32)
    for got, want in zip(lgssm.kalman_filter(torch.from_numpy(LG_P),
                                             torch.from_numpy(ys)),
                         jlg.kalman_filter(jnp.asarray(LG_P), ys)):
        _close(got, want, rtol=1e-5, atol=1e-5)
    for got, want in zip(lgssm.kalman_smoother(torch.from_numpy(LG_P),
                                               torch.from_numpy(ys)),
                         jlg.kalman_smoother(jnp.asarray(LG_P), ys)):
        _close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the generic kernel's new instances: hooks against the JAX instances and
# the JAX models, and the row helpers
# ---------------------------------------------------------------------------

def _rows8(p):
    return np.tile(np.asarray(p, np.float32)[None], (8, 1))


def test_svol_t_param_rows_match_jax():
    p = np.array([[1.2, 0.9, 0.04, 5.0], [0.8, 0.97, 0.06, 150.0],
                  [1.0, 0.5, 0.2, 250.0], [1.0, 0.5, 0.2, 0.3]], np.float32)
    _close(fm.svol_t_param_rows(torch.from_numpy(p)),
           jfm.svol_t_param_rows(p), rtol=LGAMMA_TOL, atol=LGAMMA_TOL)


def test_poisson_obs_rows_match_jax():
    counts = np.array([0, 1, 4, 17, 250], np.float32)
    _close(fm.poisson_obs_rows(torch.from_numpy(counts)),
           jfm.poisson_obs_rows(counts), rtol=LGAMMA_TOL, atol=LGAMMA_TOL)


def test_instance_hooks_match_the_jax_instances(rng):
    """Each new instance's hooks against the JAX instance's on identical
    inputs (same clouds, parameter rows and observations)."""
    cases = [
        (fm.svol_t_kernel_model(), jfm.svol_t_kernel_model(),
         np.asarray(jfm.svol_t_param_rows(_rows8(SVOL_T_P))), (0.7,)),
        (fm.poisson_ar_kernel_model(), jfm.poisson_ar_kernel_model(),
         _rows8(POIS_P), tuple(np.asarray(jfm.poisson_obs_rows(
             np.array([4.0], np.float32)))[0])),
    ]
    for n_assets in (3, 4, 5):
        jp = jfac.make_model(n_assets, 2).sample_prior(jax.random.key(7))
        cases.append((fm.factor_svol_kernel_model(n_assets),
                      jfm.factor_svol_kernel_model(n_assets), _rows8(jp),
                      tuple(rng.normal(size=n_assets).astype(np.float32))))
    for km, jkm, rows, y in cases:
        assert (km.num_params, km.num_state, km.dim_obs, km.dim_cov) == (
            jkm.num_params, jkm.num_state, jkm.dim_obs, jkm.dim_cov)
        assert (km.prop_mu is None) == (jkm.prop_mu is None)
        state = tuple(rng.normal(size=(8, 16)).astype(np.float32)
                      for _ in range(km.num_state))
        pt = torch.from_numpy(np.asarray(rows, np.float32))
        st = tuple(torch.from_numpy(s) for s in state)
        yt = tuple(torch.tensor(v) for v in y)
        _close(km.log_weight(pt, st, yt, ()),
               jkm.log_weight(jnp.asarray(rows), state, y, ()),
               rtol=2e-5, atol=2e-4)
        if km.prop_mu is not None:
            for a, b in zip(km.prop_mu(pt, st, yt, ()),
                            jkm.prop_mu(jnp.asarray(rows), state, y, ())):
                _close(a, b)
        for a, b in zip(km.functional_list, jkm.functional_list):
            _close(a(pt, st), b(jnp.asarray(rows), state))


@pytest.mark.parametrize("n_assets", [4, 5])
def test_factor_instance_woodbury_matches_the_general_log_g(n_assets, rng):
    """The explicit 2 x 2 Woodbury of the instance against the JAX
    model's general log_g (2e-4, as the JAX package's own test) and the
    port model's."""
    jmodel = jfac.make_model(n_assets, 2)
    p = np.asarray(jmodel.sample_prior(jax.random.key(0)), np.float32)
    km = fm.factor_svol_kernel_model(n_assets)
    x1 = rng.normal(size=(8, 16)).astype(np.float32)
    x2 = rng.normal(size=(8, 16)).astype(np.float32)
    y = rng.normal(size=n_assets).astype(np.float32)
    got = km.log_weight(torch.from_numpy(_rows8(p)),
                        (torch.from_numpy(x1), torch.from_numpy(x2)),
                        tuple(torch.from_numpy(y)), ())
    want = jax.vmap(jax.vmap(lambda a, b: jmodel.log_g(
        jnp.asarray(p), y, jnp.stack([a, b]), None)))(x1, x2)
    _close(got, want, rtol=2e-4, atol=2e-4)
    port = factor_svol.make_model(n_assets, 2).log_g(
        torch.from_numpy(_rows8(p)), torch.from_numpy(y),
        torch.from_numpy(np.stack([x1, x2], -1)), None)
    _close(got, port, rtol=2e-4, atol=2e-4)


def test_svol_t_and_poisson_instances_match_their_models(rng):
    x = rng.normal(size=(8, 16)).astype(np.float32)
    p4 = torch.from_numpy(_rows8(SVOL_T_P))
    lw = fm.svol_t_kernel_model().log_weight(fm.svol_t_param_rows(p4),
                                             (torch.from_numpy(x),),
                                             (torch.tensor(0.7),), ())
    ref = svol_t.log_g(p4, torch.tensor([0.7]), torch.from_numpy(x)[..., None],
                       None)
    _close(lw, ref, rtol=1e-4, atol=1e-4)
    counts = torch.tensor([4.0])
    row = fm.poisson_obs_rows(counts)[0]
    lw = fm.poisson_ar_kernel_model().log_weight(
        torch.from_numpy(_rows8(POIS_P)), (torch.from_numpy(x),),
        tuple(row), ())
    ref = poisson_ar.log_g(torch.from_numpy(_rows8(POIS_P)), counts,
                           torch.from_numpy(x)[..., None], None)
    _close(lw, ref)
