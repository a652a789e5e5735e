"""Model hooks the port had left out: univariate SVOL's ``sample_prior``
(``ssme_tpu/models/svol.py:97-105``) and ``StateSpaceModel.replace``
(``ssme_tpu/models/base.py:107``), held to the JAX package."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu.filters import LiuWestFilter as JaxLiuWestFilter
from ssme_tpu.models import svol as jsvol
from ssme_tpu_torch.filters import LiuWestFilter
from ssme_tpu_torch.inference import SwarmFilter
from ssme_tpu_torch.models import svol, svol_leverage

torch.set_num_threads(1)
DRAWS = 40000


@pytest.fixture(scope="module")
def prior_draws():
    """(JAX draws, port draws), (DRAWS, 3) float32 each."""
    keys = jax.random.split(jax.random.key(0), DRAWS)
    want = np.asarray(jax.jit(jax.vmap(jsvol.sample_prior))(keys))
    got = svol.sample_prior(torch.Generator().manual_seed(0), (DRAWS,))
    return want, got.numpy()


def _se(a, b):
    return math.sqrt(a.var() / a.size + b.var() / b.size)


def test_svol_prior_matches_jax_in_distribution(prior_draws):
    """beta ~ 1 + N(0, 1) and phi ~ U(0, 1): means and variances within 4
    combined standard errors; ss = 1e-3 / Gamma(1e-3): the share of +inf
    (the float32 Gamma draw flushed to 0) and, on the finite draws, the
    mean and sd of log ss within 4 SE."""
    want, got = prior_draws
    assert got.dtype == np.float32 and got.shape == (DRAWS, 3)
    for k in (0, 1):
        a, b = got[:, k].astype(np.float64), want[:, k].astype(np.float64)
        assert abs(a.mean() - b.mean()) < 4 * _se(a, b), k
        a2, b2 = (a - a.mean()) ** 2, (b - b.mean()) ** 2
        assert abs(a2.mean() - b2.mean()) < 4 * _se(a2, b2), k
    assert ((got[:, 1] > 0) & (got[:, 1] < 1)).all()
    inf_got, inf_want = np.isinf(got[:, 2]), np.isinf(want[:, 2])
    assert not np.isnan(got[:, 2]).any() and (got[:, 2] > 0).all()
    p = inf_want.mean()
    assert 0.85 < p < 0.95
    assert abs(inf_got.mean() - p) < 4 * math.sqrt(2 * p * (1 - p) / DRAWS)
    a = np.log(got[~inf_got, 2].astype(np.float64))
    b = np.log(want[~inf_want, 2].astype(np.float64))
    assert abs(a.mean() - b.mean()) < 4 * _se(a, b)
    a2, b2 = (a - a.mean()) ** 2, (b - b.mean()) ** 2
    assert abs(a2.mean() - b2.mean()) < 4 * _se(a2, b2)
    # the smallest finite ss is 1e-3 over the largest Gamma draw, the
    # largest 1e-3 over the smallest normal float32
    assert a.max() <= math.log(1e-3 / np.finfo(np.float32).tiny) + 1e-3
    assert np.isfinite(svol.log_prior(torch.from_numpy(
        got[~inf_got])).numpy()).all()


def test_svol_prior_shapes_and_the_swarm_draws_from_it():
    """The swarm draws each model's parameters from the prior when no
    draws are given (the port raised there before)."""
    gen = torch.Generator().manual_seed(3)
    assert svol.sample_prior(gen).shape == (3,)
    assert svol.sample_prior(gen, (2, 5)).shape == (2, 5, 3)
    sw = SwarmFilter(svol.make_model(), 32, 6)
    params = sw.init_params(torch.Generator().manual_seed(1))
    assert params.shape == (6, 3) and params.dtype == torch.float32
    state = sw.init(torch.Generator().manual_seed(1))
    assert torch.equal(state.params, params)


def test_liu_west_runs_on_svol_as_in_jax():
    """A few APF steps on univariate SVOL from its prior: the port runs
    where it raised, and as in the JAX package the prior's ss = +inf
    particles leave the evidence undefined (NaN on both sides)."""
    ys = (np.random.default_rng(0).normal(size=(6, 1)) * 0.01).astype(
        np.float32)
    got = LiuWestFilter(svol.make_model(), 64).run(
        torch.Generator().manual_seed(0), torch.from_numpy(ys))
    want = JaxLiuWestFilter(jsvol.make_model(), 64).run(
        jax.random.key(0), jnp.asarray(ys))
    assert got.log_likelihood.shape == ()
    assert got.ess.shape == (6,)
    assert bool(torch.isfinite(got.log_likelihood)) == bool(
        np.isfinite(np.asarray(want.log_likelihood)))


def test_replace_returns_a_copy_with_the_fields_replaced():
    model = svol_leverage.make_model()
    other = model.replace(name="renamed", prop_mu=None)
    assert other is not model and type(other) is type(model)
    assert other.name == "renamed" and other.prop_mu is None
    assert model.name != "renamed" and model.prop_mu is not None
    assert other.log_g is model.log_g and other.transform is model.transform
    with pytest.raises(TypeError):
        model.replace(no_such_field=1)
