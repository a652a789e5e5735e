"""The port's generic Liu-West filter (``filters/liu_west.py``) and the
Liu-West CLI against the JAX package."""

import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu.filters import LiuWestFilter as JaxLiuWestFilter
from ssme_tpu.models import svol_leverage as jlev
from ssme_tpu_torch.filters import LiuWestFilter
from ssme_tpu_torch.models import svol_leverage as lev

torch.set_num_threads(1)


def _leverage_data(t_len, seed):
    """Simulated leverage returns (T, 1) and their lagged covariates."""
    rng = np.random.default_rng(seed)
    phi, mu, sigma, rho = 0.95, -0.1, 0.3, -0.6
    x, y_prev, ys = 0.0, 0.0, np.empty((t_len, 1), np.float32)
    for t in range(t_len):
        x = (mu + phi * (x - mu) + y_prev * rho * sigma * math.exp(-x / 2)
             + sigma * math.sqrt(1 - rho * rho) * rng.normal())
        y_prev = math.exp(x / 2) * rng.normal()
        ys[t, 0] = y_prev
    zs = np.concatenate([[[0.0]], ys[:-1]]).astype(np.float32)
    return ys, zs


@pytest.mark.parametrize("weighted", [False, True])
def test_proposal_components_match_jax(weighted):
    """theta_bar and chol(h^2 Vt) on identical (theta, logw), to 1e-5."""
    rng = np.random.default_rng(0)
    th = (rng.normal(size=(256, 4)) * [0.5, 0.1, 0.3, 0.8]
          + [2.0, 0.0, -1.5, -0.6]).astype(np.float32)
    lw = (rng.normal(size=256) * 2.0).astype(np.float32) if weighted \
        else None
    jf = JaxLiuWestFilter(jlev.make_model(), 256, delta=0.97)
    tf = LiuWestFilter(lev.make_model(), 256, delta=0.97)
    want = jf._proposal_components(
        jnp.asarray(th), None if lw is None else jnp.asarray(lw))
    got = tf._proposal_components(
        torch.from_numpy(th), None if lw is None else torch.from_numpy(lw))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("variant", ["apf", "sisr"])
def test_generic_filter_matches_jax_in_distribution(variant):
    """24 filters each side, N=256, T=100 of simulated leverage data: the
    mean log-likelihoods within 4 combined standard errors."""
    ys, zs = _leverage_data(100, 1)
    k = 24
    jf = JaxLiuWestFilter(jlev.make_model(), 256, variant=variant)
    want = np.asarray(jax.jit(jax.vmap(
        lambda key: jf.run(key, jnp.asarray(ys), jnp.asarray(zs))
        .log_likelihood))(jax.random.split(jax.random.key(0), k)),
        np.float64)
    tf = LiuWestFilter(lev.make_model(), 256, variant=variant)
    got = tf.run(torch.Generator().manual_seed(0), torch.from_numpy(ys),
                 torch.from_numpy(zs), batch_shape=(k,)).log_likelihood
    got = got.double().numpy()
    assert np.isfinite(got).all()
    se = math.sqrt(got.var(ddof=1) / k + want.var(ddof=1) / k)
    assert abs(got.mean() - want.mean()) < 4 * se, (got.mean(), want.mean(),
                                                    se)


@pytest.mark.parametrize("variant", ["apf", "sisr"])
def test_constant_functional_is_42(variant):
    """The reference's normalisation invariant: h = 42 averages to 42 at
    every step whatever the weights (rtol 1e-5)."""
    ys, zs = _leverage_data(12, 2)
    tf = LiuWestFilter(lev.make_model(), 32, variant=variant,
                       functionals=(lambda x, z, p: torch.full(
                           x.shape[:-1] + (1,), 42.0),))
    res = tf.run(torch.Generator().manual_seed(1), torch.from_numpy(ys),
                 torch.from_numpy(zs), batch_shape=(3,))
    assert res.expectations[0].shape == (3, 12, 1)
    np.testing.assert_allclose(res.expectations[0].numpy(), 42.0, rtol=1e-5)
    assert torch.isfinite(res.log_likelihood).all()


@pytest.mark.parametrize("variant", ["apf", "sisr"])
def test_parameter_support_and_ess_bounds(variant):
    ys, zs = _leverage_data(25, 3)
    tf = LiuWestFilter(lev.make_model(), 64, delta=0.95, variant=variant)
    res = tf.run(torch.Generator().manual_seed(2), torch.from_numpy(ys),
                 torch.from_numpy(zs))
    phi, mu, sigma, rho = tf.param_samples(res).unbind(-1)
    assert ((phi > 0) & (phi < 1)).all() and (sigma > 0).all()
    assert ((rho > -1) & (rho < 1)).all() and torch.isfinite(mu).all()
    assert res.ess.shape == (25,)
    assert ((res.ess >= 1 - 1e-3) & (res.ess <= 64 + 1e-3)).all()
    with pytest.raises(ValueError, match="requires covariates"):
        tf.run(torch.Generator(), torch.from_numpy(ys))
    with pytest.raises(ValueError, match="variant"):
        LiuWestFilter(lev.make_model(), 64, variant="bad")


def test_sim_future_obs_shape_feedback_and_last_obs():
    ys, zs = _leverage_data(20, 4)
    tf = LiuWestFilter(lev.make_model(), 32)
    res = tf.run(torch.Generator().manual_seed(3), torch.from_numpy(ys),
                 torch.from_numpy(zs), batch_shape=(2,))
    obs = tf.sim_future_obs(torch.Generator().manual_seed(4),
                            res.last_particles, res.last_trans_params, 6,
                            last_obs=torch.from_numpy(ys[-1]))
    assert obs.shape == (2, 6, 32, 1) and torch.isfinite(obs).all()
    with pytest.raises(ValueError, match="last_obs"):
        tf.sim_future_obs(torch.Generator(), res.last_particles,
                          res.last_trans_params, 2)
    # feedback: a transition that returns its covariate and an observation
    # that returns the state keep every path at last_obs
    echo = dataclasses.replace(
        lev.make_model(),
        sample_f=lambda gen, p, x, z: z.expand(x.shape).clone(),
        sample_g=lambda gen, p, x: x.clone())
    obs = LiuWestFilter(echo, 32).sim_future_obs(
        torch.Generator().manual_seed(5), res.last_particles,
        res.last_trans_params, 4, last_obs=torch.tensor([0.25]))
    assert torch.equal(obs, torch.full_like(obs, 0.25))


def _data_file(tmp_path, t_len=60):
    ys, _ = _leverage_data(t_len, 5)
    path = tmp_path / "ys.csv"
    np.savetxt(path, ys, delimiter=",")
    return str(path)


def _shape_of(text):
    """Each line with its numbers blanked."""
    return [re.sub(r"[-+]?\d+\.?\d*(e[-+]?\d+)?", "#", ln)
            for ln in text.splitlines() if ln.strip()]


def test_cli_prints_the_jax_clis_lines(tmp_path, capsys):
    """Both engines on the CPU at T=60, N=128, 4 filters: the JAX CLI's
    lines, numbers aside (the JAX kernel engine runs only on a TPU, so its
    line is the format of its print)."""
    from examples import liu_west_leverage as jcli
    from ssme_tpu_torch.examples import liu_west_leverage as cli

    data = _data_file(tmp_path)
    common = [data, "--particles", "128", "--forecast", "3"]
    jcli.main(common + ["--engine", "generic"])
    want = capsys.readouterr()
    cli.main(common + ["--engine", "generic", "--device", "cpu"])
    got = capsys.readouterr()
    assert _shape_of(got.out) == _shape_of(want.out)
    assert _shape_of(got.err) == _shape_of(want.err)
    assert len([ln for ln in got.out.splitlines() if "t+" in ln]) == 3

    cli.main([data, "--engine", "kernel", "--device", "cpu", "--filters",
              "4", "--particles", "128"])
    got = capsys.readouterr()
    assert _shape_of(got.out) == _shape_of(
        "log-likelihood: -1.00 +- 1.00 (4 filters)")
    assert _shape_of(got.err)[-5:] == _shape_of(want.err)
    assert "lw_megakernel launches: 0" in got.err      # plain on the CPU


def test_cli_device_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    from ssme_tpu_torch.examples import liu_west_leverage as cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = _data_file(tmp_path, 10)
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([data, "--particles", "64"] + extra)
