"""The port's swarm path (``ssme_tpu_torch/inference/swarm.py``, the swarm
adapters of the filter kernels, ``io.ParamSampler``, future simulation and
the ``swarm_forecast`` CLI) against the JAX package."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu.filters import BootstrapFilter as JaxBootstrapFilter
from ssme_tpu.inference import SwarmFilter as JaxSwarmFilter
from ssme_tpu.inference import forecast_from_cloud as jax_forecast
from ssme_tpu.io import ParamSampler as JaxParamSampler
from ssme_tpu.io import SampleWriter as JaxSampleWriter
from ssme_tpu.models import svol_leverage as jlev
from ssme_tpu.ops import filter_megakernel as jfm
from ssme_tpu_torch.filters import BootstrapFilter
from ssme_tpu_torch.inference import SwarmFilter, forecast_from_cloud
from ssme_tpu_torch.io import ParamSampler, read_params_csv
from ssme_tpu_torch.models import svol_leverage as lev
from ssme_tpu_torch.ops import filter_megakernel as fm
from ssme_tpu_torch.ops.svol_filter_kernel import svol_swarm_evidence

torch.set_num_threads(1)

THETA = (0.9, 0.0, 0.15, -0.3)        # (phi, mu, sigma, rho)
DRAWS = np.array([[0.9, 0.0, 0.15, -0.3], [0.95, -0.1, 0.3, -0.7],
                  [0.85, 0.1, 0.2, -0.5], [0.92, 0.05, 0.25, -0.4]],
                 np.float32)


def _ys(t_len, seed=0):
    rng = np.random.default_rng(seed)
    return (np.exp(0.4 * rng.normal(size=t_len)) * rng.normal(size=t_len)
            ).astype(np.float32)


def _within(got, want, k=4.0):
    """Means of independent units within k combined standard errors."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    se = math.sqrt(got.var(ddof=1) / got.size + want.var(ddof=1) / want.size)
    return abs(got.mean() - want.mean()) < k * se, (got.mean(), want.mean(),
                                                    se)


def test_param_sampler_reads_jax_written_samples_and_draws_uniformly(
        tmp_path):
    path = str(tmp_path / "samples")
    with JaxSampleWriter(path, timestamp=False) as w:
        for i in range(8):
            w.record(i, DRAWS[i % 4] + i)
    sampler = ParamSampler(path, dim_param=4)
    np.testing.assert_array_equal(sampler.samples.numpy(),
                                  read_params_csv(path, 4))
    np.testing.assert_array_equal(sampler.samples.numpy(),
                                  np.asarray(JaxParamSampler(path, 4).samples))
    draws = sampler.samp(torch.Generator().manual_seed(0), num=40000)
    again = sampler.samp(torch.Generator().manual_seed(0), num=40000)
    assert draws.shape == (40000, 4) and torch.equal(draws, again)
    assert sampler.samp(torch.Generator().manual_seed(1)).shape == (4,)
    # every row is drawn with probability 1/8 (5-sigma binomial band)
    freq = np.array([(draws == sampler.samples[k]).all(-1).sum().item()
                     for k in range(8)])
    assert freq.sum() == 40000
    assert np.all(np.abs(freq - 5000) < 5 * math.sqrt(40000 * 7 / 64))
    with pytest.raises(ValueError):
        ParamSampler(np.zeros((0, 4)))
    with pytest.raises(ValueError):
        ParamSampler(path, dim_param=3)


def _sim_units(obs):
    """(steps, N, 1) paths -> per-step y and y^2 of each particle path."""
    obs = np.asarray(obs, np.float64)[..., 0]
    return obs, obs ** 2


def test_sim_future_obs_matches_jax_in_distribution():
    """Leverage model, observations fed back as covariates, 4000 particle
    paths of 3 steps from the same cloud: per step, the mean of y and of
    y^2 within 4 standard errors of JAX's."""
    rng = np.random.default_rng(1)
    cloud = (0.5 * rng.normal(size=(4000, 1)) - 0.2).astype(np.float32)
    last = np.array([-1.5], np.float32)
    want = JaxBootstrapFilter(jlev.make_model(), 4000).sim_future_obs(
        jax.random.key(0), jnp.asarray(DRAWS[1]), jnp.asarray(cloud), 3,
        feedback_obs_as_cov=True, last_obs=jnp.asarray(last))
    got = BootstrapFilter(lev.make_model(), 4000).sim_future_obs(
        torch.Generator().manual_seed(0), torch.from_numpy(DRAWS[1]),
        torch.from_numpy(cloud), 3, feedback_obs_as_cov=True,
        last_obs=torch.from_numpy(last))
    assert got.shape == tuple(want.shape) == (3, 4000, 1)
    for g, w in zip(_sim_units(got), _sim_units(want)):
        for t in range(3):
            ok, info = _within(g[t], w[t])
            assert ok, (t, info)
    with pytest.raises(ValueError, match="feedback_obs_as_cov"):
        BootstrapFilter(lev.make_model(), 8).sim_future_obs(
            torch.Generator(), torch.from_numpy(DRAWS[0]),
            torch.zeros(8, 1), 2)


def test_forecast_from_cloud_matches_jax_in_distribution():
    """4 models x 3000 particles with mildly uneven weights: the pooled
    mean and variance of the forecast within 4 standard errors of JAX's,
    at each of 3 steps."""
    rng = np.random.default_rng(2)
    cloud = (0.4 * rng.normal(size=(4, 3000)) - 0.3).astype(np.float32)
    lw = (0.3 * rng.normal(size=(4, 3000))).astype(np.float32)
    lw -= lw.max(-1, keepdims=True)
    last = np.array([0.8], np.float32)
    want = np.asarray(jax_forecast(
        jlev.make_model(), jnp.asarray(DRAWS), (jnp.asarray(cloud),),
        jnp.asarray(lw), jax.random.key(1), 3, last_obs=jnp.asarray(last)))
    got = forecast_from_cloud(
        lev.make_model(), torch.from_numpy(DRAWS), (torch.from_numpy(cloud),),
        torch.from_numpy(lw), torch.Generator().manual_seed(1), 3,
        last_obs=torch.from_numpy(last)).numpy()
    assert got.shape == want.shape == (4, 3, 3000, 1)
    for t in range(3):
        for stat in (lambda a: a, lambda a: a ** 2):
            ok, info = _within(stat(got[:, t].astype(np.float64)).ravel(),
                               stat(want[:, t].astype(np.float64)).ravel())
            assert ok, (t, info)


def test_swarm_filter_matches_jax_in_distribution():
    """Generic swarm, 4 models x 128 particles, T=40: the total
    conditional evidence over 8 seeds within 4 standard errors of JAX's,
    with the same result shapes."""
    ys = _ys(40, 3)[:, None]
    zs = np.concatenate([[[0.0]], ys[:-1]]).astype(np.float32)
    fns = (lambda x, z, p: x,)
    jsw = JaxSwarmFilter(jlev.make_model(), 128, 4, functionals=fns)
    run = jax.jit(lambda k: jsw.run(k, jnp.asarray(ys), jnp.asarray(zs),
                                    param_draws=jnp.asarray(DRAWS)))
    sw = SwarmFilter(lev.make_model(), 128, 4, functionals=fns)
    want, got = [], []
    for seed in range(8):
        jstate, jres = run(jax.random.key(seed))
        state, res = sw.run(torch.Generator().manual_seed(seed),
                            torch.from_numpy(ys), torch.from_numpy(zs),
                            param_draws=torch.from_numpy(DRAWS))
        want.append(float(jnp.sum(jres.log_cond_like)))
        got.append(float(res.log_cond_like.sum()))
        assert res.log_cond_like.shape == tuple(jres.log_cond_like.shape)
        assert res.mean_log_cond_like.shape == tuple(
            jres.mean_log_cond_like.shape)
        assert res.expectations[0].shape == tuple(
            jres.expectations[0].shape) == (40, 1)
        assert state.particles.shape == tuple(jstate.particles.shape)
    ok, info = _within(got, want)
    assert ok, info
    obs = sw.sim_future_obs(torch.Generator().manual_seed(0), state, 2,
                            last_obs=torch.from_numpy(ys[-1]))
    assert obs.shape == (4, 2, 128, 1) and torch.isfinite(obs).all()
    prior = SwarmFilter(lev.make_model(), 16, 3).init_params(
        torch.Generator().manual_seed(0))
    assert prior.shape == (3, 4)
    assert torch.isfinite(lev.make_model().log_prior(prior)).all()


def test_swarm_evidence_keys_and_shapes_match_jax():
    """The kernel swarm adapter (plain version on the CPU) returns JAX's
    keys with JAX's shapes; the per-step aggregates are the logmeanexp
    and the mean of the per-model lcls."""
    ys = 0.3 * np.ones(16, np.float32)
    zs = np.concatenate([[0.0], ys[:-1]]).astype(np.float32)
    kw = dict(num_particles=128, ess_threshold=1e-6, gate_stride=4,
              return_cloud=True)
    want = jfm.megakernel_swarm_evidence(
        jfm.svol_leverage_kernel_model(), 3, jnp.asarray(DRAWS),
        jnp.asarray(ys), jnp.asarray(zs), interpret=True, **kw)
    got = fm.megakernel_swarm_evidence(
        fm.svol_leverage_kernel_model(), 3, torch.from_numpy(DRAWS),
        torch.from_numpy(ys), torch.from_numpy(zs), **kw)
    assert set(got) == set(want)
    for key in got:
        g, w = got[key], want[key]
        if isinstance(w, tuple):
            assert len(g) == len(w)
            assert [tuple(a.shape) for a in g] == [tuple(a.shape) for a in w]
        else:
            assert tuple(g.shape) == tuple(w.shape), key
    lcl = got["per_model_log_cond_likes"]
    torch.testing.assert_close(got["log_cond_like"],
                               torch.logsumexp(lcl, 0) - math.log(4))
    torch.testing.assert_close(got["mean_log_cond_like"], lcl.mean(0))
    mask = np.ones(16, bool)
    mask[[3, 7, 11, 15]] = False
    assert (lcl[:, mask] == 0).all() and (lcl[:, ~mask] != 0).all()


def test_svol_swarm_adapters_agree_on_the_same_bits():
    """The SVOL kernel's swarm adapter and the generic kernel's svol
    instance consume the same Philox bits: identical per-model lcls."""
    draws = torch.tensor([[1.0, 0.9, 0.05], [0.8, 0.95, 0.02],
                          [1.2, 0.5, 0.1]])
    ys = torch.from_numpy(_ys(30, 4))
    a = svol_swarm_evidence(5, draws, ys, num_particles=64,
                            ess_threshold=0.5)
    b = fm.megakernel_swarm_evidence(fm.svol_kernel_model(), 5,
                                     fm.svol_kernel_rows(draws), ys,
                                     num_particles=64, ess_threshold=0.5)
    assert set(a) == {"log_cond_like", "mean_log_cond_like",
                      "per_model_log_cond_likes", "volatility_path"}
    torch.testing.assert_close(a["per_model_log_cond_likes"],
                               b["per_model_log_cond_likes"], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(a["volatility_path"], b["functional_path"],
                               rtol=1e-5, atol=1e-5)


def _cli_inputs(tmp_path):
    data = tmp_path / "ys.csv"
    np.savetxt(data, _ys(60, 5)[:, None], delimiter=",")
    samples = tmp_path / "samples.csv"
    np.savetxt(samples, np.repeat(DRAWS, 3, axis=0), delimiter=",")
    return str(data), str(samples)


def _shape_of_output(text):
    """Each line with its numbers blanked and its spacing collapsed."""
    import re
    lines = [re.sub(r"\s+", " ", re.sub(r"[-+]?\d+\.?\d*(e[-+]?\d+)?", "#",
                                        ln)) for ln in text.splitlines()]
    return [ln.replace("[ ", "[").replace(" ]", "]") for ln in lines
            if ln.strip()]


def test_cli_prints_the_jax_clis_lines(tmp_path, capsys):
    """Both CLIs on the CPU at T=60: the same printed lines (numbers
    aside) on stdout and the same forecast table on stderr."""
    from examples import swarm_forecast as jcli
    from ssme_tpu_torch.examples import swarm_forecast as cli

    data, samples = _cli_inputs(tmp_path)
    common = [data, samples, "--model", "svol_leverage", "--state-particles",
              "64", "--param-particles", "4", "--forecast", "3"]
    jcli.main(common)
    want = capsys.readouterr()
    for engine in ("generic", "kernel"):
        cli.main(common + ["--engine", engine, "--device", "cpu"])
        got = capsys.readouterr()
        assert _shape_of_output(got.out) == _shape_of_output(want.out)
        table = [ln for ln in got.err.splitlines() if ln.startswith("  t+")]
        assert _shape_of_output("\n".join(table)) == _shape_of_output(
            "\n".join(ln for ln in want.err.splitlines()
                      if ln.startswith("  t+")))
        assert len(table) == 3


def test_cli_checks_its_options(tmp_path):
    from ssme_tpu_torch.examples import swarm_forecast as cli

    data, samples = _cli_inputs(tmp_path)
    base = [data, samples, "--model", "svol_leverage", "--device", "cpu"]
    for bad in (["--engine", "kernel", "--state-particles", "100"],
                ["--engine", "kernel", "--state-particles", "2048"],
                ["--engine", "generic", "--ess", "0.5"],
                ["--engine", "generic", "--gate-stride", "8"]):
        with pytest.raises(SystemExit):
            cli.main(base + bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([data, samples, "--device", "cuda"])


def test_cli_default_device_is_cuda_and_raises_without_a_card(tmp_path):
    """No silent CPU run: without --device the CLI asks for the card."""
    from ssme_tpu_torch.examples import swarm_forecast as cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data, samples = _cli_inputs(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([data, samples, "--model", "svol_leverage"])
