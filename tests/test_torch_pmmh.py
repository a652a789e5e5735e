"""The port's adaptive PMMH (``ssme_tpu_torch/inference/pmmh.py``) and its
checkpoints against the JAX package."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu import rv as jrv
from ssme_tpu.inference import AdaptivePMMH as JaxPMMH
from ssme_tpu.io import save_checkpoint as jax_save_checkpoint
from ssme_tpu.models import svol as jsvol
from ssme_tpu.models import svol_leverage as jlev
from ssme_tpu_torch.diagnostics import ess as mcmc_ess
from ssme_tpu_torch.inference import AdaptivePMMH
from ssme_tpu_torch.io import load_jax_checkpoint
from ssme_tpu_torch.models import svol, svol_leverage
from ssme_tpu_torch.ops.filter_megakernel import (megakernel_log_like,
                                                  svol_leverage_kernel_model)
from ssme_tpu_torch.ops.svol_filter_kernel import svol_batched_log_like

torch.set_num_threads(1)

# a closed-form log-likelihood on the constrained (beta, phi, ss)
MODE, SCALE = (0.9, 0.95, math.log(0.02)), (0.1, 0.02, 0.5)


def _ll_torch(gen, params, ys):
    z = torch.stack([params[:, 0], params[:, 1], torch.log(params[:, 2])],
                    -1)
    return -0.5 * (((z - torch.tensor(MODE)) / torch.tensor(SCALE)) ** 2
                   ).sum(-1)


def _ll_jax(params):
    z = jnp.stack([params[:, 0], params[:, 1], jnp.log(params[:, 2])], -1)
    return -0.5 * (((z - jnp.asarray(MODE)) / jnp.asarray(SCALE)) ** 2
                   ).sum(-1)


# the covariate twin: a closed form on the constrained (phi, mu, sigma,
# rho) that also reads the covariates
LEV_MODE = (0.95, -0.1, math.log(0.3), -0.6)
LEV_SCALE = (0.02, 0.2, 0.3, 0.1)
WIDE = ((0.5, 0.999), (-2.0, 2.0), (0.05, 1.0), (-0.95, 0.0))


def _ll_torch_cov(gen, params, ys, zs):
    assert zs is not None and zs.shape == (ys.shape[0], 1)
    z = torch.stack([params[:, 0], params[:, 1], torch.log(params[:, 2]),
                     params[:, 3]], -1)
    return (-0.5 * (((z - torch.tensor(LEV_MODE)) / torch.tensor(LEV_SCALE))
                    ** 2).sum(-1) + 0.5 * params[:, 3] * zs.sum())


def _ll_jax_cov(params, zs):
    z = jnp.stack([params[:, 0], params[:, 1], jnp.log(params[:, 2]),
                   params[:, 3]], -1)
    return (-0.5 * (((z - jnp.asarray(LEV_MODE)) / jnp.asarray(LEV_SCALE))
                    ** 2).sum(-1) + 0.5 * params[:, 3] * zs.sum())


def _check_trajectory(port_model, jax_model, start, ll_torch, ll_jax,
                      ys=None, zs=None):
    """Explicit normals and log-uniforms through both recursions: 200
    iterations x 8 chains with adaptation in (20, 120).  States agree to
    1e-4; a chain may only part ways at an accept decision within 1e-5
    of its boundary, and is not compared after that."""
    c, d, iters = 8, port_model.dim_param, 200
    rng = np.random.default_rng(0)
    eps = rng.normal(size=(iters, c, d)).astype(np.float32)
    log_u = np.log(rng.uniform(size=(iters, c))).astype(np.float32)
    ys_t = torch.zeros(1, 1) if ys is None else torch.from_numpy(ys)
    zs_t = None if zs is None else torch.from_numpy(zs)

    port = AdaptivePMMH(port_model, num_particles=1, t0=20, t1=120,
                        batched_log_like=ll_torch)
    st = port.init(0, start, ys_t, num_chains=c, zs=zs_t)

    jp = JaxPMMH(jax_model, num_particles=1, t0=20, t1=120)
    theta = jnp.broadcast_to(jnp.asarray(start, jnp.float32), (c, d))
    tf = jax_model.transform
    lp = jax.vmap(jp._log_prior_with_jacobian)(theta)
    ll = ll_jax(tf.constrain(theta))
    mean = jnp.zeros((c, d))
    sig = jnp.zeros((c, d, d))
    ct = jnp.broadcast_to(0.15 * jnp.eye(d), (c, d, d))
    ama = jnp.zeros(c)
    upd = jax.vmap(jp._update_moments_and_ct, in_axes=(0, None))

    @jax.jit
    def jax_step(carry, i, eps_k, log_u_k):
        theta, ll, lp, mean, sig, ct, ama = carry
        mean, sig, ct = upd((theta, mean, sig, ct), i)
        chol = jax.vmap(jrv.chol_with_jitter)(ct)
        prop = theta + jnp.einsum("cij,cj->ci", chol, eps_k,
                                  precision=jax.lax.Precision.HIGHEST)
        new_lp = jax.vmap(jp._log_prior_with_jacobian)(prop)
        new_ll = ll_jax(tf.constrain(prop))
        log_acc = new_lp + new_ll - lp - ll
        acc = log_u_k < log_acc
        theta = jnp.where(acc[:, None], prop, theta)
        ll = jnp.where(acc, new_ll, ll)
        lp = jnp.where(acc, new_lp, lp)
        fi = i.astype(jnp.float32)
        ama = jnp.where(acc, 1.0, 0.0) / (fi + 1.0) + fi * ama / (fi + 1.0)
        return (theta, ll, lp, mean, sig, ct, ama), log_acc, acc

    carry = (theta, ll, lp, mean, sig, ct, ama)
    live = np.ones(c, bool)
    for k in range(iters):
        carry, log_acc, acc = jax_step(carry, jnp.asarray(k + 1),
                                       jnp.asarray(eps[k]),
                                       jnp.asarray(log_u[k]))
        theta, ll, lp, mean, sig, ct, ama = carry
        st, out = port.step(st, ys_t, torch.from_numpy(eps[k]),
                            torch.from_numpy(log_u[k]), zs=zs_t)
        near = np.abs(np.asarray(log_acc) - log_u[k]) < 1e-5
        same = np.asarray(out[6]) == np.asarray(acc)
        assert np.all(same | near | ~live), f"iteration {k + 1}"
        live &= same
        for got, want in ((st.trans_theta, theta), (st.log_like, ll),
                          (st.log_prior, lp), (st.mean, mean),
                          (st.sigma_hat, sig), (st.ct, ct),
                          (st.accept_ma, ama)):
            np.testing.assert_allclose(np.asarray(got)[live],
                                       np.asarray(want)[live],
                                       rtol=1e-4, atol=1e-4)
    assert live.sum() >= c - 1
    assert float(st.accept_ma.mean()) > 0.05


def test_trajectory_matches_jax_recursion():
    _check_trajectory(svol.make_model(), jsvol.make_model(),
                      svol.START_TRANS_THETA, _ll_torch,
                      lambda params: _ll_jax(params))


def test_covariate_trajectory_matches_jax_recursion():
    """The twin on the 4-parameter leverage model: the port's PMMH passes
    zs to the batched hook on every iteration, as JAX does."""
    ys = _spy_like(20, 7)
    zs = np.concatenate([[[0.0]], ys[:-1]]).astype(np.float32)
    start = np.asarray(svol_leverage.make_model().transform.unconstrain(
        torch.tensor([0.9, 0.0, 0.3, -0.3])))
    _check_trajectory(svol_leverage.make_model(WIDE), jlev.make_model(WIDE),
                      start, _ll_torch_cov,
                      lambda params: _ll_jax_cov(params, jnp.asarray(zs)),
                      ys=ys, zs=zs)


def test_every_likelihood_route_receives_zs():
    """batched_log_like and custom_log_like get zs iff the model has
    covariates; the generic bank always does (and needs it here)."""
    ys = torch.from_numpy(_spy_like(15, 8))
    zs = torch.cat([torch.zeros(1, 1), ys[:-1]])
    seen = []

    def custom(gen, params, ys_, zs_):
        seen.append(zs_)
        return _ll_torch_cov(gen, params[None], ys_, zs_)[0]

    model = svol_leverage.make_model(WIDE)
    start = model.transform.unconstrain(torch.tensor([0.9, 0.0, 0.3, -0.3]))
    for pmmh in (AdaptivePMMH(model, num_particles=16, num_replicates=2,
                              custom_log_like=custom),
                 AdaptivePMMH(model, num_particles=16, num_replicates=2)):
        res = pmmh.run(0, start, 2, ys, num_chains=2, zs=zs)
        assert torch.isfinite(res.log_likes).all()
    assert len(seen) == 2 * 2 * 3 and all(z is zs for z in seen)
    with pytest.raises(ValueError, match="requires covariates"):
        AdaptivePMMH(model, num_particles=16).run(0, start, 1, ys)


def _spy_like(t_len, seed):
    rng = np.random.default_rng(seed)
    x, ys = 0.0, np.empty((t_len, 1), np.float32)
    for t in range(t_len):
        x = 0.95 * x + math.sqrt(0.05) * rng.normal()
        ys[t, 0] = 0.9 * math.exp(x / 2) * rng.normal()
    return ys


def test_load_jax_checkpoint_resumes_on_the_port(tmp_path):
    ys = _spy_like(20, 1)
    jp = JaxPMMH(jsvol.make_model(), num_particles=32,
                 batched_log_like=lambda key, params, ys: _ll_jax(params))
    jstate = jp.init(jax.random.key(3), jnp.asarray(jsvol.START_TRANS_THETA),
                     jnp.asarray(ys), num_chains=4)
    path = str(tmp_path / "jax.npz")
    jax_save_checkpoint(path, jstate, {"completed_iters": 0})
    state, meta = load_jax_checkpoint(path)
    assert meta == {"completed_iters": 0}
    for field in ("trans_theta", "log_like", "log_prior", "mean",
                  "sigma_hat", "ct", "accept_ma"):
        np.testing.assert_array_equal(getattr(state, field).numpy(),
                                      np.asarray(getattr(jstate, field)))
    assert state.iteration == int(jstate.iteration)
    keys = np.asarray(jax.random.key_data(jstate.key))
    assert [g.initial_seed() for g in state.generators] == [
        (int(a) << 32) | int(b) for a, b in keys]
    port = AdaptivePMMH(svol.make_model(), num_particles=32)
    res = port.run_from(state, 3, torch.from_numpy(ys))
    assert res.samples.shape == (3, 4, 3)
    assert res.final_state.iteration == 3
    assert torch.isfinite(res.log_likes).all()


def test_load_jax_leverage_checkpoint_resumes_with_covariates(tmp_path):
    """A JAX PMMHState of the 4-parameter leverage model, saved by the JAX
    package, resumes on the port's PMMH with zs through the generic
    kernel's plain version."""
    ys = _spy_like(30, 9)
    zs = np.concatenate([[[0.0]], ys[:-1]]).astype(np.float32)
    jp = JaxPMMH(jlev.make_model(WIDE), num_particles=32,
                 batched_log_like=lambda key, params, ys_, zs_: _ll_jax_cov(
                     params, zs_))
    start = jlev.make_model().transform.unconstrain(
        jnp.asarray([0.9, 0.0, 0.3, -0.3]))
    jstate = jp.init(jax.random.key(4), start, jnp.asarray(ys),
                     zs=jnp.asarray(zs), num_chains=4)
    path = str(tmp_path / "lev.npz")
    jax_save_checkpoint(path, jstate, {"completed_iters": 0})
    state, _ = load_jax_checkpoint(path)
    assert state.trans_theta.shape == (4, 4) and state.ct.shape == (4, 4, 4)
    np.testing.assert_array_equal(state.log_like.numpy(),
                                  np.asarray(jstate.log_like))
    port = AdaptivePMMH(svol_leverage.make_model(WIDE), num_particles=64,
                        num_replicates=2,
                        batched_log_like=megakernel_log_like(
                            svol_leverage_kernel_model(), 64, 2))
    res = port.run_from(state, 3, torch.from_numpy(ys), zs=zs)
    assert res.samples.shape == (3, 4, 4)
    assert res.final_state.iteration == 3
    assert torch.isfinite(res.new_log_likes).all()


def test_svol_posterior_matches_jax_pmmh():
    """C=8 chains, R=2, N=128, T=100 simulated: pooled posterior means of
    the port (kernel hook, plain version on the CPU) and of JAX's
    AdaptivePMMH agree within 5 Monte-Carlo standard errors."""
    ys = _spy_like(100, 2)
    c, r, n, iters, burn = 8, 2, 128, 160, 40
    start = svol.START_TRANS_THETA
    port = AdaptivePMMH(svol.make_model(), num_particles=n, num_replicates=r,
                        t0=50, t1=10 ** 9,
                        batched_log_like=svol_batched_log_like(n, r))
    got = port.run(0, start, iters, torch.from_numpy(ys),
                   num_chains=c).samples.numpy()[burn:]
    jp = JaxPMMH(jsvol.make_model(), num_particles=n, num_replicates=r,
                 t0=50, t1=10 ** 9)
    want = np.asarray(jp.run(jax.random.key(1), jnp.asarray(start), iters,
                             jnp.asarray(ys), num_chains=c).samples)[burn:]
    for k in range(3):
        se = [np.std(s[..., k]) / math.sqrt(max(float(e), 1.0))
              for s, e in ((got, mcmc_ess(got[..., k])[0]),
                           (want, mcmc_ess(want[..., k])[0]))]
        diff = abs(got[..., k].mean() - want[..., k].mean())
        assert diff < 5 * math.hypot(*se), (k, got[..., k].mean(),
                                            want[..., k].mean())


def test_sample_streams_and_resumes_bit_exactly(tmp_path):
    from ssme_tpu_torch.io import MessageWriter, SampleWriter

    ys = torch.from_numpy(_spy_like(40, 3))
    pmmh = AdaptivePMMH(svol.make_model(), num_particles=64,
                        num_replicates=2, t0=2, t1=50,
                        batched_log_like=svol_batched_log_like(64, 2))
    full, st_full = pmmh.sample(5, svol.START_TRANS_THETA, 12, ys,
                                num_chains=3, chunk_size=4)
    ck = str(tmp_path / "chain.npz")
    part, _ = pmmh.sample(5, svol.START_TRANS_THETA, 8, ys, num_chains=3,
                          chunk_size=4, checkpoint_path=ck)
    with SampleWriter(str(tmp_path / "s"), timestamp=False) as sw, \
            MessageWriter(str(tmp_path / "m"), timestamp=False) as mw:
        rest, st_rest = pmmh.sample(5, svol.START_TRANS_THETA, 12, ys,
                                    num_chains=3, chunk_size=4,
                                    checkpoint_path=ck, sample_writer=sw,
                                    message_writer=mw)
    np.testing.assert_array_equal(np.concatenate([part, rest]), full)
    torch.testing.assert_close(st_rest.trans_theta, st_full.trans_theta,
                               rtol=0, atol=0)
    assert st_rest.iteration == st_full.iteration == 12
    rows = open(tmp_path / "s").read().splitlines()
    assert len(rows) == 4
    np.testing.assert_allclose([float(v) for v in rows[-1].split(",")],
                               full[-1, 0], rtol=1e-6)
    lines = open(tmp_path / "m").read().splitlines()
    assert lines[0].startswith("iter number") and lines[1].startswith("9, ")


@pytest.mark.parametrize("engine", ["kernel", "generic"])
def test_cli_runs_on_cpu(tmp_path, engine):
    from ssme_tpu_torch.examples import estimate_univ_svol as cli

    data = tmp_path / "ys.csv"
    np.savetxt(data, _spy_like(30, 4), delimiter=",")
    cli.main([str(data), str(tmp_path / "s"), str(tmp_path / "m"), "4", "2",
              "--chains", "2", "--particles", "50", "--device", "cpu",
              "--engine", engine, "--no-timestamp"])
    for chain in range(2):
        rows = open(tmp_path / f"s_chain{chain}").read().splitlines()
        assert len(rows) == 4 and len(rows[0].split(",")) == 3
    assert cli.kernel_particles(500) == 512
    assert cli.kernel_particles(5000) == 1024


def test_cli_device_cuda_without_a_card_raises(tmp_path):
    """No silent fallback: asking for the card where there is none is an
    error, not a CPU run."""
    from ssme_tpu_torch.examples import estimate_univ_svol as cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = tmp_path / "ys.csv"
    np.savetxt(data, _spy_like(10, 5), delimiter=",")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(data), str(tmp_path / "s"), str(tmp_path / "m"), "2",
                  "1", "--device", "cuda"])
    assert not (tmp_path / "s").exists()


def test_cli_default_device_is_cuda_and_raises_without_a_card(tmp_path):
    """No silent CPU run: without --device the CLI asks for the card."""
    from ssme_tpu_torch.examples import estimate_univ_svol as cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = tmp_path / "ys.csv"
    np.savetxt(data, _spy_like(10, 6), delimiter=",")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(data), str(tmp_path / "s"), str(tmp_path / "m"), "2",
                  "1"])
    assert not (tmp_path / "s").exists()
