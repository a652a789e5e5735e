"""The port's SVOL-with-leverage model, its box prior, its generic filter
bank with covariates and its estimation CLI against the JAX package."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu import rv as jrv
from ssme_tpu.filters import replicated_log_like_fn as jax_bank
from ssme_tpu.models import svol_leverage as jlev
from ssme_tpu_torch import rv
from ssme_tpu_torch.filters import replicated_log_like_fn
from ssme_tpu_torch.models import svol_leverage as lev

torch.set_num_threads(1)

THETA = (0.9, 0.0, 0.15, -0.3)        # (phi, mu, sigma, rho)
WIDE = ((0.5, 0.999), (-2.0, 2.0), (0.05, 1.0), (-0.95, 0.0))


def _params(k, seed=0):
    """k parameter rows inside the wide box (float32)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array(WIDE).T
    return (lo + (hi - lo) * rng.uniform(0.05, 0.95, (k, 4))).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_hooks_match_jax():
    """Deterministic hooks on the same inputs, to 1e-5 relative: 4
    parameter rows x 16 particles, the covariate row shared per step, and
    deep-negative states where the mean clamp binds."""
    rng = np.random.default_rng(1)
    p = _params(4)
    x_prev = rng.normal(size=(4, 16, 1)).astype(np.float32)
    x_prev[0, :3, 0] = [-60.0, -45.0, 45.0]         # clamp binds
    x = rng.normal(size=(4, 16, 1)).astype(np.float32)
    y = np.array([0.7], np.float32)
    z = np.array([-2.5], np.float32)
    tp, tx, txp = map(torch.from_numpy, (p, x, x_prev))
    ty, tz = torch.from_numpy(y), torch.from_numpy(z)

    def jax_each(fn):
        return jax.vmap(lambda pp, xs, xps: jax.vmap(
            lambda xi, xpi: fn(pp, xi, xpi))(xs, xps))(p, x, x_prev)

    _close(lev.log_mu(tp, tx), jax_each(lambda pp, xi, _: jlev.log_mu(pp, xi)))
    _close(lev.log_q1(tp, tx, ty),
           jax_each(lambda pp, xi, _: jlev.log_q1(pp, xi, y)))
    _close(lev.log_f(tp, tx, txp, tz),
           jax_each(lambda pp, xi, xpi: jlev.log_f(pp, xi, xpi, z)))
    _close(lev.log_q(tp, tx, txp, ty, tz),
           jax_each(lambda pp, xi, xpi: jlev.log_q(pp, xi, xpi, y, z)))
    _close(lev.log_g(tp, ty, tx, tz),
           jax_each(lambda pp, xi, _: jlev.log_g(pp, y, xi, z)))
    _close(lev.prop_mu(tp, txp, tz)[..., 0],
           jax_each(lambda pp, _, xpi: jlev.prop_mu(pp, xpi, z)[0]))
    assert float(lev.prop_mu(tp, txp, tz)[0, 0, 0]) == lev.STATE_CLAMP
    # per-particle covariates (fed-back observations) broadcast too
    zp = rng.normal(size=(4, 16, 1)).astype(np.float32)
    want = jax.vmap(lambda pp, xs, zs_: jax.vmap(
        lambda xpi, zi: jlev.prop_mu(pp, xpi, zi)[0])(xs, zs_))(p, x_prev, zp)
    _close(lev.prop_mu(tp, txp, torch.from_numpy(zp))[..., 0], want)


def test_samplers_draw_around_the_hooks():
    """The samplers add generator normals to the hooks' means and sds."""
    p = torch.from_numpy(_params(3))
    x = torch.randn(3, 8, 1, generator=torch.Generator().manual_seed(0))
    z = torch.tensor([0.4])
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    eps = torch.randn(x.shape, generator=g2)
    sd = (p[:, 2] * torch.sqrt(1 - p[:, 3] ** 2))[:, None, None]
    torch.testing.assert_close(lev.sample_f(g1, p, x, z),
                               lev.prop_mu(p, x, z) + eps * sd)
    q1 = lev.sample_q1(torch.Generator().manual_seed(2), p, None, 20000)
    sd0 = p[:, 2] / torch.sqrt(1 - p[:, 0] ** 2)
    torch.testing.assert_close(q1[..., 0].std(-1), sd0, rtol=0.03, atol=0)
    obs = lev.sample_g(torch.Generator().manual_seed(3), p,
                       torch.zeros(3, 20000, 1))
    assert obs.shape == (3, 20000, 1)
    assert abs(float(obs.std()) - 1.0) < 0.03


@pytest.mark.parametrize("bounds", [jlev.DEFAULT_PRIOR_BOUNDS, WIDE])
def test_box_prior_matches_jax_in_and_out_of_the_box(bounds):
    rng = np.random.default_rng(2)
    lo, hi = np.array(bounds).T
    inside = (lo + (hi - lo) * rng.uniform(0.01, 0.99, (6, 4))).astype(
        np.float32)
    outside = inside.copy()
    outside[np.arange(6), np.arange(6) % 4] = (hi + 0.5)[np.arange(6) % 4]
    pts = np.concatenate([inside, outside])
    _, jprior = jlev.make_uniform_prior(bounds)
    want = np.asarray(jax.vmap(jprior)(pts))
    got = lev.make_uniform_prior(bounds)[1](torch.from_numpy(pts)).numpy()
    assert np.isfinite(got[:6]).all() and np.isneginf(got[6:]).all()
    np.testing.assert_allclose(got[:6], want[:6], rtol=1e-5)
    np.testing.assert_array_equal(got[6:], want[6:])
    # per-column values against JAX's vector-bound uniform_logpdf
    jcols = np.asarray(jrv.uniform_logpdf(pts, jnp.asarray(lo),
                                          jnp.asarray(hi)))
    tcols = rv.box_uniform_logpdf(torch.from_numpy(pts), bounds).numpy()
    np.testing.assert_allclose(tcols, jcols, rtol=1e-5)
    # tensor bounds go through tensor ops, with the same values
    tb = rv.uniform_logpdf(torch.from_numpy(pts), torch.from_numpy(
        lo.astype(np.float32)), torch.from_numpy(hi.astype(np.float32)))
    np.testing.assert_allclose(tb.numpy(), jcols, rtol=1e-5)
    draws = torch.stack([lev.make_uniform_prior(bounds)[0](
        torch.Generator().manual_seed(s)) for s in range(50)])
    assert torch.isfinite(lev.make_uniform_prior(bounds)[1](draws)).all()


class _NoHostData(torch.overrides.TorchFunctionMode):
    """Fails on any read of a tensor back to the host and on any tensor
    made from host data (a host-to-device copy on a card)."""

    READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__float__,
             torch.Tensor.__bool__, torch.Tensor.numpy}
    MAKES = {torch.tensor, torch.as_tensor}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.READS or (func in self.MAKES and not isinstance(
                args[0], torch.Tensor)):
            raise AssertionError(f"host data: {func}")
        return func(*args, **(kwargs or {}))


def test_prior_and_transforms_never_touch_host_data():
    """The PMMH prior term of the leverage model (box prior + log-Jacobian)
    reads no tensor on the host and builds no tensor from host data, so
    on a card it never waits for the device."""
    model = lev.make_model(WIDE)
    theta = model.transform.unconstrain(torch.from_numpy(_params(5)))
    lo, hi = (torch.tensor(v) for v in zip(*WIDE))
    with _NoHostData():
        out = (model.log_prior(model.transform.constrain(theta))
               + model.transform.log_det_jacobian(theta))
        tensor_bounds = rv.uniform_logpdf(theta, lo, hi)
    assert out.shape == (5,) and torch.isfinite(out).all()
    assert tensor_bounds.shape == (5, 4)
    with pytest.raises(AssertionError, match="host data"):
        with _NoHostData():
            float(out[0])


def test_generic_bank_with_covariates_matches_jax_in_distribution():
    """C=32 chains x R=2 replicates, N=128, T=120: the port's generic
    bank and JAX's, both reading zs, agree within 4 standard errors."""
    rng = np.random.default_rng(3)
    ys = (np.exp(rng.normal(size=120) * 0.5) * rng.normal(size=120)).astype(
        np.float32)[:, None]
    zs = np.concatenate([[[0.0]], ys[:-1]]).astype(np.float32)
    c = 32
    params = np.tile(np.asarray(THETA, np.float32), (c, 1))
    want = np.asarray(jax_bank(jlev.make_model(), 128, 2)(
        jax.random.key(0), jnp.asarray(params), jnp.asarray(ys),
        jnp.asarray(zs)))
    got = replicated_log_like_fn(lev.make_model(), 128, 2)(
        torch.Generator().manual_seed(0), torch.from_numpy(params),
        torch.from_numpy(ys), torch.from_numpy(zs)).double().numpy()
    se = math.sqrt(got.var(ddof=1) / c + want.var(ddof=1) / c)
    assert abs(got.mean() - want.mean()) < 4 * se, (got.mean(), want.mean())
    with pytest.raises(ValueError, match="requires covariates"):
        replicated_log_like_fn(lev.make_model(), 32, 1)(
            torch.Generator(), torch.from_numpy(params[:2]),
            torch.from_numpy(ys))


def _data_file(tmp_path, t_len=60):
    rng = np.random.default_rng(4)
    ys = np.exp(rng.normal(size=t_len) * 0.4) * rng.normal(size=t_len)
    path = tmp_path / "ys.csv"
    np.savetxt(path, ys[:, None], delimiter=",")
    return str(path)


def test_cli_keys_match_the_jax_cli(tmp_path, capsys):
    """Both CLIs at T=60 on the CPU: the same JSON keys, posterior
    entries and statistics; the port also writes its samples as CSV."""
    from examples import estimate_svol_leverage as jcli
    from ssme_tpu_torch.examples import estimate_svol_leverage as cli
    from ssme_tpu_torch.io import read_params_csv

    data = _data_file(tmp_path)
    common = ["--datafile", data, "--iters", "12", "--burn", "4",
              "--chains", "2", "--particles", "64", "--replicates", "1"]
    jcli.main(common + ["--engine", "generic", "--out",
                        str(tmp_path / "jax.json")])
    for engine in ("kernel", "generic"):
        capsys.readouterr()
        cli.main(common + ["--engine", engine, "--device", "cpu", "--out",
                           str(tmp_path / "port.json"), "--samples-out",
                           str(tmp_path / "s.csv")])
        printed = json.loads(capsys.readouterr().out)
        got = json.load(open(tmp_path / "port.json"))
        want = json.load(open(tmp_path / "jax.json"))
        assert printed == got and got["engine"] == engine
        assert set(got) == set(want)
        assert set(got["posterior"]) == set(want["posterior"]) == {
            "phi", "mu", "sigma", "rho"}
        for name in got["posterior"]:
            assert set(got["posterior"][name]) == set(
                want["posterior"][name])
        rows = read_params_csv(str(tmp_path / "s.csv"), 4)
        assert rows.shape == (8 * 2, 4) and np.isfinite(rows).all()
    with pytest.raises(SystemExit):
        cli.main(common + ["--engine", "generic", "--gate-stride", "8",
                           "--device", "cpu"])


def test_cli_device_cuda_without_a_card_raises(tmp_path):
    from ssme_tpu_torch.examples import estimate_svol_leverage as cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--datafile", _data_file(tmp_path), "--device", "cuda"])


def test_cli_default_device_is_cuda_and_raises_without_a_card(tmp_path):
    """No silent CPU run: without --device the CLI asks for the card."""
    from ssme_tpu_torch.examples import estimate_svol_leverage as cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--datafile", _data_file(tmp_path), "--iters", "2",
                  "--particles", "64"])
