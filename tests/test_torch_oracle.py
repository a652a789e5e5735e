"""The port's float64 oracle (``ssme_tpu_torch/oracle.py``) against the
JAX package's (``ssme_tpu/oracle.py``), on the CPU.

The deterministic pieces agree to 1e-12.  The filter and the chain draw
from other streams (torch's, numpy's), so they agree in distribution:
means within 4 combined standard errors.  The dead-row cases give
numpy's -inf / NaN classes.  With one deterministic likelihood in both
modules and numpy's generator replaced by one that replays the port's
CPU stream, the two chains and their proposal covariances agree draw for
draw, which holds the Haario recursion to the reference.
"""

import math

import numpy as np
import pytest
import torch

from ssme_tpu import oracle as ref
from ssme_tpu_torch import oracle
from ssme_tpu_torch.diagnostics import ess as geyer_ess

torch.set_num_threads(1)

TRUE = np.array([1.0, 0.9, 0.04])


def _simulate(seed, t_len):
    rng = np.random.default_rng(seed)
    beta, phi, ss = TRUE
    sigma = np.sqrt(ss)
    x = rng.normal(0.0, sigma / np.sqrt(1 - phi * phi))
    ys = np.empty(t_len)
    for t in range(t_len):
        if t > 0:
            x = phi * x + sigma * rng.normal()
        ys[t] = rng.normal() * beta * np.exp(0.5 * x)
    return ys


def _z(theta):
    return np.array([theta[0], 2.0 * np.arctanh(theta[1]), np.log(theta[2])])


def test_names_and_constants():
    assert oracle.__all__ == ref.__all__
    assert (oracle.SD, oracle.EPS) == (ref.SD, ref.EPS)


@pytest.mark.parametrize("z", [
    [0.85, 4.3, -2.7], [-1.3, -0.2, 0.5], [0.0, 0.0, 0.0],
    [1.0, 40.0, -800.0],          # tanh rounds to 1, exp underflows to 0
    [2.0, -45.0, 800.0],          # tanh to -1, exp overflows to inf
    [1e200, 800.0, 1.0], [np.nan, 1.0, np.inf]])
def test_transforms_agree(z):
    z = np.array(z)
    np.testing.assert_allclose(oracle.constrain(z).numpy(), ref.constrain(z),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(oracle.log_jacobian(z), ref.log_jacobian(z),
                               rtol=1e-12, atol=0)
    assert isinstance(oracle.log_jacobian(z), float)


@pytest.mark.parametrize("theta", [
    [0.85, 0.97, 0.066], [-2.0, 0.5, 3.0],                     # inside
    [1.0, 0.0, 0.1], [1.0, 1.0, 0.1], [1.0, 0.5, 0.0],          # edges
    [1.0, 1.2, 0.1], [1.0, -0.1, 0.1], [1.0, 0.5, -1.0],        # outside
    [1e200, 0.5, 0.1], [1.0, 0.5, np.inf], [1.0, 0.5, 5e-324],
    [np.nan, 0.5, 0.1], [1.0, np.nan, 0.1], [1.0, 0.5, np.nan]])
def test_log_prior_agrees(theta):
    theta = np.array(theta)
    got, want = oracle.log_prior(theta), ref.log_prior(theta)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(oracle.log_prior(torch.tensor(theta)), want,
                               rtol=1e-12, atol=0)


def test_batch_means_se_agrees():
    x = np.cumsum(np.random.default_rng(3).normal(size=1013))
    np.testing.assert_allclose(oracle.batch_means_se(x),
                               ref.batch_means_se(x), rtol=1e-12)
    np.testing.assert_allclose(oracle.batch_means_se(x, 7),
                               ref.batch_means_se(x, 7), rtol=1e-12)


def _agree(a, b, k=4.0):
    se = math.hypot(a.std(ddof=1) / math.sqrt(a.size),
                    b.std(ddof=1) / math.sqrt(b.size))
    assert abs(a.mean() - b.mean()) < k * se, (a.mean(), b.mean(), se)


def test_pf_rows_agree_with_numpy_filter_in_distribution():
    """200 replicates at T=100, N=256: numpy's one filter at a time, the
    port's as the rows of one batch."""
    ys = _simulate(5, 100)
    rng = np.random.default_rng(1)
    want = np.array([ref.pf_loglike(rng, TRUE, ys, 256) for _ in range(200)])
    gen = torch.Generator().manual_seed(1)
    got = oracle._pf_rows(gen, torch.tensor(TRUE), ys, 256, 200)
    assert got.dtype == torch.float64 and got.shape == (200,)
    _agree(got.numpy(), want)
    one = oracle.pf_loglike(gen, TRUE, ys, 256)
    assert isinstance(one, float)
    assert abs(one - want.mean()) < 6 * want.std()


def test_loglike_reps_agrees_in_distribution():
    ys = _simulate(6, 100)
    z = _z(TRUE)
    rng = np.random.default_rng(2)
    want = np.array([ref.loglike_reps(rng, z, ys, 64, 4) for _ in range(40)])
    gen = torch.Generator().manual_seed(2)
    got = np.array([oracle.loglike_reps(gen, torch.tensor(z), ys, 64, 4)
                    for _ in range(40)])
    _agree(got, want)


# theta (constrained) and series of the filter's dead-row cases
_Y = _simulate(8, 20)
_DEAD = {
    "phi_at_one": ([1.0, 1.0, 0.04], _Y),        # stationary sd inf: NaN
    "ss_underflows": ([1.0, 0.9, 0.0], _Y),       # sigma 0: finite, exact
    "ss_overflows": ([1.0, 0.9, np.inf], _Y),     # NaN
    "beta_negative": ([-1.0, 0.9, 0.04], _Y),     # log of sd < 0: NaN
    "beta_zero": ([0.0, 0.9, 0.04], _Y),
    # the running total overflows to -inf, then a step's weights all
    # vanish: the reference returns the -inf, a filter run on gives NaN
    "sum_overflows_then_dies": ([1e-156, 0.9, 0.0],
                                np.array([0.01] * 4 + [0.2] + [0.01] * 3)),
    "dies_first": ([1e-156, 0.9, 0.0], np.array([0.2] + [0.01] * 6)),
}


def _cls(v):
    return "nan" if np.isnan(v) else "finite" if np.isfinite(v) else (
        "+inf" if v > 0 else "-inf")


@pytest.mark.parametrize("case", sorted(_DEAD))
def test_dead_rows_give_numpys_classes(case):
    theta, ys = _DEAD[case]
    theta = np.array(theta)
    want = ref.pf_loglike(np.random.default_rng(0), theta, ys, 8)
    rows = oracle._pf_rows(torch.Generator().manual_seed(0),
                           torch.tensor(theta), ys, 8, 5).numpy()
    assert [_cls(v) for v in rows] == [_cls(want)] * 5, (rows, want)
    if case == "ss_underflows":      # every particle at 0: deterministic
        np.testing.assert_allclose(rows, want, rtol=1e-12)
    if case == "sum_overflows_then_dies":
        assert want == -np.inf


@pytest.mark.parametrize("vals", [
    [0.0, np.nan], [np.nan, -np.inf], [-np.inf, -np.inf], [-np.inf, 1.0],
    [-3.0, 2.0, 1e3]])
def test_replicate_reduction_keeps_numpys_classes(vals, monkeypatch):
    """A NaN replicate gives NaN (np.max propagates it); all -inf gives
    -inf; otherwise the log-mean-exp of the finite ones."""
    it = iter(vals)
    monkeypatch.setattr(ref, "pf_loglike", lambda *a: next(it))
    monkeypatch.setattr(oracle, "_pf_rows",
                        lambda *a: torch.tensor(vals, dtype=torch.float64))
    want = ref.loglike_reps(None, np.zeros(3), None, 1, len(vals))
    got = oracle.loglike_reps(None, np.zeros(3), None, 1, len(vals))
    assert _cls(got) == _cls(want)
    if np.isfinite(want):
        np.testing.assert_allclose(got, want, rtol=1e-12)


class _Replay:
    """numpy's generator for ``ssme_tpu.oracle``, replaying the port's MH
    stream: the same normals and uniforms in the same order."""

    def __init__(self, gen):
        self.gen = gen

    def normal(self, loc, scale, size):
        return torch.randn(size, generator=self.gen,
                           dtype=torch.float64).numpy()

    def uniform(self):
        return float(torch.rand((), generator=self.gen, dtype=torch.float64))


def test_haario_chain_matches_draw_for_draw(monkeypatch):
    """One Gaussian log-likelihood in z for both modules, one stream of
    draws: the samples and every proposal covariance agree to 1e-10, and
    the covariance is c0 I up to t0, adapts after it and freezes at t1."""
    mu = _z([0.85, 0.97, 0.066])
    prec = np.diag([40.0, 2.0, 3.0])

    def loglike(rng, z, ys, n, r):
        d = np.asarray(z, np.float64) - mu
        return float(-0.5 * d @ prec @ d)

    monkeypatch.setattr(ref, "loglike_reps", loglike)
    monkeypatch.setattr(oracle, "loglike_reps", loglike)
    seed, n_iters, t0, t1, c0 = 5, 400, 30, 300, 0.15
    monkeypatch.setattr(np.random, "default_rng",
                        lambda s: _Replay(oracle._generators(s, "cpu")[0]))
    cts = {"ref": [], "port": []}
    np_chol, torch_chol = np.linalg.cholesky, torch.linalg.cholesky
    monkeypatch.setattr(np.linalg, "cholesky",
                        lambda a: cts["ref"].append(a.copy()) or np_chol(a))
    monkeypatch.setattr(torch.linalg, "cholesky",
                        lambda a: cts["port"].append(a.numpy().copy())
                        or torch_chol(a))
    start = mu + np.array([0.3, -1.0, 0.8])
    want = ref.oracle_pmmh(seed, None, start, n_iters, 1, 1, t0, t1, c0)
    got = oracle.oracle_pmmh(seed, np.zeros(3), start, n_iters, 1, 1, t0, t1,
                             c0, device="cpu")
    assert got.dtype == np.float64 and got.shape == (n_iters, 3)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert len(np.unique(got[:, 0])) > 50                  # it moved
    port, reference = np.array(cts["port"]), np.array(cts["ref"])
    np.testing.assert_allclose(port, reference, rtol=1e-10, atol=1e-14)
    np.testing.assert_array_equal(port[:t0], np.broadcast_to(
        c0 * np.eye(3), (t0, 3, 3)))
    assert np.abs(port[t0] - c0 * np.eye(3)).max() > 1e-3
    assert not np.array_equal(port[t0], port[t1 - 2])
    np.testing.assert_array_equal(port[t1 - 1:], np.broadcast_to(
        port[t1 - 2], (n_iters - t1 + 1, 3, 3)))


def _moments(samples, burn):
    post = samples[burn:]
    esses = np.maximum(geyer_ess(post[:, None, :]), 4.0)
    return post.mean(0), post.std(0, ddof=1) / np.sqrt(esses)


def test_oracle_pmmh_posterior_agrees_with_jax_oracle():
    """A short simulated series (T=60, N=32, R=1, 600 iterations from the
    truth): posterior means within 4 combined SE (sd / sqrt(Geyer ESS))."""
    ys = _simulate(7, 60)
    z0 = _z(TRUE)
    want = ref.oracle_pmmh(11, ys, z0, 600, 32, 1, t0=20, t1=10 ** 9)
    got = oracle.oracle_pmmh(11, ys, z0, 600, 32, 1, t0=20, t1=10 ** 9,
                             device="cpu")
    (mw, sw), (mg, sg) = _moments(want, 150), _moments(got, 150)
    assert (sg > 0).all() and np.isfinite(got).all()
    assert (np.abs(mg - mw) < 4.0 * np.hypot(sw, sg)).all(), (mg, mw, sw, sg)


def test_oracle_pmmh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oracle.oracle_pmmh(11, np.zeros(4), np.zeros(3), 1, 8, 1, 0, 1)


def test_chains_script_writes_each_seeds_chain(tmp_path):
    """``scripts/torch_oracle_chains.py`` on the CPU at a tiny width: one
    process a seed, each file the chain that ``oracle_pmmh`` gives for
    that seed from the mode start, and one JSON line of timings."""
    import json
    import os
    import sys

    from _bounded import run_bounded
    from ssme_tpu_torch.examples.accuracy_gate import MODE_START_Z
    from ssme_tpu_torch.examples.spy_flagship import spy_returns

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = run_bounded(
        [sys.executable, os.path.join(root, "scripts",
                                      "torch_oracle_chains.py"),
         "--device", "cpu", "--t-len", "20", "--iters", "6", "--particles",
         "16", "--replicates", "2", "--out-dir", str(tmp_path)],
        timeout=30)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert (rec["T"], rec["N"], rec["R"], rec["iters"]) == (20, 16, 2, 6)
    assert sorted(rec["chains"]) == ["11", "13"]
    ys = spy_returns("cpu", 20).double()
    for seed in (11, 13):
        want = oracle.oracle_pmmh(seed, ys, np.asarray(MODE_START_Z), 6, 16,
                                  2, t0=150, t1=10 ** 9, device="cpu")
        np.testing.assert_array_equal(
            np.load(tmp_path / f"torch_oracle_chain_{seed}.npy"), want)
        assert rec["chains"][str(seed)]["s_per_iter"] > 0
