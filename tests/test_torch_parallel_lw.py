"""The particle-sharded Liu-West filter of ``ssme_tpu_torch.parallel``
(``sharded_lw``) on 2 and 4 gloo ranks, against JAX's
``ssme_tpu.parallel.sharded_lw`` under ``shard_map`` on as many virtual
CPU devices.

Invariants (the rank programs are in the JAX-free
``torch_parallel_ranks.py``):

- ``_proposal_components`` (the all-reduced weighted mean and the
  Cholesky factor of h^2 Vt) equals JAX's to 1e-5 (float32, no TF32);
- the constant functional is 42 to 1e-3 for APF and SISR, the global
  ESS at most the cloud size, with and without the ESS gate;
- the evidence agrees with the port's unsharded ``LiuWestFilter`` and
  with JAX's sharded filter within 4 combined standard errors, for APF
  and SISR;
- the runner returns the global cloud, its parameters in their support;
  the future simulation has its shape and is finite.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_parallel_ranks as ranks
from ssme_tpu.models import lgssm as jlgssm
from ssme_tpu.models import svol_leverage as jlev
from ssme_tpu.parallel import sharded_lw as jslw
from ssme_tpu_torch import parallel
from ssme_tpu_torch.filters import LiuWestFilter
from ssme_tpu_torch.models import lgssm

torch.set_num_threads(1)
N, SEEDS = 64, 8


def _inputs(n_shards):
    rng = np.random.default_rng(10 + n_shards)
    lev_ys = (0.05 * rng.normal(size=(12, 1))).astype(np.float32)
    a, q, r = 0.8, 0.5, 0.3
    x, ys = 0.0, []
    for _ in range(20):
        x = a * x + q * rng.normal()
        ys.append(x + r * rng.normal())
    trans = np.stack([rng.normal(size=N) * 0.3 + m
                      for m in (2.0, -0.1, -1.5, -0.7)], 1).astype(np.float32)
    return {"trans": trans,
            "logw": (2.0 * rng.normal(size=N)).astype(np.float32),
            "lev_ys": lev_ys,
            "lev_zs": np.concatenate([np.zeros((1, 1), np.float32),
                                      lev_ys[:-1]]),
            "lgssm_ys": np.asarray(ys, np.float32)[:, None]}


@pytest.fixture(scope="module")
def spawned():
    return {}


@pytest.fixture(params=[2, 4])
def world(request, spawned):
    n = request.param
    if n not in spawned:
        d = _inputs(n)
        spawned[n] = (d, parallel.spawn_local(ranks.lw_checks, n, "cpu",
                                              args=(d,), timeout=120))
    return n, spawned[n][0], spawned[n][1]


def _jax_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("particle",))


def test_proposal_components_match_jax(world):
    n, d, outs = world
    lw = jslw.ShardedLiuWest(jlev.make_model(), N)
    f = jax.jit(shard_map(lw._proposal_components, mesh=_jax_mesh(n),
                          in_specs=(P("particle"), P("particle")),
                          out_specs=(P(), P()), check_vma=False))
    theta_bar, chol = f(jnp.asarray(d["trans"]), jnp.asarray(d["logw"]))
    for o in outs:
        got_bar, got_chol = o["components"]
        np.testing.assert_allclose(got_bar.numpy(), np.asarray(theta_bar),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_chol.numpy(), np.asarray(chol),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["apf", "sisr"])
def test_constant_functional_is_42_under_sharding(world, variant):
    n, d, outs = world
    for o in outs:
        e42, ess, lcls = o[f"const_{variant}"]
        assert e42.shape == (12, 1)
        assert float((e42 - 42.0).abs().max()) < 1e-3
        assert bool(torch.isfinite(lcls).all())
        assert bool((ess <= N + 1e-3).all())


def test_ess_gated_schedule_is_finite(world):
    n, d, outs = world
    res = outs[0]["gated"]
    assert bool(torch.isfinite(res.log_cond_likes).all())
    assert math.isfinite(float(res.log_likelihood))


def test_runner_returns_the_global_cloud_in_support(world):
    n, d, outs = world
    for o in outs:
        p = o["params"]
        # (phi, mu, sigma, rho): phi, rho in (-1, 1), sigma > 0
        assert p.shape == (N, 4) and o["weights_shape"] == (N,)
        assert bool((p[:, 0].abs() < 1).all()) and bool((p[:, 2] > 0).all())
        assert bool((p[:, 3].abs() < 1).all())
        assert torch.equal(p, outs[0]["params"])


def test_future_simulation_shape(world):
    n, d, outs = world
    for o in outs:
        assert o["future"].shape == (5, N // n, 1)
        assert bool(torch.isfinite(o["future"]).all())


def _within_4se(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se = math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) < 4 * se, (a.mean(), b.mean(), se)


@pytest.mark.parametrize("variant", ["apf", "sisr"])
def test_evidence_agrees_with_the_unsharded_filter(world, variant):
    n, d, outs = world
    gen = torch.Generator().manual_seed(300)
    un = LiuWestFilter(lgssm.make_model(), 256, variant=variant).run(
        gen, torch.as_tensor(d["lgssm_ys"]), batch_shape=(SEEDS,))
    _within_4se(outs[0][f"evidence_{variant}"], un.log_likelihood.numpy())


@pytest.mark.parametrize("variant", ["apf", "sisr"])
def test_evidence_agrees_with_jax_sharded(world, variant):
    n, d, outs = world
    sh = jslw.ShardedLiuWest(jlgssm.make_model(), 256, variant=variant)
    run = jax.jit(jslw.make_sharded_lw_runner(sh, _jax_mesh(n)))
    ys = jnp.asarray(d["lgssm_ys"])
    jax_lls = [float(run(jax.random.key(400 + s), ys).log_likelihood)
               for s in range(SEEDS)]
    _within_4se(outs[0][f"evidence_{variant}"], jax_lls)
