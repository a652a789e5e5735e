"""The particle axis of ``ssme_tpu_torch.parallel`` (``sharded_pf``) on 2
and 4 gloo ranks, against JAX's ``ssme_tpu.parallel.sharded_pf`` under
``shard_map`` on as many virtual CPU devices.

Invariants (the rank programs are in the JAX-free
``torch_parallel_ranks.py``):

- ``global_logsumexp`` and ``global_ess`` equal JAX's to 1e-5 relative;
  ``_partition_positions`` with the offset given equals JAX's to 1e-5 of
  N (JAX's prefix sums associate in a tree, the port's in order);
- the ring exchange equals the allgather reference bit for bit, on
  heavy-tailed weights, weights crushed at a shard's tail, all the mass
  on one shard (every slot claimed once) and at n_local = 2048;
- the ancestors' frequencies follow the weights (to 0.01 over 50 draws);
- the sharded log-likelihood: ring and allgather bit for bit; within 4
  combined standard errors of the port's unsharded ``BootstrapFilter``,
  of JAX's sharded filter and of its own ESS-gated schedule.
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
from ssme_tpu.parallel import sharded_pf as jspf
from ssme_tpu_torch import parallel
from ssme_tpu_torch.filters import BootstrapFilter
from ssme_tpu_torch.models import lgssm

torch.set_num_threads(1)
N = 64
LGSSM_PARAMS = (0.8, 0.5, 0.3)
SEEDS = 16


def _lgssm_ys(t_len, seed):
    rng = np.random.default_rng(seed)
    a, q, r = LGSSM_PARAMS
    x = rng.normal() * q / math.sqrt(1 - a * a)
    ys = []
    for _ in range(t_len):
        ys.append(x + r * rng.normal())
        x = a * x + q * rng.normal()
    return np.asarray(ys, np.float32)[:, None]


def _inputs(n_shards):
    rng = np.random.default_rng(n_shards)
    logw = (3.0 * rng.normal(size=N)).astype(np.float32)
    sets = [(3.0 * rng.normal(size=N)).astype(np.float32) for _ in range(6)]
    for w in sets[4:]:
        w[-12:] = -80.0       # the pinned boundary against a near-zero tail
    heavy = np.full(N, -1e30, np.float32)
    heavy[N - N // n_shards:] = 0.0          # all mass on the last shard
    lev_ys = (0.05 * rng.normal(size=(16, 1))).astype(np.float32)
    d = {"logw": logw, "xs": rng.normal(size=(N, 2)).astype(np.float32),
         "u0": 0.37, "logw_sets": sets, "heavy": heavy,
         "index": np.arange(N, dtype=np.float32)[:, None],
         "ramp": np.log(np.arange(1.0, N + 1)).astype(np.float32),
         "lgssm_params": np.asarray(LGSSM_PARAMS, np.float32),
         "lgssm_ys": _lgssm_ys(30, 5),
         "lev_params": np.asarray([[0.9, 0.0, 0.15, -0.3]], np.float32),
         "lev_ys": lev_ys,
         "lev_zs": np.concatenate([np.zeros((1, 1), np.float32),
                                   lev_ys[:-1]])}
    if n_shards == 2:
        big = 2 * 2048
        d.update(big_logw=(3.0 * rng.normal(size=big)).astype(np.float32),
                 big_xs=rng.normal(size=(big, 1)).astype(np.float32),
                 big_th=rng.normal(size=(big, 3)).astype(np.float32))
    return d


@pytest.fixture(scope="module")
def spawned():
    return {}


@pytest.fixture(params=[2, 4])
def world(request, spawned):
    n = request.param
    if n not in spawned:
        d = _inputs(n)
        spawned[n] = (d, parallel.spawn_local(ranks.pf_checks, n, "cpu",
                                              args=(d,), timeout=120))
    return n, spawned[n][0], spawned[n][1]


def _jax_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("particle",))


def test_global_reductions_match_jax(world):
    n, d, outs = world
    specs = dict(mesh=_jax_mesh(n), in_specs=P("particle"), out_specs=P(),
                 check_vma=False)
    lse = jax.jit(shard_map(lambda x: jspf.global_logsumexp(x, "particle"),
                            **specs))
    ess = jax.jit(shard_map(lambda x: jspf.global_ess(x, "particle"),
                            **specs))
    logw = jnp.asarray(d["logw"])
    for o in outs:
        np.testing.assert_allclose(float(o["lse"]), float(lse(logw)),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(o["ess"]), float(ess(logw)),
                                   rtol=1e-5)
    assert len({float(o["lse"]) for o in outs}) == 1


def test_partition_positions_match_jax(world):
    n, d, outs = world
    f = jax.jit(shard_map(
        lambda x, u: jspf._partition_positions(x, u, "particle"),
        mesh=_jax_mesh(n), in_specs=(P("particle"), P()),
        out_specs=(P("particle"), P()), check_vma=False))
    q, bound = f(jnp.asarray(d["logw"]), jnp.float32(d["u0"]))
    got_q = np.concatenate([o["positions"][0].numpy() for o in outs])
    np.testing.assert_allclose(got_q, np.asarray(q), rtol=0, atol=1e-5 * N)
    for o in outs:
        np.testing.assert_allclose(o["positions"][1].numpy(),
                                   np.asarray(bound), rtol=0, atol=1e-5 * N)
        assert bool((torch.diff(o["positions"][0]) >= 0).all())
        assert bool((torch.diff(o["positions"][1]) >= 0).all())
        assert float(o["positions"][1][-1]) == np.float32(N - d["u0"])


def test_ring_equals_allgather_bitwise(world):
    n, d, outs = world
    for o in outs:
        for ring, gathered in o["ring"]:
            assert torch.equal(ring[0], gathered[0])
    # every output slot claimed: no row left at its zero start
    for s in range(len(d["logw_sets"])):
        cloud = torch.cat([o["ring"][s][0][0] for o in outs])
        assert not bool((cloud == 0).all(-1).any())


def test_ring_under_extreme_imbalance(world):
    n, d, outs = world
    out = torch.cat([o["imbalance"] for o in outs])[:, 0].numpy()
    lo = N - N // n
    assert np.all((out >= lo) & (out < N)), out
    _, counts = np.unique(out, return_counts=True)
    np.testing.assert_array_equal(counts, np.full(N // n, n))


def test_ring_equals_allgather_at_n_local_2048(spawned):
    if 2 not in spawned:
        d = _inputs(2)
        spawned[2] = (d, parallel.spawn_local(ranks.pf_checks, 2, "cpu",
                                              args=(d,), timeout=120))
    for o in spawned[2][1]:
        ring, gathered = o["big"]
        assert ring[0].shape == (2048, 1) and ring[1].shape == (2048, 3)
        for a, b in zip(ring, gathered):
            assert torch.equal(a, b)


def test_sharded_ancestors_follow_the_weights(world):
    n, d, outs = world
    want = np.arange(1.0, N + 1)
    want /= want.sum()
    np.testing.assert_allclose(outs[0]["ancestor_freqs"].numpy(), want,
                               atol=0.01)


def test_sharded_likelihood_ring_equals_allgather(world):
    n, d, outs = world
    for o in outs:
        assert o["ll_allgather"] == o["ll_ring"][:2]
        assert o["ll_ring"] == outs[0]["ll_ring"]      # every rank's value
        assert math.isfinite(o["ll_covariates"])


def _within_4se(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se = math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) < 4 * se, (a.mean(), b.mean(), se)


def test_sharded_likelihood_agrees_with_the_unsharded_filter(world):
    n, d, outs = world
    params = torch.tensor(LGSSM_PARAMS)
    gen = torch.Generator().manual_seed(1000)
    un = BootstrapFilter(lgssm.make_model(), 256, resampler="systematic").run(
        gen, params.expand(SEEDS, 3), torch.as_tensor(d["lgssm_ys"]))
    _within_4se(outs[0]["ll_ring"], un.log_likelihood.numpy())


def test_sharded_likelihood_agrees_with_jax_sharded(world):
    n, d, outs = world
    f = jax.jit(jspf.make_sharded_ll_callable(jlgssm.make_model(), 256,
                                              _jax_mesh(n)))
    ys = jnp.asarray(d["lgssm_ys"])
    params = jnp.asarray(LGSSM_PARAMS)
    jax_lls = [float(f(jax.random.key(s), params, ys)) for s in range(SEEDS)]
    _within_4se(outs[0]["ll_ring"], jax_lls)


def test_ess_gated_sharded_likelihood_agrees_with_every_step(world):
    n, d, outs = world
    _within_4se(outs[0]["ll_ess"], outs[0]["ll_ring"])
