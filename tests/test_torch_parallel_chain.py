"""The chain axis of ``ssme_tpu_torch.parallel`` on 2 and 4 gloo ranks.

Invariants (each rank a process of ``parallel.spawn_local``; the rank
programs are in the JAX-free ``torch_parallel_ranks.py``):

- a chain-sharded batched hook equals the concatenation of its inner
  hook on each rank's rows with the folded generator, bit for bit, for
  the generic bank (with and without covariates) and the CPU paths of
  the SVOL kernel's and the generic kernel's hooks (JAX's own invariant,
  ``tests/test_kernel_sharded.py``); against JAX's sharded hook it
  agrees in distribution (4 combined standard errors);
- chain-sharded PMMH with per-chain likelihoods equals the unsharded run
  bit for bit;
- the sharded swarm's aggregates are the reduction of the per-rank
  aggregates: exactly at 2 ranks, to 1e-6 relative at 4 (the order of
  the all-reduce's sum); in distribution they agree with the unsharded
  swarm (4 combined standard errors);
- both dryruns pass.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from ssme_tpu import parallel as jparallel
from ssme_tpu.filters import replicated_log_like_fn as jax_bank
from ssme_tpu.models import svol as jsvol
from ssme_tpu_torch import parallel
from ssme_tpu_torch.inference import SwarmFilter
from ssme_tpu_torch.models import svol
from ssme_tpu_torch.ops._prng import fold_generator

torch.set_num_threads(1)
T_LEN = 12


def _inputs():
    rng = np.random.default_rng(0)
    ys = (0.1 * rng.normal(size=(T_LEN, 1))).astype(np.float32)
    lev_ys = (0.05 * rng.normal(size=(T_LEN, 1))).astype(np.float32)
    svol_params = np.stack([[1.0, 0.9, 0.04 + 0.01 * i]
                            for i in range(8)]).astype(np.float32)
    lev_params = np.tile([0.9, 0.0, 0.15, -0.3], (8, 1)).astype(np.float32)
    draws = np.stack([[1.0, 0.9, 0.04 + 0.005 * i]
                      for i in range(16)]).astype(np.float32)
    return {"ys": ys, "lev_ys": lev_ys,
            "lev_zs": np.concatenate([np.zeros((1, 1), np.float32),
                                      lev_ys[:-1]]),
            "svol_params": svol_params, "lev_params": lev_params,
            "swarm_draws": draws}


INPUTS = _inputs()


@pytest.fixture(scope="module")
def spawned():
    """Each world size's rank outputs, spawned once for the module."""
    return {}


def _world(spawned, n):
    if n not in spawned:
        spawned[n] = parallel.spawn_local(ranks.chain_checks, n, "cpu",
                                          args=(INPUTS,), timeout=120)
    return n, spawned[n]


@pytest.fixture(params=[2, 4])
def world(request, spawned):
    return _world(spawned, request.param)


@pytest.mark.parametrize("hook", ["generic", "generic_covariates",
                                  "svol_filter", "filter_megakernel"])
def test_sharded_hook_is_its_inner_hook_per_rank(world, hook):
    n, outs = world
    for o in outs:
        got, want = o["hooks"][hook]
        assert got.shape == (8,)
        assert torch.equal(got, want), (hook, n, o["rank"])
        assert bool(torch.isfinite(got).all())
    # every rank returns the gathered whole
    assert all(torch.equal(o["hooks"][hook][0], outs[0]["hooks"][hook][0])
               for o in outs)


def test_sharded_hook_rejects_chains_that_do_not_divide(world):
    n, outs = world
    for o in outs:
        assert o["divisibility"] == (
            f"num chains C={n + 1} must be divisible by the mesh's "
            f"'chain' axis size ({n})")


def test_chain_sharded_pmmh_equals_unsharded_bitwise(world):
    n, outs = world
    for o in outs:
        for k, (got, want) in o["pmmh"].items():
            assert got.shape[:2] == (4, 2 * n), k
            assert torch.equal(got, want), (k, n, o["rank"])
        assert o["final_chains"] == 2
    assert bool(torch.isfinite(outs[0]["pmmh"]["samples"][0]).all())


def test_pmmh_through_the_sharded_hook_is_reproducible(world):
    n, outs = world
    a, b = outs[0]["hooked"]
    assert a.shape == (4, 2 * n, 3) and bool(torch.isfinite(a).all())
    assert torch.equal(a, b)
    assert all(torch.equal(o["hooked"][0], a) for o in outs)


def test_sharded_swarm_is_the_reduction_of_the_ranks(world):
    n, outs = world
    lme_r, mean_r = outs[0]["swarm"]["ranks"]            # (n, T) each
    m = torch.amax(lme_r, 0)
    s = sum(torch.exp(lme_r[r] - m) for r in range(n))
    want = (m + torch.log(s) - math.log(n), sum(mean_r[r] for r in range(n))
            / n)
    for o in outs:
        for got, w in zip(o["swarm"]["global"], want):
            assert got.shape == (T_LEN,)
            if n == 2:
                assert torch.equal(got, w)
            else:
                torch.testing.assert_close(got, w, rtol=1e-6, atol=1e-6)


def test_sharded_swarm_agrees_with_the_unsharded_swarm(world):
    n, outs = world
    swarm = SwarmFilter(svol.make_model(), num_state_particles=32,
                        num_param_particles=4 * n, resampler="systematic")
    un = []
    for seed in range(8):
        state = swarm.init(ranks.gen(10 + seed),
                           ranks.t(INPUTS["swarm_draws"]))
        for y in ranks.t(INPUTS["ys"]):
            state, res = swarm.update(state, y)
            un.append(res)
    un_tot = np.array([float(torch.stack([r.log_cond_like for r in
                                          un[s * T_LEN:(s + 1) * T_LEN]])
                             .sum()) for s in range(8)])
    sh_tot = np.array(outs[0]["swarm_totals"])
    se = math.sqrt(un_tot.var(ddof=1) / 8 + sh_tot.var(ddof=1) / 8)
    assert np.isfinite(sh_tot).all()
    assert abs(un_tot.mean() - sh_tot.mean()) < 4 * se, (un_tot, sh_tot)


def test_fetch_across_hosts_gathers_in_rank_order(world):
    n, outs = world
    want = torch.arange(n, dtype=torch.float32).repeat_interleave(2)
    assert all(torch.equal(o["fetched"], want) for o in outs)


def test_sharded_hook_agrees_with_jax_in_distribution(spawned):
    """The port's sharded generic bank (4 ranks) against JAX's sharded
    bank on 4 virtual devices: the same chains' log-likelihoods over 8
    keys and seeds, means within 4 combined standard errors."""
    n = 4
    ys, params = INPUTS["ys"], INPUTS["svol_params"]
    ll = jparallel.shard_batched_log_like(
        jax_bank(jsvol.make_model(), 32, 2),
        jparallel.make_mesh(n, 1, devices=jax.devices()[:n]))
    f = jax.jit(lambda k: ll(k, jnp.asarray(params), jnp.asarray(ys)))
    jax_vals = np.stack([np.asarray(f(jax.random.key(s)))
                         for s in range(8)])
    port = np.asarray(_world(spawned, n)[1][0]["hook_draws"])
    assert port.shape == jax_vals.shape == (8, 8)
    a, b = port.sum(1), jax_vals.sum(1)
    se = math.sqrt(a.var(ddof=1) / 8 + b.var(ddof=1) / 8)
    assert abs(a.mean() - b.mean()) < 4 * se, (a, b)


def test_fold_generator_is_a_function_of_the_state_and_the_index():
    a, b = ranks.gen(7), ranks.gen(7)
    f0, g0 = fold_generator(a, 0), fold_generator(b, 0)
    assert f0.initial_seed() == g0.initial_seed()
    assert torch.equal(torch.rand(4, generator=f0),
                       torch.rand(4, generator=g0))
    # the fold moved both on alike; another index, or the moved state,
    # gives another stream
    c, d = ranks.copy(a), ranks.copy(a)
    assert fold_generator(c, 1).initial_seed() != \
        fold_generator(d, 0).initial_seed()
    assert fold_generator(a, 0).initial_seed() != f0.initial_seed()


def test_initialize_distributed_raises_on_cuda_without_a_card(tmp_path):
    import torch.distributed as dist

    if torch.cuda.is_available():
        pytest.skip("this machine has a card (the card test hides it)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.initialize_distributed(
            "file://" + str(tmp_path / "store"), 1, 0, "cuda")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="device"):
        parallel.initialize_distributed(device="tpu")


def test_mesh_shape_must_match_the_world(world):
    n, outs = world
    assert all(o["mesh_error"] == f"mesh 3x1 != {n} devices" for o in outs)


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    from ssme_tpu_torch.examples import dryrun_multichip

    assert dryrun_multichip.main(["--devices", "4", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: mesh=chain 2 x particle 2")
    assert "max|sharded-unsharded|=0 " in line
    assert "bisection-ring(n_local=2048) bit-exact" in line


def test_dryrun_multihost_two_processes_bit_match(capsys):
    from ssme_tpu_torch.examples import dryrun_multihost

    assert dryrun_multihost.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "PASS: 2-process chain-sharded PMMH ran and bit-matches")


@pytest.mark.skipif(torch.cuda.device_count() >= 2,
                    reason="the machine has two cards")
def test_dryrun_multihost_defaults_to_two_cards():
    from ssme_tpu_torch.examples import dryrun_multihost

    with pytest.raises(RuntimeError, match="need 2 cards"):
        dryrun_multihost.main([])


def test_scaling_sweep_rows_on_two_cpu_ranks(spawned):
    rows = _world(spawned, 2)[1][0]["scaling"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["chains"] for r in rows] == [2, 4]
    assert all(r["props_per_sec"] > 0 for r in rows)
    assert rows[0]["parallel_efficiency"] == 1.0


def test_spawn_local_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        parallel.spawn_local(ranks.fail, 2, "cpu", timeout=60)


def test_spawn_local_kills_a_hung_rank_at_its_timeout():
    import time

    # 30 s leaves rank 0 time to start, import torch, join and return on a
    # loaded machine; rank 1 sleeps twenty times as long.
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match=r"ranks \[1\] still running"):
        parallel.spawn_local(ranks.hang, 2, "cpu", args=(600,), timeout=30)
    assert time.perf_counter() - t0 < 90
