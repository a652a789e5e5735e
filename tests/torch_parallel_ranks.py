"""Rank programs of the parallel tests (``tests/test_torch_parallel_*.py``).

Each function runs in a process spawned by
``ssme_tpu_torch.parallel.spawn_local`` and returns what the test
compares.  This module imports the port only, never JAX: a spawned
process imports it by name, and runs no ``conftest.py``.
"""

import numpy as np
import torch
import torch.distributed as dist

from ssme_tpu_torch import parallel
from ssme_tpu_torch.filters import log_likelihood_fn, replicated_log_like_fn
from ssme_tpu_torch.inference import AdaptivePMMH, SwarmFilter
from ssme_tpu_torch.models import lgssm, svol, svol_leverage
from ssme_tpu_torch.ops import filter_megakernel as fmk
from ssme_tpu_torch.ops import svol_filter_kernel as sfk
from ssme_tpu_torch.ops._prng import fold_generator
from ssme_tpu_torch.parallel import sharded_pf as spf
from ssme_tpu_torch.parallel.mesh import all_gather_cat, particle_sharding
from ssme_tpu_torch.parallel.sharded_lw import (ShardedLiuWest,
                                                make_sharded_lw_runner)


def gen(seed):
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


def copy(g):
    out = torch.Generator()
    out.set_state(g.get_state())
    return out


def t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def constant_42(x, *rest):
    """The constant functional of the normalisation invariant."""
    return torch.full(x.shape[:-1] + (1,), 42.0)


# ---------------------------------------------------------------- chains


def _hook_pairs(d):
    """(name, sharded hook, inner hook, params, covariates) of the batched
    hooks the wrapper is held on."""
    lev_zs = t(d["lev_zs"])
    k2 = dict(constrain=sfk._kernel_rows, ess_threshold=0.5)
    return [
        ("generic", replicated_log_like_fn(svol.make_model(), 32, 2),
         t(d["svol_params"]), None),
        ("generic_covariates",
         replicated_log_like_fn(svol_leverage.make_model(), 32, 2),
         t(d["lev_params"]), lev_zs),
        ("svol_filter", sfk.svol_batched_log_like(32, 2),
         t(d["svol_params"]), None),
        ("filter_megakernel",
         fmk.megakernel_log_like(fmk.svol_kernel_model(), 32, 2, **k2),
         t(d["svol_params"]), None),
    ]


def chain_checks(d):
    """The chain-axis invariants at this world size."""
    n, me = dist.get_world_size(), dist.get_rank()
    mesh = parallel.make_mesh()
    ys, lev_ys = t(d["ys"]), t(d["lev_ys"])
    out = {"rank": me, "hooks": {}}
    for name, inner, params, zs in _hook_pairs(d):
        if name == "filter_megakernel":
            sharded = parallel.sharded_megakernel_log_like(
                fmk.svol_kernel_model(), 32, 2, mesh,
                constrain=sfk._kernel_rows, ess_threshold=0.5)
        else:
            sharded = parallel.shard_batched_log_like(inner, mesh)
        data = lev_ys if zs is not None else ys
        cov = () if zs is None else (zs,)
        got = sharded(gen(1), params, data, *cov)
        k = params.shape[0] // n
        want = torch.cat([inner(fold_generator(gen(1), r),
                                params[r * k:(r + 1) * k], data, *cov)
                          for r in range(n)])
        out["hooks"][name] = (got, want)
    try:
        parallel.shard_batched_log_like(_hook_pairs(d)[0][1], mesh)(
            gen(0), t(d["svol_params"])[:n + 1], ys)
        out["divisibility"] = None
    except ValueError as e:
        out["divisibility"] = str(e)

    # chain-sharded PMMH, per-chain likelihoods: the unsharded bits
    model = svol.make_model()
    start = torch.tensor(svol.START_TRANS_THETA)
    pmmh = AdaptivePMMH(model, num_particles=32, num_replicates=2, t0=2,
                        t1=50, custom_log_like=log_likelihood_fn(model, 32))
    chains = 2 * n
    res = parallel.sharded_pmmh(pmmh, mesh, 4)(parallel.shard_chain_state(
        pmmh.init(0, start, ys, num_chains=chains), mesh), ys)
    ref = pmmh.run(0, start, 4, ys, num_chains=chains)
    out["pmmh"] = {k: (getattr(res, k), getattr(ref, k))
                   for k in ("samples", "log_likes", "accepted",
                             "accept_rate")}
    out["final_chains"] = res.final_state.trans_theta.shape[0]

    # PMMH driving the sharded hook (replicated chains): reruns agree
    hooked = AdaptivePMMH(model, num_particles=32, num_replicates=2, t0=2,
                          t1=50, batched_log_like=parallel.
                          shard_batched_log_like(replicated_log_like_fn(
                              model, 32, 2), mesh))
    out["hooked"] = [hooked.run(5, start, 4, ys, num_chains=2 * n).samples
                     for _ in range(2)]

    # chain-sharded swarm: the reduction of the per-rank aggregates
    swarm = SwarmFilter(model, num_state_particles=32,
                        num_param_particles=4 * n,
                        resampler="systematic")
    draws = t(d["swarm_draws"])
    local = parallel.shard_swarm_state(swarm.init(gen(4), draws), mesh)
    twin = local._replace(generator=copy(local.generator))
    _, glob = parallel.sharded_swarm(swarm, mesh)(local, ys)
    per_rank = []
    for y in ys:
        twin, r = swarm.update(twin, y)
        per_rank.append((r.log_cond_like, r.mean_log_cond_like))
    out["swarm"] = {
        "global": (glob.log_cond_like, glob.mean_log_cond_like),
        "ranks": tuple(all_gather_cat(torch.stack(c)[None], dist.group.WORLD)
                       for c in zip(*per_rank))}
    totals = []
    for seed in range(8):
        st = parallel.shard_swarm_state(swarm.init(gen(10 + seed), draws),
                                        mesh)
        totals.append(float(parallel.sharded_swarm(swarm, mesh)(st, ys)[1]
                            .log_cond_like.sum()))
    out["swarm_totals"] = totals
    out["fetched"] = parallel.fetch_across_hosts(torch.full((2,), float(me)))
    try:
        parallel.make_mesh(3, 1)
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)
    if n == 4:
        out["hook_draws"] = hook_draws(d, 8)
    if n == 2:
        from ssme_tpu_torch import bench
        out["scaling"] = bench.scaling_rank("cpu", (1, 2), 32, 2, 2, 2, 40)
    return out


# --------------------------------------------------------------- particles


def _local(x):
    n = np.asarray(x).shape[0]
    sl = slice(dist.get_rank() * (n // dist.get_world_size()),
               (dist.get_rank() + 1) * (n // dist.get_world_size()))
    return t(x)[sl]


def _ring_and_gather(logw, leaves, seed, group=None):
    ring = spf.ring_resample(gen(seed), logw, leaves, group)
    anc = spf.sharded_systematic_ancestors(gen(seed), logw, group)
    return ring, tuple(all_gather_cat(v, group)[anc] for v in leaves)


def pf_checks(d):
    """The particle-axis invariants at this world size."""
    out = {"rank": dist.get_rank()}
    lw0 = _local(d["logw"])
    out["lse"] = spf.global_logsumexp(lw0)
    out["ess"] = spf.global_ess(lw0)
    out["positions"] = spf._partition_positions(lw0, torch.tensor(d["u0"]))
    out["ring"] = [_ring_and_gather(_local(w), (_local(d["xs"]),), s)
                   for s, w in enumerate(d["logw_sets"])]
    out["imbalance"] = spf.ring_resample(gen(0), _local(d["heavy"]),
                                         (_local(d["index"]),))[0]
    counts = torch.zeros(len(d["logw"]))
    for s in range(50):
        anc = spf.sharded_systematic_ancestors(gen(100 + s),
                                               _local(d["ramp"]))
        counts += torch.bincount(all_gather_cat(anc), minlength=len(counts))
    out["ancestor_freqs"] = counts / counts.sum()
    if "big_logw" in d:       # n_local = 2048 on two ranks
        out["big"] = _ring_and_gather(
            _local(d["big_logw"]), (_local(d["big_xs"]), _local(d["big_th"])),
            9)

    model = lgssm.make_model()
    params, ys = t(d["lgssm_params"]), t(d["lgssm_ys"])
    ring = spf.sharded_log_likelihood_fn(model, 256)
    gather = spf.sharded_log_likelihood_fn(model, 256, exchange="allgather")
    out["ll_ring"] = [float(ring(gen(s), params, ys)) for s in range(16)]
    out["ll_allgather"] = [float(gather(gen(s), params, ys))
                           for s in range(2)]
    gated = spf.sharded_log_likelihood_fn(model, 256, ess_threshold=0.5)
    out["ll_ess"] = [float(gated(gen(50 + s), params, ys)) for s in range(8)]
    mesh = parallel.make_mesh(1, dist.get_world_size())
    lev = svol_leverage.make_model()
    f = spf.make_sharded_ll_callable(lev, 64, mesh)
    out["ll_covariates"] = float(f(gen(0), t(d["lev_params"])[0],
                                   t(d["lev_ys"]), t(d["lev_zs"])))
    return out


# ---------------------------------------------------------------- Liu-West


def lw_checks(d):
    """The sharded Liu-West invariants at this world size."""
    n = dist.get_world_size()
    mesh = parallel.make_mesh(1, n)
    out = {"rank": dist.get_rank()}
    lev = svol_leverage.make_model()
    probe = ShardedLiuWest(lev, 64)
    out["components"] = probe._proposal_components(_local(d["trans"]),
                                                   _local(d["logw"]))
    ys, zs = t(d["lev_ys"]), t(d["lev_zs"])
    for variant in ("apf", "sisr"):
        lw = ShardedLiuWest(lev, 64, variant=variant,
                            functionals=(constant_42,))
        res = make_sharded_lw_runner(lw, mesh)(gen(0), ys, zs)
        out[f"const_{variant}"] = (res.expectations[0], res.ess,
                                   res.log_cond_likes)
    gated = ShardedLiuWest(lev, 64, ess_threshold=0.5)
    out["gated"] = make_sharded_lw_runner(gated, mesh)(gen(3), ys, zs)
    support = ShardedLiuWest(lev, 64, delta=0.95)
    res = make_sharded_lw_runner(support, mesh)(gen(5), ys, zs)
    out["params"] = support.param_samples(res)
    out["weights_shape"] = tuple(res.last_log_weights.shape)
    sl = particle_sharding(mesh, 64)
    out["future"] = support.sim_future_obs(
        gen(6), res.last_particles[sl], res.last_trans_params[sl], 5,
        last_obs=ys[-1])

    model = lgssm.make_model()
    lg_ys = t(d["lgssm_ys"])
    for variant in ("apf", "sisr"):
        lw = ShardedLiuWest(model, 256, variant=variant)
        run = make_sharded_lw_runner(lw, mesh)
        out[f"evidence_{variant}"] = [
            float(run(gen(200 + s), lg_ys).log_likelihood) for s in range(8)]
    return out





def hook_draws(d, seeds):
    """The sharded generic bank's (C,) over ``seeds`` generators."""
    mesh = parallel.make_mesh()
    ll = parallel.shard_batched_log_like(
        replicated_log_like_fn(svol.make_model(), 32, 2), mesh)
    return torch.stack([ll(gen(s), t(d["svol_params"]), t(d["ys"]))
                        for s in range(seeds)])


def fail():
    """A rank program that raises on rank 1."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    return dist.get_rank()


def hang(seconds):
    """A rank program whose rank 1 outlives the launcher's timeout."""
    if dist.get_rank() == 1:
        import time
        time.sleep(seconds)
    return dist.get_rank()
