"""Device meshes: the chain and particle axes over processes.

PyTorch counterpart of ``ssme_tpu/parallel/mesh.py``.  Each rank is one
process on one device; a mesh (``torch.distributed.device_mesh``) lays
the ranks out on a grid with dims ``("chain", "particle")``, and each
dim's process group carries that axis's collectives:

- **chain axis**: independent PMMH chains, replicate estimators, swarm
  members.  Each rank runs its slice of the chains with no communication
  until the results are gathered, the averaging pool's broadcast / map /
  reduce (``thread_pool.h:189-215, 259-273``) without locks or promises;
- **particle axis**: one filter's cloud split over ranks; normalisation
  and resampling become all-reduce and ring collectives
  (``parallel/sharded_pf.py``).

Where JAX compiles a program over the global arrays, every rank here
runs the local program on its slice and the wrappers gather what JAX's
global outputs hold: :func:`sharded_pmmh` and :func:`sharded_swarm`
compile nothing, hence their names.  At one rank everything degrades to
the unsharded run (a 1 x 1 mesh).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

CHAIN_AXIS = "chain"
PARTICLE_AXIS = "particle"


def make_mesh(num_chain_shards: Optional[int] = None,
              num_particle_shards: int = 1,
              device: Optional[str] = None,
              ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A (chain, particle) mesh over ``ranks`` of the default group (all
    by default; the counterpart of JAX's ``devices``), on ``device``
    ("cuda" under NCCL, "cpu" under gloo by default).  By default every
    rank lies on the chain axis.  Every rank of the default group calls
    it, members or not.
    """
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    if num_chain_shards is None:
        num_chain_shards = n // num_particle_shards
    if num_chain_shards * num_particle_shards != n:
        raise ValueError(
            f"mesh {num_chain_shards}x{num_particle_shards} != {n} devices")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    layout = torch.tensor(ranks).reshape(num_chain_shards,
                                         num_particle_shards)
    return DeviceMesh(device, layout,
                      mesh_dim_names=(CHAIN_AXIS, PARTICLE_AXIS))


def axis_slice(mesh: DeviceMesh, axis: str, size: int) -> slice:
    """This rank's slice of a ``size``-long axis split over the mesh's
    ``axis`` dim."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if size % n:
        raise ValueError(f"size {size} must be divisible by the mesh's "
                         f"{axis!r} axis size ({n})")
    k = size // n
    r = mesh.get_local_rank(axis)
    return slice(r * k, (r + 1) * k)


def chain_sharding(mesh: DeviceMesh, size: int) -> slice:
    """This rank's slice of a leading chain axis of ``size``."""
    return axis_slice(mesh, CHAIN_AXIS, size)


def particle_sharding(mesh: DeviceMesh, size: int) -> slice:
    """This rank's slice of a particle axis of ``size``."""
    return axis_slice(mesh, PARTICLE_AXIS, size)


def all_gather_cat(x: torch.Tensor, group=None, dim: int = 0):
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, on every rank of ``group``."""
    flag = x.dtype == torch.bool        # gloo gathers no bool
    src = (x.to(torch.uint8) if flag else x).contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if flag else out


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of the ranks' ``x``, on every rank."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise sum of the ranks' ``x``, on every rank."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _shard_leading(state, sl):
    """A NamedTuple with every tensor's leading axis, and every tuple
    (the chains' generators), cut to ``sl``; scalars stay."""
    def cut(v):
        sharded = isinstance(v, tuple) or (isinstance(v, torch.Tensor)
                                           and v.ndim > 0)
        return v[sl] if sharded else v
    return type(state)(*(cut(v) for v in state))


def shard_chain_state(state, mesh: DeviceMesh):
    """This rank's chains of a chain-leading state (a ``PMMHState``):
    each tensor's leading axis and the ``generators`` tuple cut to the
    rank's slice; the iteration counter stays.  Every rank passes the
    same global state (same seed), so each chain keeps its own generator
    and a chain-sharded run with per-chain likelihoods draws the bits
    of the unsharded one."""
    return _shard_leading(state, chain_sharding(
        mesh, state.trans_theta.shape[0]))


def sharded_pmmh(pmmh, mesh: DeviceMesh, num_iters: int):
    """``run(state, ys, zs=None) -> PMMHResult`` advancing this rank's
    chains (a state from :func:`shard_chain_state`) ``num_iters``
    iterations with ``pmmh.run_from``.  The per-iteration outputs come
    back gathered over the chain axis, (iters, C, ...) on every rank, as
    JAX's global arrays; ``final_state`` stays this rank's.  Ranks that
    share a chain coordinate (a particle axis > 1) run the same chains,
    as a particle-sharded likelihood needs."""
    group = mesh.get_group(CHAIN_AXIS)

    def run(state, ys, zs=None):
        res = pmmh.run_from(state, num_iters, ys, zs=zs)
        return type(res)(*(all_gather_cat(v, group, 1) for v in res[:-1]),
                         final_state=res.final_state)

    return run


def shard_swarm_state(state, mesh: DeviceMesh):
    """This rank's models of a ``SwarmState``: the model axis of params,
    particles and log-weights cut to the rank's chain slice (the
    split-data pool's fixed partition of models over threads,
    ``thread_pool.h:443-447``).  The port's swarm draws every model from
    one generator, so the rank's generator is folded with its chain
    coordinate (``ops/_prng.py::fold_generator``): ranks draw independent
    streams."""
    from ssme_tpu_torch.ops._prng import fold_generator
    local = _shard_leading(state, chain_sharding(mesh,
                                                 state.params.shape[0]))
    return local._replace(generator=fold_generator(
        state.generator, mesh.get_local_rank(CHAIN_AXIS)))


def _global_logmeanexp(v, group, n_shards):
    """log-mean-exp over the ranks of equal-count per-rank log-mean-exps
    ``v``: all-reduce MAX, then SUM of the shifted exps."""
    m = all_reduce_max(v, group)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (m + torch.log(all_reduce_sum(torch.exp(v - m), group))
            - math.log(float(n_shards)))


def _global_mean(v, group, n_shards):
    return all_reduce_sum(v, group) / float(n_shards)


def sharded_swarm(swarm, mesh: DeviceMesh):
    """``run(state, ys, zs=None) -> (final_state, SwarmResult)``: this
    rank's models (a state from :func:`shard_swarm_state`) through every
    observation with ``swarm.update``, then the per-step aggregates
    reduced over the chain axis: ``log_cond_like`` by a global
    log-mean-exp, the others by a global mean (the reference's two-level
    intra / inter-thread aggregation, ``thread_pool.h:540-562``).
    ``final_state`` stays this rank's."""
    from ssme_tpu_torch.inference.swarm import SwarmResult

    group = mesh.get_group(CHAIN_AXIS)
    n = mesh.size(mesh.mesh_dim_names.index(CHAIN_AXIS))

    def run(state, ys, zs=None):
        ys = torch.as_tensor(ys)
        if ys.ndim == 1:
            ys = ys[:, None]
        if swarm.model.has_covariates and zs is None:
            raise ValueError(
                f"model {swarm.model.name!r} requires covariates zs")
        results = []
        for t in range(ys.shape[0]):
            z = zs[t] if swarm.model.has_covariates else None
            state, res = swarm.update(state, ys[t], z)
            results.append(res)
        cols = [torch.stack(c) for c in zip(
            *[(r.log_cond_like, r.mean_log_cond_like) for r in results])]
        exps = tuple(torch.stack([r.expectations[k] for r in results])
                     for k in range(len(swarm.functionals)))
        return state, SwarmResult(
            log_cond_like=_global_logmeanexp(cols[0], group, n),
            mean_log_cond_like=_global_mean(cols[1], group, n),
            expectations=tuple(_global_mean(e, group, n) for e in exps))

    return run


__all__ = [
    "CHAIN_AXIS", "PARTICLE_AXIS", "make_mesh", "chain_sharding",
    "axis_slice", "all_gather_cat", "all_reduce_max", "all_reduce_sum",
    "particle_sharding", "shard_chain_state", "sharded_pmmh",
    "shard_swarm_state", "sharded_swarm",
]
