"""Chain-axis sharding for batched PMMH likelihood hooks.

PyTorch counterpart of ``ssme_tpu/parallel/kernel_sharded.py``.
``ops.filter_megakernel.megakernel_log_like``,
``ops.svol_filter_kernel.svol_batched_log_like`` and the generic bank
``filters.bootstrap.replicated_log_like_fn`` run every chain x replicate
row of a PMMH likelihood in one call on one device.  The wrapper here
splits those rows over a mesh axis: each rank runs the inner hook on its
``C / D`` rows (one kernel launch), and the results are gathered, so
every rank returns the whole (C,) as JAX's global output.  Chains are
independent (``ada_pmmh_mvn.h:326-372``), so the only collective is that
gather.

Per-rank streams: the shared generator is folded with the rank's axis
coordinate (``ops/_prng.py::fold_generator``, tag 0xA0000000, the
counterpart of ``jax.random.fold_in(key, axis_index)``), from its
host-side state, so the hook never waits for the device.  The sharded
result is bit for bit the concatenation of ``inner(fold_generator(gen,
r), params[r-th slice], ys)`` over the ranks r
(``tests/test_torch_parallel_chain.py``).  Against the unsharded call
it agrees in distribution.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from ssme_tpu_torch.ops._prng import fold_generator
from ssme_tpu_torch.ops.filter_megakernel import megakernel_log_like
from ssme_tpu_torch.parallel.mesh import CHAIN_AXIS, all_gather_cat


def shard_batched_log_like(inner, mesh: DeviceMesh, axis: str = CHAIN_AXIS):
    """Wrap a batched hook ``inner(gen, params (C, P), ys[, zs]) -> (C,)``
    so that each rank runs it on its rows of ``params`` along the mesh's
    ``axis``, with the generator folded by the rank's coordinate, and
    every rank returns the gathered (C,).

    Every rank passes the same arguments; ``C`` must be divisible by the
    axis size.  ``zs`` reaches ``inner`` only when given (the SVOL
    kernel's hook takes none).
    """
    n_shards = mesh.size(mesh.mesh_dim_names.index(axis))
    me = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)

    def ll(gen, params, ys, zs=None):
        c = params.shape[0]
        if c % n_shards:
            raise ValueError(
                f"num chains C={c} must be divisible by the mesh's "
                f"{axis!r} axis size ({n_shards})")
        k = c // n_shards
        cov = () if zs is None else (zs,)
        out = inner(fold_generator(gen, me), params[me * k:(me + 1) * k],
                    ys, *cov)
        return all_gather_cat(out, group)

    return ll


def sharded_megakernel_log_like(kmodel, num_particles: int,
                                num_replicates: int, mesh: DeviceMesh,
                                constrain=None, ess_threshold: float = 0.5,
                                *, axis: str = CHAIN_AXIS,
                                gate_stride: int = 1,
                                resampler: str = "systematic",
                                metropolis_iters: int = None,
                                metropolis_bias_budget: float = 0.5):
    """PMMH ``batched_log_like`` hook with the chains split over the
    mesh's ``axis``: each rank launches the generic filter kernel once
    on its ``C / D`` chains x ``num_replicates`` rows.  The keyword-only
    knobs pass through to ``megakernel_log_like``;
    :func:`shard_batched_log_like` gives the sharding."""
    inner = megakernel_log_like(kmodel, num_particles, num_replicates,
                                constrain=constrain,
                                ess_threshold=ess_threshold,
                                gate_stride=gate_stride,
                                resampler=resampler,
                                metropolis_iters=metropolis_iters,
                                metropolis_bias_budget=metropolis_bias_budget)
    return shard_batched_log_like(inner, mesh, axis)


__all__ = ["shard_batched_log_like", "sharded_megakernel_log_like"]
