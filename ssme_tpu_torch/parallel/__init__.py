"""Multi-device and multi-process parallelism over ``torch.distributed``.

Counterpart of ``ssme_tpu/parallel``: a (chain, particle) device mesh,
chain-sharded PMMH and swarms, chain-sharded batched likelihood hooks
(the filter kernels), and particle-sharded bootstrap and Liu-West
filters with a ring resample.  NCCL for CUDA tensors, gloo when the
caller asks for the CPU.  Importing it forms no process group.
``sharded_pmmh`` and ``sharded_swarm`` stand for JAX's
``jit_sharded_pmmh`` and ``jit_sharded_swarm``: they compile nothing.
"""

from ssme_tpu_torch.parallel.distributed import (
    fetch_across_hosts,
    initialize_distributed,
    make_global_mesh,
    spawn_local,
)
from ssme_tpu_torch.parallel.kernel_sharded import (
    shard_batched_log_like,
    sharded_megakernel_log_like,
)
from ssme_tpu_torch.parallel.mesh import (
    make_mesh,
    chain_sharding,
    particle_sharding,
    shard_chain_state,
    sharded_pmmh,
    shard_swarm_state,
    sharded_swarm,
)
from ssme_tpu_torch.parallel.sharded_lw import (
    ShardedLiuWest,
    make_sharded_lw_runner,
)

__all__ = [
    "make_mesh", "chain_sharding", "particle_sharding",
    "shard_chain_state", "sharded_pmmh",
    "shard_batched_log_like", "sharded_megakernel_log_like",
    "initialize_distributed", "make_global_mesh", "fetch_across_hosts",
    "ShardedLiuWest", "make_sharded_lw_runner",
    "shard_swarm_state", "sharded_swarm", "spawn_local",
]
