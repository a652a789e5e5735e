"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors (building the kernels'
library at first use, ``ops/_cuda.py``) and runs its plain version for
CPU tensors; on a CUDA tensor it never falls back.
"""

# the function filter_megakernel stays in its module, which it would
# shadow here (as in ssme_tpu.ops)
from ssme_tpu_torch.ops.filter_megakernel import (
    KernelModel, factor_svol_kernel_model, filter_megakernel_reference,
    megakernel_log_like, megakernel_swarm_evidence, poisson_ar_kernel_model,
    poisson_obs_rows, svol_kernel_model, svol_leverage_kernel_model,
    svol_t_kernel_model, svol_t_param_rows)
# the factory's decoders take the kernel model first, so they are aliased
# and do not shadow the leverage kernel's lw_cloud_params/_weights below
from ssme_tpu_torch.ops.liu_west_megakernel import (
    CUDA_LW_MODEL_IDS, MAX_LW_KERNEL_PARTICLES, LWKernelModel,
    lw_kernel_sim_future_obs, lw_megakernel, lw_megakernel_reference,
    svol_leverage_lw_kernel_model, svol_t_lw_kernel_model)
from ssme_tpu_torch.ops.liu_west_megakernel import (
    lw_cloud_params as lw_factory_cloud_params,
    lw_cloud_states as lw_factory_cloud_states,
    lw_cloud_weights as lw_factory_cloud_weights)
from ssme_tpu_torch.ops.svol_filter_kernel import (svol_batched_log_like,
                                                   svol_filter,
                                                   svol_filter_reference,
                                                   svol_replicated_log_like,
                                                   svol_swarm_evidence)
from ssme_tpu_torch.ops.svol_leverage_lw_kernel import (lw_cloud_params,
                                                        lw_cloud_weights,
                                                        svol_leverage_lw)

__all__ = ["svol_filter", "svol_filter_reference", "svol_batched_log_like",
           "svol_replicated_log_like", "svol_swarm_evidence", "KernelModel",
           "filter_megakernel_reference",
           "megakernel_log_like", "megakernel_swarm_evidence",
           "svol_kernel_model", "svol_leverage_kernel_model",
           "factor_svol_kernel_model", "poisson_ar_kernel_model",
           "poisson_obs_rows", "svol_t_kernel_model", "svol_t_param_rows",
           "LWKernelModel", "lw_megakernel", "lw_megakernel_reference",
           "lw_factory_cloud_params", "lw_factory_cloud_weights",
           "lw_factory_cloud_states", "lw_kernel_sim_future_obs",
           "svol_leverage_lw_kernel_model", "svol_t_lw_kernel_model",
           "CUDA_LW_MODEL_IDS", "MAX_LW_KERNEL_PARTICLES",
           "svol_leverage_lw", "lw_cloud_params", "lw_cloud_weights"]
