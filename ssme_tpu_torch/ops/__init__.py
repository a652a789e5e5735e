"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors (building the kernels'
library at first use, ``ops/_cuda.py``) and runs its plain version for
CPU tensors; on a CUDA tensor it never falls back.
"""

# the function filter_megakernel stays in its module, which it would
# shadow here (as in ssme_tpu.ops)
from ssme_tpu_torch.ops.filter_megakernel import (
    KernelModel, filter_megakernel_reference, megakernel_log_like,
    megakernel_swarm_evidence, svol_kernel_model, svol_leverage_kernel_model)
from ssme_tpu_torch.ops.svol_filter_kernel import (svol_batched_log_like,
                                                   svol_filter,
                                                   svol_filter_reference,
                                                   svol_replicated_log_like,
                                                   svol_swarm_evidence)

__all__ = ["svol_filter", "svol_filter_reference", "svol_batched_log_like",
           "svol_replicated_log_like", "svol_swarm_evidence", "KernelModel",
           "filter_megakernel_reference",
           "megakernel_log_like", "megakernel_swarm_evidence",
           "svol_kernel_model", "svol_leverage_kernel_model"]
