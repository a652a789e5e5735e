"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors (building the kernels'
library at first use, ``ops/_cuda.py``) and runs its plain version for
CPU tensors; on a CUDA tensor it never falls back.
"""

from ssme_tpu_torch.ops.svol_filter_kernel import (svol_batched_log_like,
                                                   svol_filter,
                                                   svol_filter_reference,
                                                   svol_replicated_log_like)

__all__ = ["svol_filter", "svol_filter_reference", "svol_batched_log_like",
           "svol_replicated_log_like"]
