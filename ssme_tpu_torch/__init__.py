"""PyTorch / CUDA port of ``ssme_tpu``: adaptive PMMH on state-space
models, with the whole-sequence SVOL filter as a hand-written CUDA kernel
for Hopper (``ssme_tpu_torch/csrc``).

The package imports ``torch`` and ``numpy`` only, never ``jax``.  It
mirrors ``ssme_tpu``'s layout so every module has an obvious counterpart.

Float32 everywhere, and no reduced-precision contractions: a float32
contraction run at reduced precision put a +3.4-nat bias into a density
on the TPU, so TF32 (Hopper's counterpart) is switched off for matmuls
and cuDNN here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the subpackages, as ssme_tpu imports its own; none builds or loads
# anything here (the CUDA kernels build at their first launch on a CUDA
# tensor, ops/_cuda.py, and the native IO library at its first use), and
# none forms a process group (parallel/ joins one when asked)
from ssme_tpu_torch import transforms  # noqa: E402
from ssme_tpu_torch import rv  # noqa: E402
from ssme_tpu_torch import resampling  # noqa: E402
from ssme_tpu_torch import utils  # noqa: E402
from ssme_tpu_torch import models  # noqa: E402
from ssme_tpu_torch import filters  # noqa: E402
from ssme_tpu_torch import inference  # noqa: E402
from ssme_tpu_torch import io  # noqa: E402
from ssme_tpu_torch import native  # noqa: E402
from ssme_tpu_torch import diagnostics  # noqa: E402
from ssme_tpu_torch import profiling  # noqa: E402
from ssme_tpu_torch import parallel  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "transforms",
    "rv",
    "resampling",
    "utils",
    "models",
    "filters",
    "inference",
    "io",
    "native",
    "diagnostics",
    "profiling",
    "parallel",
    "__version__",
]
