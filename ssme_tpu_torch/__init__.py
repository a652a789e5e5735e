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

__version__ = "0.1.0"
