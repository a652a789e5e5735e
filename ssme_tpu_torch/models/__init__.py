"""State-space model specifications (batched PyTorch hooks)."""

from ssme_tpu_torch.models import (factor_svol, lgssm, poisson_ar, svol,
                                   svol_leverage, svol_t)
from ssme_tpu_torch.models.base import StateSpaceModel, bcol

__all__ = ["StateSpaceModel", "bcol", "factor_svol", "lgssm", "poisson_ar",
           "svol", "svol_leverage", "svol_t"]
