"""State-space model specifications (batched PyTorch hooks)."""

from ssme_tpu_torch.models import svol, svol_leverage
from ssme_tpu_torch.models.base import StateSpaceModel, bcol

__all__ = ["StateSpaceModel", "bcol", "svol", "svol_leverage"]
