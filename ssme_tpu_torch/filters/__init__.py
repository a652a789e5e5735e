"""Particle filters (generic PyTorch bank)."""

from ssme_tpu_torch.filters.auxiliary import AuxiliaryParticleFilter
from ssme_tpu_torch.filters.bootstrap import (BootstrapFilter, FilterResult,
                                              log_likelihood_fn,
                                              replicated_log_like_fn)
from ssme_tpu_torch.filters.liu_west import (LiuWestFilter, LiuWestResult,
                                             LWState)

__all__ = ["AuxiliaryParticleFilter", "BootstrapFilter", "FilterResult", "log_likelihood_fn",
           "replicated_log_like_fn", "LiuWestFilter", "LiuWestResult",
           "LWState"]
