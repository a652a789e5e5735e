"""Particle filters (generic PyTorch bank)."""

from ssme_tpu_torch.filters.bootstrap import (BootstrapFilter, FilterResult,
                                              log_likelihood_fn,
                                              replicated_log_like_fn)

__all__ = ["BootstrapFilter", "FilterResult", "log_likelihood_fn",
           "replicated_log_like_fn"]
