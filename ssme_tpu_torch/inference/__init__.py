"""Inference algorithms."""

from ssme_tpu_torch.inference.pmmh import AdaptivePMMH, PMMHResult, PMMHState

__all__ = ["AdaptivePMMH", "PMMHResult", "PMMHState"]
