"""Inference algorithms."""

from ssme_tpu_torch.inference.pmmh import AdaptivePMMH, PMMHResult, PMMHState
from ssme_tpu_torch.inference.swarm import (SwarmFilter, SwarmResult,
                                            SwarmState, forecast_from_cloud)

__all__ = ["AdaptivePMMH", "PMMHResult", "PMMHState", "SwarmFilter",
           "SwarmResult", "SwarmState", "forecast_from_cloud"]
