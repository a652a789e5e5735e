"""Model specification: a state-space model as a frozen bundle of hooks.

PyTorch counterpart of ``ssme_tpu/models/base.py``.  JAX writes each hook
for ONE particle and lifts it with ``vmap``; here every hook takes the
whole batch at once:

- ``params``: (..., P) constrained parameters, one row per filter;
- ``x``: (..., N, dim_state) particle clouds with the same leading shape;
- log-density hooks return (..., N); samplers take a ``torch.Generator``.

=================  ==================================================
hook               signature
=================  ==================================================
``log_mu``         (params, x1) -> (..., N)
``sample_q1``      (gen, params, y1, n) -> (..., n, dim_state)
``log_q1``         (params, x1, y1) -> (..., N)
``sample_f``       (gen, params, x_prev, z) -> (..., N, dim_state)
``log_f``          (params, x, x_prev, z) -> (..., N)
``sample_q``       (gen, params, x_prev, y, z) -> (..., N, dim_state)
``log_q``          (params, x, x_prev, y, z) -> (..., N)
``log_g``          (params, y, x, z) -> (..., N)
``sample_g``       (gen, params, x) -> (..., N, dim_obs)
``log_prior``      (params) -> (...)
``sample_prior``   (gen, shape=()) -> (*shape, P) constrained prior draws
=================  ==================================================
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ssme_tpu_torch.transforms import ParamTransform


@dataclasses.dataclass(frozen=True, eq=False)
class StateSpaceModel:
    """A state-space model as pure batched hooks + shape config."""

    dim_state: int
    dim_obs: int
    transform: ParamTransform
    dim_cov: int = 0

    # required by every filter
    log_g: Callable = None
    sample_f: Callable = None
    sample_q1: Callable = None
    log_q1: Callable = None
    log_mu: Callable = None

    # optional hooks
    log_f: Callable = None
    sample_q: Callable = None     # general proposal of the SISR Liu-West
    log_q: Callable = None
    sample_g: Callable = None
    prop_mu: Callable = None
    log_prior: Callable = None
    sample_prior: Callable = None

    name: str = "ssm"

    @property
    def dim_param(self) -> int:
        return self.transform.dim

    @property
    def has_covariates(self) -> bool:
        return self.dim_cov > 0

    def replace(self, **kw) -> "StateSpaceModel":
        """A copy with the fields ``kw`` replaced
        (``ssme_tpu/models/base.py::StateSpaceModel.replace``)."""
        return dataclasses.replace(self, **kw)

    def require(self, *hooks: str) -> None:
        missing = [h for h in hooks if getattr(self, h) is None]
        if missing:
            raise ValueError(
                f"model {self.name!r} is missing hooks required by this "
                f"algorithm: {missing}")


def bcol(v):
    """Per-filter parameter column (...,) -> (..., 1, 1), broadcasting
    against (..., N, dim_state) clouds."""
    return v[..., None, None]


__all__ = ["StateSpaceModel", "bcol"]
