"""Whole-sequence Liu-West filtering of SVOL with leverage, the kernel
engine of ``examples/liu_west_leverage``.

Replaces ``ssme_tpu/ops/svol_leverage_lw_kernel.py::svol_leverage_lw_pallas``,
the Pallas kernel hand-fused for this one model.  In JAX that kernel and
the factory's ``svol_leverage_lw`` instance draw the same bits and compute
the same numbers (``tests/test_lw_factory.py``), so the port has one
kernel for both: :func:`svol_leverage_lw` builds the lagged covariates
z_t = y_{t-1}, z_0 = 0, and runs the ``svol_leverage_lw`` instance of the
Liu-West kernel (``ops/liu_west_megakernel.py``).  The Pallas kernel reads
y_{t-1} at t > 0 and its t = 0 step uses no covariate, so the two compute
the same function.
"""

from __future__ import annotations

from ssme_tpu_torch import profiling
from ssme_tpu_torch.models.svol_leverage import lagged_covariates
from ssme_tpu_torch.ops import liu_west_megakernel as _lw
from ssme_tpu_torch.ops.liu_west_megakernel import (
    lw_megakernel, svol_leverage_lw_kernel_model)

N_PARAM = 4  # phi, mu, sigma, rho
# the profiling spans opened here: each call, and its lagged covariates
# (``lw_megakernel`` opens the call's ``lw.validate`` and, on the card,
# ``lw_megakernel.launch``)
HOST_SPANS = ("lw.svol_leverage_lw", "lw.covariates")


def svol_leverage_lw(seed, ys, num_filters=1, num_particles=512, delta=0.99,
                     prior_bounds=None, resample_every=1, variant="apf",
                     ess_threshold=0.0):
    """``num_filters`` whole-sequence Liu-West filters of the leverage
    model in one launch.

    seed: (2,) int64 Philox key words or a Python int; ys: (T,) or (T, 1)
    float32 observations; ``prior_bounds``: the uniform box of (phi, mu,
    sigma, rho), default the model's.  ``variant`` "apf" or "sisr".
    Returns ``log_cond_likes`` (F, T), ``log_likelihood`` (F,) and
    ``cloud`` (F, 6, N) with rows [x, logw, theta_trans x 4].  Launches
    the kernel for CUDA tensors and runs the plain version for CPU
    tensors.
    """
    with profiling.span("lw.svol_leverage_lw"):
        ys = ys.reshape(-1)
        bounds = None if prior_bounds is None else tuple(
            (float(lo), float(hi)) for lo, hi in prior_bounds)
        with profiling.span("lw.covariates"):
            zs = lagged_covariates(ys)[:, 0].contiguous()
        out = lw_megakernel(svol_leverage_lw_kernel_model(bounds), seed, ys,
                            zs, num_filters=num_filters,
                            num_particles=num_particles, delta=delta,
                            resample_every=resample_every, variant=variant,
                            ess_threshold=ess_threshold)
        if ys.device.type == "cuda":
            svol_leverage_lw.launches += 1
        return out


# launches through this wrapper; ops/_cuda.py counts the launches
# themselves, and this count stays only for the benchmark's fault tests
svol_leverage_lw.launches = 0


def lw_cloud_params(cloud):
    """(F, 6, N) cloud -> (F, N, 4) constrained (phi, mu, sigma, rho)
    particles.  With every-step resampling the final cloud is uniformly
    weighted; otherwise combine with :func:`lw_cloud_weights`."""
    return _lw.lw_cloud_params(svol_leverage_lw_kernel_model(), cloud)


def lw_cloud_weights(cloud):
    """(F, 6, N) cloud -> (F, N) normalised weights (row 1 holds the
    carried log-weights)."""
    return _lw.lw_cloud_weights(svol_leverage_lw_kernel_model(), cloud)


__all__ = ["svol_leverage_lw", "lw_cloud_params", "lw_cloud_weights",
           "N_PARAM"]
