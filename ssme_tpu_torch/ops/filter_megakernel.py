"""Generic whole-sequence bootstrap filter bank over model hooks: the CUDA
template kernel and its plain PyTorch version.

Replaces the bootstrap mode of
``ssme_tpu/ops/filter_megakernel.py::filter_megakernel``.  A
:class:`KernelModel` supplies, over (B, N) particle blocks,

- ``init(rng, p, y, z, shape) -> state``        the time-1 draw
- ``propagate(rng, p, state, y, z) -> state``   the transition draw
- ``log_weight(p, state, y, z) -> (B, N)``      the observation density
- optional ``functional(p, state) -> (B, N)``   whose filtered mean is
  emitted per step (default: the first state leaf)

with ``p`` the (B, num_params) constrained parameter rows, ``y``/``z``
tuples of the step's observation and covariate scalars, ``state`` a
tuple of ``num_state`` (B, N) leaves and ``rng.normal(shape)`` the
kernel's Philox normals of the current step (``ops/_prng.py``: draw 0 on
the first call of a hook, draw 1 on the second, ...).

The kernel is ``csrc/filter_megakernel.cu``, one template over the model
functors of ``csrc/kernel_models.cuh``; its header comment gives the
step recursion, the layout and the intended divergences from the Pallas
kernel.  A hook written in Python cannot be compiled into it: on a CUDA
tensor only a model whose ``cuda_instance`` names a functor there runs,
and any other model raises.  On a CPU tensor every model runs through
:func:`filter_megakernel_reference`, which calls the hooks step by step
with the kernel's random bits.

Not ported yet (ROADMAP.md section 2, K2): ``mode="apf"``, the vector
``functionals``, the other instances (factor_svol, poisson_ar, svol_t),
the large-N bridge ``model=`` and the metropolis / rejection resamplers.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from ssme_tpu_torch.models.svol_leverage import STATE_CLAMP
from ssme_tpu_torch.ops import _cuda, _prng
from ssme_tpu_torch.ops._select import (MAX_PARTICLES, check_particles,
                                        systematic_select_reference)
from ssme_tpu_torch.ops.svol_filter_kernel import (_BLOCK_ELEMENTS,
                                                   _draw_seed, _kernel_rows)
from ssme_tpu_torch.utils import logmeanexp

# the dispatch table of csrc/kernel_models.cuh (same names, same numbers;
# tests/test_torch_megakernel.py parses the header and compares)
CUDA_MODEL_IDS = {"svol": 0, "svol_leverage": 1}

_NOT_PORTED = ("is not ported to the PyTorch/CUDA package yet "
               "(ROADMAP.md section 2, item 1: K2 remainder)")


@dataclasses.dataclass(frozen=True, eq=False)
class KernelModel:
    """A model as batched hooks (see the module docstring).

    ``cuda_instance``: the name of the functor in ``csrc/kernel_models.cuh``
    that computes the same hooks, or None for a model that runs on CPU
    tensors only.
    """

    num_params: int
    init: Callable
    propagate: Callable
    log_weight: Callable
    num_state: int = 1
    dim_obs: int = 1
    dim_cov: int = 0
    functional: Callable = None   # default: first state leaf
    functionals: tuple = None     # vector functionals: not ported
    name: str = "kernel_model"
    cuda_instance: str = None

    def functional_fn(self):
        return self.functional or (lambda p, state: state[0])


class _PlainRng:
    """The ``rng`` the plain version hands to the hooks: ``normal(shape)``
    returns the (B, N) Philox normals the kernel draws at the current
    step, draw 0 on a hook's first call, draw 1 on its second, and so on.
    Draw 0 and the resampling offsets are drawn for blocks of steps."""

    HALF_LOG_2PI = _prng.HALF_LOG_2PI

    def __init__(self, seed, rows, num_particles, num_steps):
        self._seed, self._rows, self._n = seed, rows, num_particles
        self._t_len = num_steps
        self._span = max(1, _BLOCK_ELEMENTS // (rows.numel() * num_particles))
        self._start = None
        self.t = 0
        self._draw = 0

    def at(self, t):
        """Begin one hook call at step ``t``."""
        self.t, self._draw = t, 0
        return self

    def _fill(self, t):
        if self._start is None or not (
                self._start <= t < self._start + self._span):
            self._start = t
            steps = torch.arange(t, min(t + self._span, self._t_len),
                                 device=self._seed.device)
            self._normals = _prng.normals_steps(self._seed, self._rows,
                                                steps, self._n)
            self._offsets = _prng.offsets_steps(self._seed, self._rows,
                                                steps)

    def normal(self, shape):
        draw, t = self._draw, self.t
        self._draw += 1
        if draw == 0:
            self._fill(t)
            z = self._normals[t - self._start]
        else:
            z = _prng.normals_steps(
                self._seed, self._rows,
                torch.arange(t, t + 1, device=self._seed.device), self._n,
                draw=draw)[0]
        if tuple(shape) != tuple(z.shape):
            raise ValueError(f"rng.normal({tuple(shape)}): the kernel draws "
                             f"one normal per particle, {tuple(z.shape)}")
        return z

    def offsets(self, t):
        self._fill(t)
        return self._offsets[t - self._start]


def _as_rows(name, v, t_len, width, dev):
    """(T,) or (T, width) -> (T, width) view; raises on other shapes."""
    if not isinstance(v, torch.Tensor):
        raise ValueError(f"{name} must be a tensor")
    if v.ndim == 1 and width == 1:
        v = v[:, None]
    if v.ndim != 2 or v.shape[1] != width or v.shape[0] < 1 or (
            t_len is not None and v.shape[0] != t_len):
        want = f"({t_len or 'T'}, {width})"
        raise ValueError(f"{name} must be {want}, got {tuple(v.shape)}")
    if v.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {v.dtype}")
    if v.device != dev:
        raise ValueError(f"{name} is on {v.device}, params on {dev}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return v


def _validate(kmodel, seed, params, ys, zs, num_particles, ess_threshold,
              gate_stride, mode, resampler):
    if mode != "bootstrap":
        raise ValueError(f"mode={mode!r}: only the bootstrap mode runs; "
                         f"the auxiliary-PF mode {_NOT_PORTED}")
    if resampler != "systematic":
        raise ValueError(f"resampler={resampler!r} is not ported to the "
                         "PyTorch/CUDA package yet (ROADMAP.md section 2, "
                         "item 2); the systematic selection has no "
                         "particle cap below the kernel's 1024")
    if kmodel.functionals is not None:
        raise ValueError(f"model {kmodel.name!r}: vector functionals "
                         f"{_NOT_PORTED}")
    if not isinstance(params, torch.Tensor) or params.ndim != 2 \
            or params.shape[1] != kmodel.num_params or params.shape[0] < 1:
        raise ValueError(f"params must be a (B, {kmodel.num_params}) tensor "
                         f"of model {kmodel.name!r} rows")
    if params.dtype != torch.float32 or not params.is_contiguous():
        raise ValueError("params must be contiguous float32")
    dev = params.device
    ys = _as_rows("ys", ys, None, kmodel.dim_obs, dev)
    if kmodel.dim_cov:
        if zs is None:
            raise ValueError(f"model {kmodel.name!r} needs covariates zs")
        zs = _as_rows("zs", zs, ys.shape[0], kmodel.dim_cov, dev)
    elif zs is not None:
        raise ValueError(f"model {kmodel.name!r} has dim_cov=0 but "
                         "covariates zs were supplied")
    seed = _prng.seed_words(seed, device=dev)
    if seed.device != dev:
        raise ValueError(f"seed is on {seed.device}, params on {dev}")
    check_particles(int(num_particles))
    if int(gate_stride) != gate_stride or gate_stride < 1:
        raise ValueError("gate_stride must be a positive integer")
    if gate_stride > 1 and ess_threshold >= 1.0:
        raise ValueError(
            "gate_stride > 1 accumulates weights between ESS checks; the "
            "every-step schedule (ess_threshold >= 1) requires "
            "gate_stride=1")
    return seed, ys, zs


def _resample_rows(wn, u0, state, lw, carry, fire, log_n):
    """Systematic resample of every leaf of the rows where ``fire`` (a
    (B, 1) bool tensor, or True for all rows) with offsets ``u0`` (B,)."""
    picked, _ = systematic_select_reference(wn, torch.stack(state), u0)
    if fire is True:
        return (tuple(picked), torch.zeros_like(lw),
                torch.full_like(carry, log_n))
    return (tuple(torch.where(fire, new, old)
                  for new, old in zip(picked, state)),
            torch.where(fire, torch.zeros_like(lw), lw),
            torch.where(fire, torch.full_like(carry, log_n), carry))


def filter_megakernel_reference(kmodel, seed, params, ys, zs=None,
                                num_particles=512, ess_threshold=1.0,
                                gate_stride=1, return_cloud=False,
                                mode="bootstrap", resampler="systematic"):
    """Plain PyTorch version of :func:`filter_megakernel`, callable on
    either device and with any :class:`KernelModel`; consumes the
    kernel's Philox bits step by step."""
    seed, ys, zs = _validate(kmodel, seed, params, ys, zs, num_particles,
                             ess_threshold, gate_stride, mode, resampler)
    n, g = int(num_particles), int(gate_stride)
    b, t_len = params.shape[0], ys.shape[0]
    dev = params.device
    log_n = math.log(float(n))
    always = ess_threshold >= 1.0
    ess_limit = float(ess_threshold) * n
    functional = kmodel.functional_fn()
    rng = _PlainRng(seed, torch.arange(b, device=dev), n, t_len)

    lcl = torch.zeros((b, t_len), dtype=torch.float32, device=dev)
    fmean = torch.zeros_like(lcl)
    carry = torch.full((b, 1), log_n, dtype=torch.float32, device=dev)
    s_last = s2_last = torch.ones_like(carry)
    for t in range(t_len):
        y = tuple(ys[t].unbind())
        z = () if zs is None else tuple(zs[t].unbind())
        if t == 0:
            state = tuple(kmodel.init(rng.at(0), params, y, z, (b, n)))
            lw = torch.zeros((b, n), dtype=torch.float32, device=dev)
            wn = torch.ones_like(lw)
        else:
            if g == 1:
                fire = True if always else s_last * s_last / s2_last < \
                    ess_limit
                state, lw, carry = _resample_rows(wn, rng.offsets(t), state,
                                                  lw, carry, fire, log_n)
            state = tuple(kmodel.propagate(rng.at(t), params, state, y, z))
        lw = lw + kmodel.log_weight(params, state, y, z)
        if not (g == 1 or t % g == g - 1 or t == t_len - 1):
            continue
        m = torch.amax(lw, dim=-1, keepdim=True)
        wn = torch.exp(lw - m)
        s = wn.sum(-1, keepdim=True)
        s2 = (wn * wn).sum(-1, keepdim=True)
        lcl[:, t] = ((m + torch.log(s)) - carry)[:, 0]
        fmean[:, t] = ((functional(params, state) * wn).sum(-1, keepdim=True)
                       / s)[:, 0]
        lw = lw - m
        carry = torch.log(s)
        s_last, s2_last = s, s2
        if g > 1:
            state, lw, carry = _resample_rows(wn, rng.offsets(t), state, lw,
                                              carry, s * s / s2 < ess_limit,
                                              log_n)
    if return_cloud:
        return lcl.sum(-1), lcl, fmean, state, lw
    return lcl.sum(-1), lcl, fmean


def _model_id(kmodel) -> int:
    if kmodel.cuda_instance is None:
        raise ValueError(
            f"model {kmodel.name!r} has no CUDA instance: on a CUDA tensor "
            "only the functors of csrc/kernel_models.cuh run "
            f"({sorted(CUDA_MODEL_IDS)}); a model written as Python hooks "
            "runs on CPU tensors, through the plain version (ROADMAP.md "
            "section 3, D1)")
    try:
        return CUDA_MODEL_IDS[kmodel.cuda_instance]
    except KeyError:
        raise ValueError(f"unknown CUDA instance {kmodel.cuda_instance!r}; "
                         f"valid: {sorted(CUDA_MODEL_IDS)}") from None


def filter_megakernel(kmodel, seed, params, ys, zs=None, num_particles=512,
                      ess_threshold=1.0, gate_stride=1, return_cloud=False,
                      mode="bootstrap", resampler="systematic"):
    """B whole-sequence bootstrap filters of ``kmodel`` in one launch.

    seed: (2,) int64 Philox key words on the params' device, or a Python
    int; params: (B, num_params) float32 constrained rows; ys: (T,) or
    (T, dim_obs); zs: (T,) or (T, dim_cov) covariates, required iff the
    model has them.  ``num_particles`` is a multiple of 32 in [32, 1024].
    Returns (total (B,), lcl (B, T), fmean (B, T)): total = sum_t
    log p(y_t | y_{1:t-1}); fmean the filtered mean of the model's
    functional.  ``return_cloud`` appends (cloud, cloud_log_weights): a
    tuple of ``num_state`` (B, N) leaves after the last observation and
    the (B, N) max-normalised carried log-weights.

    ess_threshold: resample when a row's ESS falls below this fraction of
    N (1.0 = every step).  gate_stride g > 1 (ESS-adaptive schedules
    only): weights accumulate between checks at t = g-1 (mod g) and
    t = T-1; lcl and fmean are zero off those columns and sum(lcl) stays
    the exact evidence.

    Launches the kernel for CUDA tensors (raising for a model without a
    CUDA instance) and runs :func:`filter_megakernel_reference` for CPU
    tensors.  Only ``mode="bootstrap"`` and ``resampler="systematic"``
    are ported; the others raise.
    """
    seed, ys, zs = _validate(kmodel, seed, params, ys, zs, num_particles,
                             ess_threshold, gate_stride, mode, resampler)
    if params.device.type == "cpu":
        return filter_megakernel_reference(kmodel, seed, params, ys, zs,
                                           num_particles, ess_threshold,
                                           gate_stride, return_cloud)
    if params.device.type != "cuda":
        raise ValueError(f"filter_megakernel: unsupported device "
                         f"{params.device}")
    model_id = _model_id(kmodel)
    lib = _cuda.library()
    b, t_len, n = params.shape[0], ys.shape[0], int(num_particles)
    dev = params.device
    total = torch.empty((b,), dtype=torch.float32, device=dev)
    lcl = torch.empty((b, t_len), dtype=torch.float32, device=dev)
    fmean = torch.empty_like(lcl)
    cloud = cloud_lw = None
    if return_cloud:
        cloud = torch.empty((kmodel.num_state, b, n), dtype=torch.float32,
                            device=dev)
        cloud_lw = torch.empty((b, n), dtype=torch.float32, device=dev)
    err = lib.ssme_filter_megakernel(
        model_id, seed.data_ptr(), params.data_ptr(), ys.data_ptr(),
        None if zs is None else zs.data_ptr(), b, t_len, n,
        float(ess_threshold) * n, int(ess_threshold >= 1.0),
        int(gate_stride), total.data_ptr(), lcl.data_ptr(),
        fmean.data_ptr(), None if cloud is None else cloud.data_ptr(),
        None if cloud_lw is None else cloud_lw.data_ptr(),
        _cuda.stream_ptr(dev))
    _cuda.check(err, "ssme_filter_megakernel")
    filter_megakernel.launches += 1
    if return_cloud:
        return total, lcl, fmean, tuple(cloud.unbind(0)), cloud_lw
    return total, lcl, fmean


filter_megakernel.launches = 0


def megakernel_log_like(kmodel, num_particles: int, num_replicates: int,
                        constrain=None, ess_threshold: float = 0.5,
                        gate_stride: int = 1):
    """PMMH ``batched_log_like`` hook for a kernel model: all chains x
    replicates in ONE launch.

    Returns ``ll(gen, params (C, P), ys, zs=None) -> (C,)``.  ``constrain``
    maps the PMMH's constrained parameters to kernel rows (e.g. ss ->
    sigma).  Rows are chain-major (row c*R + r is replicate r of chain c),
    reduced by a per-chain log-mean-exp.  The two seed words are drawn on
    the device with ``gen``, so the host never waits.  No padding rows:
    the ESS gate is per row.
    """
    if num_particles > MAX_PARTICLES:
        raise ValueError(
            f"num_particles={num_particles} exceeds the kernel's "
            f"{MAX_PARTICLES}; the large-N bridge to the generic bank "
            f"(model=) {_NOT_PORTED}")
    r = num_replicates

    def ll(gen, params, ys, zs=None):
        c = params.shape[0]
        p = constrain(params) if constrain is not None else params
        rows = p[:, None].expand(c, r, p.shape[1]).reshape(
            c * r, p.shape[1]).contiguous()
        vals, _, _ = filter_megakernel(kmodel, _draw_seed(gen, p.device),
                                       rows, ys, zs,
                                       num_particles=num_particles,
                                       ess_threshold=ess_threshold,
                                       gate_stride=gate_stride)
        return logmeanexp(vals.reshape(c, r), dim=-1)

    return ll


def megakernel_swarm_evidence(kmodel, seed, param_draws, ys, zs=None,
                              num_particles: int = 512,
                              ess_threshold: float = 1.0,
                              return_cloud: bool = False,
                              gate_stride: int = 1):
    """Swarm conditional evidence for a kernel model: one filter per
    parameter draw (the kernel's row axis), per-step aggregation across
    models.

    Returns the JAX keys: ``log_cond_like`` (T,) = logmeanexp over models,
    ``mean_log_cond_like`` (T,) = the arithmetic mean of logs,
    ``per_model_log_cond_likes`` (M, T), ``functional_path`` (T,) and
    ``functional_paths`` (a one-element tuple); with ``return_cloud`` also
    ``final_cloud`` (tuple of ``num_state`` (M, N)) and
    ``final_log_weights`` (M, N), the input of
    :func:`ssme_tpu_torch.inference.swarm.forecast_from_cloud`.  With
    ``gate_stride > 1`` the per-model lcls coarsen to per-check block
    sums (totals unchanged) and the functional path is zero off the check
    columns.
    """
    outs = filter_megakernel(kmodel, seed, param_draws.contiguous(), ys, zs,
                             num_particles=num_particles,
                             ess_threshold=ess_threshold,
                             return_cloud=return_cloud,
                             gate_stride=gate_stride)
    _, lcls, fmean = outs[:3]
    paths = (fmean.mean(0),)
    result = {
        "log_cond_like": logmeanexp(lcls, dim=0),
        "mean_log_cond_like": lcls.mean(0),
        "per_model_log_cond_likes": lcls,
        "functional_path": paths[0],
        "functional_paths": paths,
    }
    if return_cloud:
        result["final_cloud"] = outs[3]
        result["final_log_weights"] = outs[4]
    return result


# ---------------------------------------------------------------------------
# Kernel models of the built-in families, memoised as in JAX
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def svol_kernel_model() -> KernelModel:
    """Univariate SVOL; rows (beta, phi, sigma) (see
    :func:`svol_kernel_rows`).  CUDA instance ``SvolModel``, which draws
    exactly the bits of ``csrc/svol_filter.cu``."""

    def init(rng, p, y, z, shape):
        phi, sigma = p[:, 1:2], p[:, 2:3]
        return (rng.normal(shape) * (sigma / torch.sqrt(1.0 - phi * phi)),)

    def propagate(rng, p, state, y, z):
        phi, sigma = p[:, 1:2], p[:, 2:3]
        (x,) = state
        return (phi * x + sigma * rng.normal(x.shape),)

    def log_weight(p, state, y, z):
        beta = p[:, 0:1]
        (x,) = state
        zval = (y[0] / beta) * torch.exp(-0.5 * x)
        return ((-_prng.HALF_LOG_2PI - torch.log(beta)) - 0.5 * x
                - 0.5 * zval * zval)

    return KernelModel(num_params=3, init=init, propagate=propagate,
                       log_weight=log_weight, name="svol",
                       cuda_instance="svol")


# constrained (beta, phi, ss) rows -> svol_kernel_model rows (beta, phi, sigma)
svol_kernel_rows = _kernel_rows


@functools.lru_cache(maxsize=None)
def svol_leverage_kernel_model() -> KernelModel:
    """SVOL with leverage (``models/svol_leverage.py``); rows (phi, mu,
    sigma, rho); covariate z = the lagged observation.  The transition
    mean is clamped to +-STATE_CLAMP, as in the model.  CUDA instance
    ``SvolLeverageModel``."""

    def init(rng, p, y, z, shape):
        phi, sigma = p[:, 0:1], p[:, 2:3]
        return (rng.normal(shape) * (sigma / torch.sqrt(1.0 - phi * phi)),)

    def propagate(rng, p, state, y, z):
        phi, mu, sigma, rho = p[:, 0:1], p[:, 1:2], p[:, 2:3], p[:, 3:4]
        (x,) = state
        mean = torch.clamp(mu + phi * (x - mu)
                           + z[0] * rho * sigma * torch.exp(-0.5 * x),
                           -STATE_CLAMP, STATE_CLAMP)
        sd = sigma * torch.sqrt(1.0 - rho * rho)
        return (mean + sd * rng.normal(x.shape),)

    def log_weight(p, state, y, z):
        (x,) = state
        zval = y[0] * torch.exp(-0.5 * x)
        return -_prng.HALF_LOG_2PI - 0.5 * x - 0.5 * zval * zval

    return KernelModel(num_params=4, init=init, propagate=propagate,
                       log_weight=log_weight, dim_cov=1,
                       name="svol_leverage", cuda_instance="svol_leverage")


def _not_ported(name):
    def factory(*args, **kwargs):
        raise ValueError(f"{name}: the {name.removesuffix('_kernel_model')} "
                         f"instance {_NOT_PORTED}")
    factory.__name__ = factory.__qualname__ = name
    return factory


# the JAX package's other instances, with their model families
factor_svol_kernel_model = _not_ported("factor_svol_kernel_model")
poisson_ar_kernel_model = _not_ported("poisson_ar_kernel_model")
svol_t_kernel_model = _not_ported("svol_t_kernel_model")


__all__ = ["KernelModel", "filter_megakernel", "filter_megakernel_reference",
           "megakernel_log_like", "megakernel_swarm_evidence",
           "svol_kernel_model", "svol_kernel_rows",
           "svol_leverage_kernel_model", "CUDA_MODEL_IDS"]
