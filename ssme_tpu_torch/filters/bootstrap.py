"""Bootstrap particle filter bank (the generic, model-agnostic path).

PyTorch counterpart of ``ssme_tpu/filters/bootstrap.py``.  ``vmap`` over
particles, replicates and chains becomes leading batch dimensions of one
tensor; ``lax.scan`` over time becomes a Python loop.  This is the
``impl=xla`` path of the JAX bench and the port's ``--engine generic``.

  t = 1:  x ~ q1,  logw = log mu + log g - log q1,
          log p(y_1) ~= -log N + LSE(logw)
  t > 1:  (resample on schedule; weights reset to 0)
          x ~ f(. | x_prev),  logw += log g(y_t | x)
          log p(y_t | y_{1:t-1}) ~= LSE(logw_t) - LSE(logw_{t-1})
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Tuple

import torch

from ssme_tpu_torch import resampling
from ssme_tpu_torch.models.base import StateSpaceModel
from ssme_tpu_torch.utils import ess, logmeanexp, logsumexp, \
    weighted_expectation


def apply_functionals(model, functionals, particles, z, params, log_w):
    """Per-step weighted expectations of ``h(x, params)`` (or
    ``h(x, z, params)`` for covariate models); ``h`` maps
    (..., N, dim_state) to (..., N, k)."""
    outs = []
    for h in functionals:
        vals = (h(particles, z, params) if model.has_covariates
                else h(particles, params))
        outs.append(weighted_expectation(vals, log_w))
    return tuple(outs)


class FilterResult(NamedTuple):
    log_likelihood: torch.Tensor      # (...,)
    log_cond_likes: torch.Tensor      # (..., T)
    expectations: Tuple[torch.Tensor, ...]  # per functional: (..., T, k)
    ess: torch.Tensor                 # (..., T)
    last_particles: torch.Tensor      # (..., N, dim_state)
    last_log_weights: torch.Tensor    # (..., N)


@dataclasses.dataclass(frozen=True, eq=False)
class BootstrapFilter:
    """Bootstrap filter configuration bound to a model.

    ``ess_threshold`` (fraction of N): resample only at scheduled steps
    where a row's ESS < ess_threshold * N; None = every scheduled step.
    """

    model: StateSpaceModel
    num_particles: int
    resampler: str = "systematic"
    resample_every: int = 1
    ess_threshold: float = None
    functionals: Tuple[Callable, ...] = ()

    def _apply_functionals(self, particles, z, params, log_w):
        return apply_functionals(self.model, self.functionals, particles,
                                 z, params, log_w)

    def init(self, gen, params, y1, z1=None):
        """Time-1 initialization: (particles, log_weights, lcl)."""
        m = self.model
        m.require("sample_q1", "log_q1", "log_mu", "log_g")
        n = self.num_particles
        particles = m.sample_q1(gen, params, y1, n)
        log_w = (m.log_mu(params, particles)
                 + m.log_g(params, y1, particles, z1)
                 - m.log_q1(params, particles, y1))
        lcl = logsumexp(log_w) - math.log(float(n))
        return particles, log_w, lcl

    def step(self, gen, params, particles, log_w, t, y, z=None):
        """One t > 1 update; ``t`` is the 0-based step index."""
        m = self.model
        n = self.num_particles
        if t % self.resample_every == 0:
            do_rs = (True if self.ess_threshold is None
                     else ess(log_w) < self.ess_threshold * n)
            (particles,), log_w = resampling.maybe_resample(
                gen, log_w, (particles,), do_rs, kind=self.resampler)
        old_lse = logsumexp(log_w)
        particles = m.sample_f(gen, params, particles, z)
        log_w = log_w + m.log_g(params, y, particles, z)
        lcl = logsumexp(log_w) - old_lse
        return particles, log_w, lcl

    def run(self, gen, params, ys, zs=None) -> FilterResult:
        """Filter a full sequence: ``params`` (..., P) constrained,
        ``ys`` (T, dim_obs), ``zs`` (T, dim_cov) iff the model has
        covariates."""
        m = self.model
        ys = torch.as_tensor(ys)
        if ys.ndim == 1:
            ys = ys[:, None]
        if m.has_covariates and zs is None:
            raise ValueError(f"model {m.name!r} requires covariates zs")
        z_at = (lambda t: zs[t]) if m.has_covariates else (lambda t: None)

        particles, log_w, lcl = self.init(gen, params, ys[0], z_at(0))
        lcls = [lcl]
        exps = [self._apply_functionals(particles, z_at(0), params, log_w)]
        esss = [ess(log_w)]
        (particles,), log_w = resampling.maybe_resample(
            gen, log_w, (particles,), self.resample_every == 1,
            kind=self.resampler)
        for t in range(1, ys.shape[0]):
            particles, log_w, lcl = self.step(gen, params, particles, log_w,
                                              t, ys[t], z_at(t))
            lcls.append(lcl)
            exps.append(self._apply_functionals(particles, z_at(t), params,
                                                log_w))
            esss.append(ess(log_w))
        lcls = torch.stack(lcls, dim=-1)
        dim_t = lcls.ndim - 1
        expectations = tuple(torch.stack([e[k] for e in exps], dim=dim_t)
                             for k in range(len(self.functionals)))
        return FilterResult(
            log_likelihood=lcls.sum(-1),
            log_cond_likes=lcls,
            expectations=expectations,
            ess=torch.stack(esss, dim=-1),
            last_particles=particles,
            last_log_weights=log_w,
        )

    def sim_future_obs(self, gen, params, particles, num_steps,
                       feedback_obs_as_cov=False, last_obs=None):
        """Future observation paths from current (unweighted) particles
        (..., N, dim_state): the reference's ``sim_future_obs``.

        With ``feedback_obs_as_cov`` each step's sampled observation is
        the next step's covariate (the lagged-observation convention;
        needs dim_obs == dim_cov), starting from ``last_obs``.  Returns
        (..., num_steps, N, dim_obs).
        """
        m = self.model
        m.require("sample_f", "sample_g")
        z = None
        if feedback_obs_as_cov:
            if last_obs is None:
                raise ValueError("feedback covariates require last_obs")
            z = torch.as_tensor(last_obs, dtype=particles.dtype,
                                device=particles.device).reshape(
                m.dim_cov).expand(particles.shape[:-1] + (m.dim_cov,))
        elif m.has_covariates:
            raise ValueError(
                f"model {m.name!r} has covariates: future simulation "
                "requires feedback_obs_as_cov=True (the lagged-observation "
                "convention); there are no future covariate values")
        xs, obs_traj = particles, []
        for _ in range(int(num_steps)):
            xs = m.sample_f(gen, params, xs, z)
            obs = m.sample_g(gen, params, xs)
            if feedback_obs_as_cov:
                z = obs
            obs_traj.append(obs)
        return torch.stack(obs_traj, dim=-3)


def log_likelihood_fn(model: StateSpaceModel, num_particles: int,
                      resampler: str = "systematic", resample_every: int = 1):
    """``(gen, params (..., P), ys[, zs]) -> (...)`` log-likelihoods."""
    bf = BootstrapFilter(model, num_particles, resampler=resampler,
                         resample_every=resample_every)

    def ll(gen, params, ys, zs=None):
        return bf.run(gen, params, ys, zs).log_likelihood
    return ll


def replicated_log_like_fn(model: StateSpaceModel, num_particles: int,
                           num_replicates: int,
                           resampler: str = "systematic",
                           resample_every: int = 1,
                           ess_threshold: float = None):
    """Batched PMMH likelihood hook on the generic path:
    ``(gen, params (C, P), ys[, zs]) -> (C,)``, per chain the
    log-mean-exp of ``num_replicates`` independent filter likelihoods,
    all C x R filters as one (C, R) batch."""
    bf = BootstrapFilter(model, num_particles, resampler=resampler,
                         resample_every=resample_every,
                         ess_threshold=ess_threshold)
    r = num_replicates

    def batched(gen, params, ys, zs=None):
        rows = params[:, None, :].expand(params.shape[0], r,
                                         params.shape[1])
        vals = bf.run(gen, rows, ys, zs).log_likelihood      # (C, R)
        return logmeanexp(vals, dim=-1)

    return batched


__all__ = ["BootstrapFilter", "FilterResult", "log_likelihood_fn",
           "replicated_log_like_fn", "apply_functionals"]
