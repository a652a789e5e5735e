"""Particle swarm filter: a bank of particle filters, one per parameter
draw, and forecasts from a final cloud.

PyTorch counterpart of ``ssme_tpu/inference/swarm.py``.  Parameter draws
are an (M, d) tensor and the filter bank is the leading batch dimension
of one generic bootstrap filter (``filters/bootstrap.py``); the mean over
models is one ``mean``.  The first observation initialises every filter,
so :meth:`SwarmFilter.run` takes it before its loop over the rest: no
step evaluates a branch on the step index.

The kernel-speed swarm runs the filter bank in one launch
(``ops/filter_megakernel.py::megakernel_swarm_evidence`` with
``return_cloud=True``) and forecasts with :func:`forecast_from_cloud`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from ssme_tpu_torch import resampling
from ssme_tpu_torch.filters.bootstrap import BootstrapFilter
from ssme_tpu_torch.models.base import StateSpaceModel
from ssme_tpu_torch.utils import logmeanexp


class SwarmState(NamedTuple):
    params: torch.Tensor       # (M, d) constrained per-model parameters
    particles: torch.Tensor    # (M, N, dim_state)
    log_weights: torch.Tensor  # (M, N)
    t: int                     # observations seen
    generator: torch.Generator


class SwarmResult(NamedTuple):
    """Per-step aggregated outputs (leading axis = time for ``run``)."""

    log_cond_like: torch.Tensor       # logmeanexp over models
    mean_log_cond_like: torch.Tensor  # arithmetic mean of logs (the
                                      # reference's aggregation)
    expectations: Tuple[torch.Tensor, ...]  # mean over models of the
                                            # per-model expectations


@dataclasses.dataclass(frozen=True, eq=False)
class SwarmFilter:
    model: StateSpaceModel
    num_state_particles: int
    num_param_particles: int
    resampler: str = "multinomial"
    resample_every: int = 1
    functionals: Tuple[Callable, ...] = ()

    @property
    def _bf(self) -> BootstrapFilter:
        return BootstrapFilter(self.model, self.num_state_particles,
                               resampler=self.resampler,
                               resample_every=self.resample_every,
                               functionals=self.functionals)

    def init_params(self, gen, param_draws=None):
        """(M, d) per-model constrained parameters: rows of
        ``param_draws`` drawn uniformly with replacement, or draws from
        the model's prior when it is None."""
        m = self.num_param_particles
        if param_draws is None:
            self.model.require("sample_prior")
            return torch.stack([self.model.sample_prior(gen)
                                for _ in range(m)])
        param_draws = torch.as_tensor(param_draws, dtype=torch.float32)
        idx = torch.randint(0, param_draws.shape[0], (m,), generator=gen,
                            device=gen.device)
        return param_draws.to(gen.device)[idx]

    def init(self, gen, param_draws=None) -> SwarmState:
        """Per-model parameters; the clouds are made by the first
        :meth:`update`."""
        params = self.init_params(gen, param_draws)
        mshape = (self.num_param_particles, self.num_state_particles)
        return SwarmState(
            params=params,
            particles=torch.zeros(mshape + (self.model.dim_state,),
                                  device=params.device),
            log_weights=torch.zeros(mshape, device=params.device),
            t=0,
            generator=gen,
        )

    def _result(self, state, particles, log_w, lcls, z):
        exps = self._bf._apply_functionals(particles, z, state.params, log_w)
        result = SwarmResult(
            log_cond_like=logmeanexp(lcls, dim=0),
            mean_log_cond_like=lcls.mean(0),
            expectations=tuple(e.mean(0) for e in exps),
        )
        return (SwarmState(state.params, particles, log_w, state.t + 1,
                           state.generator), result)

    def _first(self, state, y, z):
        bf, gen = self._bf, state.generator
        particles, log_w, lcls = bf.init(gen, state.params, y, z)
        # the reference resamples time 0 too when resample_every == 1
        (particles,), log_w = resampling.maybe_resample(
            gen, log_w, (particles,), self.resample_every == 1,
            kind=self.resampler)
        return self._result(state, particles, log_w, lcls, z)

    def _next(self, state, y, z):
        particles, log_w, lcls = self._bf.step(
            state.generator, state.params, state.particles,
            state.log_weights, state.t, y, z)
        return self._result(state, particles, log_w, lcls, z)

    def update(self, state: SwarmState, y, z=None):
        """One observation through every inner filter + aggregation;
        returns (new_state, SwarmResult)."""
        if state.t == 0:
            return self._first(state, y, z)
        return self._next(state, y, z)

    def run(self, gen, ys, zs=None, param_draws=None):
        """Full-sequence swarm filtering; returns (final_state,
        SwarmResult with (T,)-leading tensors)."""
        ys = torch.as_tensor(ys)
        if ys.ndim == 1:
            ys = ys[:, None]
        if self.model.has_covariates and zs is None:
            raise ValueError(
                f"model {self.model.name!r} requires covariates zs")
        z_at = ((lambda t: zs[t]) if self.model.has_covariates
                else (lambda t: None))
        state, res = self._first(self.init(gen, param_draws), ys[0], z_at(0))
        results = [res]
        for t in range(1, ys.shape[0]):
            state, res = self._next(state, ys[t], z_at(t))
            results.append(res)
        return state, SwarmResult(
            log_cond_like=torch.stack([r.log_cond_like for r in results]),
            mean_log_cond_like=torch.stack(
                [r.mean_log_cond_like for r in results]),
            expectations=tuple(
                torch.stack([r.expectations[k] for r in results])
                for k in range(len(self.functionals))))

    def sim_future_obs(self, gen, state: SwarmState, num_steps,
                       feedback_obs_as_cov=None, last_obs=None):
        """Future observation paths from every model: (M, num_steps, N,
        dim_obs), indexed param-particle, time, state-particle."""
        if feedback_obs_as_cov is None:
            feedback_obs_as_cov = self.model.has_covariates
        return self._bf.sim_future_obs(
            gen, state.params, state.particles, num_steps,
            feedback_obs_as_cov=feedback_obs_as_cov, last_obs=last_obs)


def forecast_from_cloud(model: StateSpaceModel, param_draws, cloud,
                        cloud_log_weights, gen, num_steps,
                        feedback_obs_as_cov=None, last_obs=None):
    """Future observation paths from a kernel-exported final cloud.

    Each model's cloud is equal-weighted by one systematic resample under
    its carried log-weights (the state every reference forecast starts
    from), then simulated forward by the generic future simulator.
    ``cloud``: tuple of ``num_state`` (M, n) leaves;
    ``cloud_log_weights``: (M, n).  Returns (M, num_steps, n, dim_obs).
    """
    draws = torch.as_tensor(param_draws, dtype=torch.float32)
    leaves = tuple(torch.as_tensor(c) for c in cloud)
    n = leaves[0].shape[1]
    if feedback_obs_as_cov is None:
        feedback_obs_as_cov = model.has_covariates
    idx = resampling.systematic_indices(gen, torch.as_tensor(
        cloud_log_weights))                                   # (M, n)
    particles = torch.stack([torch.gather(leaf, 1, idx) for leaf in leaves],
                            dim=-1)                           # (M, n, S)
    return BootstrapFilter(model, num_particles=n).sim_future_obs(
        gen, draws.to(particles.device), particles, num_steps,
        feedback_obs_as_cov=feedback_obs_as_cov, last_obs=last_obs)


__all__ = ["SwarmFilter", "SwarmResult", "SwarmState",
           "forecast_from_cloud"]
