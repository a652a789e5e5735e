"""Auxiliary particle filter (APF) with fixed parameters.

PyTorch counterpart of ``ssme_tpu/filters/auxiliary.py``: the
Pitt-Shephard APF, batched over any leading parameter shape.  Per step:

  1. first-stage weights  logw_i + log g(y_t, propMu(x_i))
  2. ancestors k_i ~ Categorical(first-stage weights) (multinomial)
  3. propagate x'_i ~ f(. | x_{k_i})
  4. second-stage weights  log g(y_t, x'_i) - log g(y_t, propMu(x_{k_i}))
  5. conditional likelihood LSE(w') + LSE(fsw) - 2 LSE(logw), as the JAX
     package computes it (exact when logw was reset by the previous
     resample, i.e. with ``resample_every=1``)

then the second-stage weights are resampled on the ``resample_every``
schedule.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from ssme_tpu_torch import resampling
from ssme_tpu_torch.filters.bootstrap import BootstrapFilter, apply_functionals
from ssme_tpu_torch.models.base import StateSpaceModel
from ssme_tpu_torch.utils import logsumexp


def _take(particles, idx):
    """particles (..., N, d) at ancestors idx (..., N)."""
    return torch.gather(particles, -2, idx[..., None].expand(
        idx.shape + particles.shape[-1:]))


@dataclasses.dataclass(frozen=True, eq=False)
class AuxiliaryParticleFilter:
    model: StateSpaceModel
    num_particles: int
    resampler: str = "systematic"
    resample_every: int = 1
    functionals: Tuple[Callable, ...] = ()

    def __post_init__(self):
        self.model.require("sample_q1", "log_q1", "log_mu", "log_g",
                           "sample_f", "prop_mu")

    def _apply_functionals(self, particles, z, params, log_w):
        return apply_functionals(self.model, self.functionals, particles,
                                 z, params, log_w)

    def init(self, gen, params, y1, z1=None):
        """Time-1 initialization: (particles, log_weights, lcl)."""
        m = self.model
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
        lookahead = m.prop_mu(params, particles, z)
        log_fsw = log_w + m.log_g(params, y, lookahead, z)
        ks = resampling.multinomial_indices(gen, log_fsw)
        x_anc = _take(particles, ks)
        lookahead_anc = _take(lookahead, ks)
        new_particles = m.sample_f(gen, params, x_anc, z)
        new_log_w = (m.log_g(params, y, new_particles, z)
                     - m.log_g(params, y, lookahead_anc, z))
        lcl = (logsumexp(new_log_w) + logsumexp(log_fsw)
               - 2.0 * logsumexp(log_w))
        do_rs = (t + 1) % self.resample_every == 0
        (new_particles,), new_log_w = resampling.maybe_resample(
            gen, new_log_w, (new_particles,), do_rs, kind=self.resampler)
        return new_particles, new_log_w, lcl

    # the loop over the sequence is the bootstrap filter's: it calls this
    # class's init and step and resamples after init on the same schedule
    run = BootstrapFilter.run


__all__ = ["AuxiliaryParticleFilter"]
