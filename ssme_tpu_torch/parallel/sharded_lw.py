"""Particle-axis-sharded Liu-West filter: the joint (x, theta) cloud split
over ranks.

PyTorch counterpart of ``ssme_tpu/parallel/sharded_lw.py`` (the sharded
form of ``liu_west_filter.h:90-145`` and ``:569-583``).  The joint cloud
``(particles, trans_params)`` is split over the ranks of a process
group:

- **shrinkage moments** (theta_bar, Vt): the weighted sums become
  all-reduces, two of O(dim_param^2) a step, in IEEE float32 (the
  package switches TF32 off, F2);
- **APF first-stage selection** (``liu_west_filter.h:404``): a global
  joint resample of ``(x, shrunk theta, theta_old)`` by the lookahead
  weights through the ring exchange of ``parallel/sharded_pf.py``
  (systematic, as JAX's sharded filter, in place of the unsharded
  filter's multinomial);
- **scheduled joint resampling** (``mn_resamp_states_and_params``): the
  same ring over ``(particles, trans_params)``;
- **conditional likelihoods and ESS**: global log-sum-exp and ESS.

Semantics match ``filters.liu_west.LiuWestFilter`` (whose per-particle
hook adapters this module uses): shrinkage ``a = (3 delta - 1) /
(2 delta)``, ``h^2 = 1 - a^2`` in the transformed space, the
schedule-robust conditional likelihoods.  Agreement is in distribution;
the constant functional is 42 exactly under sharding.

Generators: every rank passes the same generator; the resampling
offsets come from it, the particle draws from its fold with the rank
(``ops/_prng.py::fold_generator``).  The resampling gate is a host value
read from all-reduced results, the same on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Tuple

import torch
import torch.distributed as dist

from ssme_tpu_torch import rv
from ssme_tpu_torch.filters.liu_west import LiuWestFilter, _unit
from ssme_tpu_torch.models.base import StateSpaceModel
from ssme_tpu_torch.ops._prng import fold_generator
from ssme_tpu_torch.parallel.mesh import (PARTICLE_AXIS, all_gather_cat,
                                         all_reduce_max, all_reduce_sum)
from ssme_tpu_torch.parallel.sharded_pf import (global_ess,
                                                global_logsumexp,
                                                ring_resample)


class ShardedLWState(NamedTuple):
    particles: torch.Tensor        # (n_local, dim_state)
    trans_params: torch.Tensor     # (n_local, dim_param)
    log_weights: torch.Tensor      # (n_local,)
    t: int
    generator: torch.Generator     # shared: the same state on every rank
    local_generator: torch.Generator  # this rank's particle draws


class ShardedLWResult(NamedTuple):
    log_likelihood: torch.Tensor
    log_cond_likes: torch.Tensor           # (T,)
    expectations: Tuple[torch.Tensor, ...]  # per functional: (T, k)
    ess: torch.Tensor                      # (T,) global ESS
    last_particles: torch.Tensor           # (n_local, dim_state) a rank
    last_trans_params: torch.Tensor        # (n_local, dim_param) a rank
    last_log_weights: torch.Tensor         # (n_local,) a rank


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedLiuWest:
    """Liu-West filter whose particle axis is split over ``group``'s
    ranks (None: the default group).

    Every rank calls the same methods with the same arguments and
    generator state; :func:`make_sharded_lw_runner` binds a mesh's
    particle group and gathers the final cloud.  ``ess_threshold > 0``
    gates the scheduled joint resample on the global ESS, else it fires
    every ``resample_every`` steps.  ``functionals`` take ``(x (n, S),
    theta (n, P))``, with the step's covariate ``z`` between them for a
    covariate model, and return (n, k).
    """

    model: StateSpaceModel
    num_particles: int              # global cloud size
    delta: float = 0.99
    variant: str = "apf"            # "apf" | "sisr"
    resample_every: int = 1
    ess_threshold: float = 0.0
    functionals: Tuple[Callable, ...] = ()
    group: object = None

    def __post_init__(self):
        self._hooks  # validates the variant and the model's hooks

    @property
    def _hooks(self) -> LiuWestFilter:
        """The unsharded filter, for its per-particle hook adapters."""
        return LiuWestFilter(self.model, self.num_particles, self.delta,
                             self.variant)

    @property
    def shrinkage_a(self) -> float:
        return (3.0 * self.delta - 1.0) / (2.0 * self.delta)

    def _n_local(self):
        n_shards = dist.get_world_size(self.group)
        if self.num_particles % n_shards:
            raise ValueError(
                f"num_particles={self.num_particles} must divide evenly "
                f"over {n_shards} shards")
        return self.num_particles // n_shards

    def _proposal_components(self, trans_params, log_weights):
        """Global weighted theta_bar (P,) and chol(h^2 Vt) (P, P) by
        all-reduces (the sharded ``liu_west_filter.h:569-583``)."""
        g = self.group
        a = self.shrinkage_a
        w = torch.exp(log_weights - all_reduce_max(torch.amax(log_weights),
                                                   g))
        w = w / all_reduce_sum(torch.sum(w), g)
        theta_bar = all_reduce_sum((trans_params * w[:, None]).sum(0), g)
        centered = trans_params - theta_bar
        vt = all_reduce_sum(torch.matmul((centered * w[:, None]).T,
                                         centered), g)
        return theta_bar, rv.chol_with_jitter((1.0 - a * a) * vt)

    def _constrain(self, trans_params):
        return self.model.transform.constrain(trans_params)

    def _apply_functionals(self, particles, z, untrans, log_w):
        """Globally normalised weighted expectations of the functionals
        (``liu_west_filter.h:457-477``)."""
        if not self.functionals:
            return ()
        g = self.group
        w = torch.exp(log_w - all_reduce_max(torch.amax(log_w), g))
        s = all_reduce_sum(torch.sum(w), g)
        outs = []
        for h in self.functionals:
            vals = (h(particles, z, untrans) if self.model.has_covariates
                    else h(particles, untrans))
            wb = w.reshape(w.shape + (1,) * (vals.ndim - 1))
            outs.append(all_reduce_sum((vals * wb).sum(0), g) / s)
        return tuple(outs)

    def _resample_gate(self, t, ess):
        # a host value read from the all-reduced ESS: every rank takes the
        # same branch around the ring's collectives
        if self.ess_threshold > 0.0:
            return bool(ess < self.ess_threshold * self.num_particles)
        return t % self.resample_every == 0

    def _maybe_joint_resample(self, gen, particles, trans, log_w, do_rs):
        """The sharded ``mn_resamp_states_and_params``
        (``liu_west_filter.h:90-145``; weights zeroed after, ``:144``)."""
        if not do_rs:
            return particles, trans, log_w
        particles, trans = ring_resample(gen, log_w, (particles, trans),
                                         self.group)
        return particles, trans, torch.zeros_like(log_w)

    # ------------------------------------------------------------------
    def init(self, gen, y1, z1=None):
        """Time 1 (``liu_west_filter.h:486-550``) on this rank's share:
        returns (state, lcl, expectations, ess)."""
        m = self.model
        local = fold_generator(gen, dist.get_rank(self.group))
        untrans = m.sample_prior(local, (self._n_local(),))
        trans = m.transform.unconstrain(untrans)
        particles = m.sample_q1(local, untrans, y1, 1)[..., 0, :]
        x1 = particles[:, None, :]
        log_w = (m.log_mu(untrans, x1) + m.log_g(untrans, y1, x1, z1)
                 - m.log_q1(untrans, x1, y1))[..., 0]
        lcl = (global_logsumexp(log_w, self.group)
               - math.log(float(self.num_particles)))
        exps = self._apply_functionals(particles, z1, untrans, log_w)
        e0 = global_ess(log_w, self.group)
        do0 = (self._resample_gate(0, e0) if self.ess_threshold > 0.0
               else self.resample_every == 1)
        particles, trans, log_w = self._maybe_joint_resample(
            gen, particles, trans, log_w, do0)
        return (ShardedLWState(particles, trans, log_w, 1, gen, local), lcl,
                exps, e0)

    def _step_apf(self, state: ShardedLWState, y, z):
        """Sharded ``LWFilter::filter`` at t > 1
        (``liu_west_filter.h:368-484``)."""
        hk, g = self._hooks, self.group
        a = self.shrinkage_a
        theta_bar, chol = self._proposal_components(state.trans_params,
                                                    state.log_weights)
        shrunk = a * state.trans_params + (1.0 - a) * theta_bar
        untrans_old = self._constrain(state.trans_params)
        lookahead = hk._prop_mu(untrans_old, state.particles, z)
        log_fsw = state.log_weights + hk._log_g(self._constrain(shrunk), y,
                                                lookahead, z)
        old_lse = global_logsumexp(state.log_weights, g)
        fsw_lse = global_logsumexp(log_fsw, g)
        # the global first-stage selection (lw:404), a joint ring exchange
        x_anc, shrunk_anc, untrans_anc = ring_resample(
            state.generator, log_fsw,
            (state.particles, shrunk, untrans_old), g)
        new_trans = hk._kernel_draw(state.local_generator, shrunk_anc, chol)
        new_untrans = self._constrain(new_trans)
        new_particles = hk._sample_f(state.local_generator, new_untrans,
                                     x_anc, z)
        log_num = hk._log_g(new_untrans, y, new_particles, z)
        lookahead_anc = hk._prop_mu(untrans_anc, x_anc, z)
        log_den = hk._log_g(self._constrain(shrunk_anc), y, lookahead_anc, z)
        new_log_w = log_num - log_den
        # schedule-robust conditional likelihood (filters/liu_west.py)
        lcl = (fsw_lse - old_lse + global_logsumexp(new_log_w, g)
               - math.log(float(self.num_particles)))
        return self._finish(state, new_particles, new_trans, new_untrans,
                            new_log_w, lcl, z)

    def _step_sisr(self, state: ShardedLWState, y, z):
        """Sharded ``LWFilter2::filter`` at t > 1
        (``liu_west_filter.h:1608-1691``)."""
        m, hk, g = self.model, self._hooks, self.group
        a = self.shrinkage_a
        theta_bar, chol = self._proposal_components(state.trans_params,
                                                    state.log_weights)
        shrunk = a * state.trans_params + (1.0 - a) * theta_bar
        new_trans = hk._kernel_draw(state.local_generator, shrunk, chol)
        new_untrans = self._constrain(new_trans)
        x_old = state.particles[:, None, :]
        zu = _unit(z)
        x_new = m.sample_q(state.local_generator, new_untrans, x_old, y, zu)
        incr = (m.log_f(new_untrans, x_new, x_old, zu)
                + m.log_g(new_untrans, y, x_new, zu)
                - m.log_q(new_untrans, x_new, x_old, y, zu))[..., 0]
        new_log_w = state.log_weights + incr
        lcl = (global_logsumexp(new_log_w, g)
               - global_logsumexp(state.log_weights, g))
        return self._finish(state, x_new[:, 0, :], new_trans, new_untrans,
                            new_log_w, lcl, z)

    def _finish(self, state, particles, trans, untrans, log_w, lcl, z):
        """A step's functionals, ESS and scheduled joint resample."""
        exps = self._apply_functionals(particles, z, untrans, log_w)
        e = global_ess(log_w, self.group)
        particles, trans, log_w = self._maybe_joint_resample(
            state.generator, particles, trans, log_w,
            self._resample_gate(state.t + 1, e))
        return (state._replace(particles=particles, trans_params=trans,
                               log_weights=log_w, t=state.t + 1),
                lcl, exps, e)

    def step(self, state: ShardedLWState, y, z=None):
        if self.variant == "apf":
            return self._step_apf(state, y, z)
        return self._step_sisr(state, y, z)

    # ------------------------------------------------------------------
    def run(self, gen, ys, zs=None) -> ShardedLWResult:
        """The whole sequence on this rank's share of the cloud."""
        m = self.model
        ys = torch.as_tensor(ys)
        if ys.ndim == 1:
            ys = ys[:, None]
        if m.has_covariates and zs is None:
            raise ValueError(f"model {m.name!r} requires covariates zs")
        z_at = (lambda t: zs[t]) if m.has_covariates else (lambda t: None)
        state, lcl, exps, e = self.init(gen, ys[0], z_at(0))
        lcls, expss, esss = [lcl], [exps], [e]
        for t in range(1, ys.shape[0]):
            state, lcl, exps, e = self.step(state, ys[t], z_at(t))
            lcls.append(lcl)
            expss.append(exps)
            esss.append(e)
        lcls = torch.stack(lcls)
        return ShardedLWResult(
            log_likelihood=lcls.sum(),
            log_cond_likes=lcls,
            expectations=tuple(torch.stack([x[k] for x in expss])
                               for k in range(len(self.functionals))),
            ess=torch.stack(esss),
            last_particles=state.particles,
            last_trans_params=state.trans_params,
            last_log_weights=state.log_weights)

    def param_samples(self, result: ShardedLWResult):
        """Constrained parameter particles of the result's cloud (this
        rank's share, or the global cloud from a runner)."""
        return self._constrain(result.last_trans_params)

    # ------------------------------------------------------------------
    def sim_future_obs(self, gen, state_particles, trans_params, num_steps,
                       last_obs=None):
        """Future observations from this rank's share of a uniformly
        weighted cloud (the FutureSimulator add-ons,
        ``liu_west_filter.h:600-738, 1213-1363``): per step the global
        shrinkage moments, then this rank's kernel draws, transitions and
        observations; a covariate model feeds each step's observation
        back (``:1327-1357``).  Returns (num_steps, n_local, dim_obs)."""
        m, hk = self.model, self._hooks
        m.require("sample_f", "sample_g")
        a = self.shrinkage_a
        local = fold_generator(gen, dist.get_rank(self.group))
        xs, trans = state_particles, trans_params
        zcur = None
        if m.has_covariates:
            if last_obs is None:
                raise ValueError(
                    "covariate models feed observations back as covariates; "
                    "pass last_obs")
            zcur = torch.as_tensor(last_obs, dtype=xs.dtype,
                                   device=xs.device).reshape(
                m.dim_cov).expand(xs.shape[:-1] + (m.dim_cov,))
        uniform = torch.zeros(xs.shape[:-1], dtype=xs.dtype, device=xs.device)
        obs_traj = []
        for _ in range(int(num_steps)):
            theta_bar, chol = self._proposal_components(trans, uniform)
            trans = hk._kernel_draw(local, a * trans + (1.0 - a) * theta_bar,
                                    chol)
            untrans = self._constrain(trans)
            xs = hk._sample_f(local, untrans, xs, zcur)
            obs = m.sample_g(local, untrans, xs[:, None, :])[:, 0, :]
            if m.has_covariates:
                zcur = obs
            obs_traj.append(obs)
        return torch.stack(obs_traj)


def make_sharded_lw_runner(lw: ShardedLiuWest, mesh,
                           axis: str = PARTICLE_AXIS):
    """``runner(gen, ys[, zs]) -> ShardedLWResult`` running ``lw`` over
    the mesh's ``axis`` group, with the final cloud (particles,
    parameters, weights) gathered on every rank, as JAX's runner returns
    the global arrays."""
    lw = dataclasses.replace(lw, group=mesh.get_group(axis))

    def runner(gen, ys, zs=None):
        res = lw.run(gen, ys, zs)
        return res._replace(**{k: all_gather_cat(getattr(res, k), lw.group)
                               for k in ("last_particles",
                                         "last_trans_params",
                                         "last_log_weights")})

    return runner


__all__ = ["ShardedLiuWest", "ShardedLWState", "ShardedLWResult",
           "make_sharded_lw_runner"]
