"""Liu-West filters: joint online state + parameter estimation.

PyTorch counterpart of ``ssme_tpu/filters/liu_west.py``: one class for
the reference's eight Liu-West variants, ``variant`` choosing the
algorithm, the model's ``dim_cov`` the covariate handling, and
:meth:`LiuWestFilter.sim_future_obs` the future simulators.

Both variants carry N joint particles (x_i, theta_i), theta in the
transformed (unconstrained) space, with kernel shrinkage

    a = (3 delta - 1) / (2 delta),   h^2 = 1 - a^2
    m_i = a theta_i + (1 - a) theta_bar
    theta'_i ~ MVN(m_i, h^2 Vt)

where theta_bar and Vt are the weight-averaged mean and covariance of the
transformed parameter particles (identical to the reference's unweighted
moments when resampling every step leaves uniform weights).

variant="apf": first-stage weights logw_i + log g(y, propMu(x_i), shrunk
  theta_i) select ancestors (multinomial), kernel-sample theta, propagate
  f, reweight by the observation-density ratio; the conditional
  likelihood is LSE(fsw) - LSE(logw) + LSE(logw') - log N.
variant="sisr": kernel-sample theta around the particle's own shrunk
  value, propose x ~ q, add log f + log g - log q to the weights; the
  conditional likelihood is the ratio of the LSEs.

Shrinkage is always done in the transformed space and mapped back through
``constrain`` before a density is evaluated (the JAX package's fix of the
reference's space mixing).

JAX vmaps a model's one-particle hooks over the particles; here the hooks
take batches (``models/base.py``), so each particle is handed to them as a
cloud of one particle with its own parameter row: particles (..., N, S)
go in as (..., N, 1, S) beside parameters (..., N, P).  Any leading batch
shape runs independent filters side by side.  The Gram matrix and
``eps @ chol.T`` are float32 matrix products, never TF32 (the package
switches TF32 off).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Tuple

import torch

from ssme_tpu_torch import resampling, rv
from ssme_tpu_torch.models.base import StateSpaceModel
from ssme_tpu_torch.utils import ess, logsumexp, weighted_expectation


class LiuWestResult(NamedTuple):
    log_likelihood: torch.Tensor       # (...,) sum_t log p(y_t | y_{1:t-1})
    log_cond_likes: torch.Tensor       # (..., T)
    expectations: Tuple[torch.Tensor, ...]  # per functional: (..., T, k)
    ess: torch.Tensor                  # (..., T)
    last_particles: torch.Tensor       # (..., N, dim_state)
    last_trans_params: torch.Tensor    # (..., N, dim_param), unconstrained
    last_log_weights: torch.Tensor     # (..., N)


class LWState(NamedTuple):
    particles: torch.Tensor     # (..., N, dim_state)
    trans_params: torch.Tensor  # (..., N, dim_param)
    log_weights: torch.Tensor   # (..., N)
    t: int                      # observations seen


def _unit(v):
    """A per-particle (..., N, d) tensor as (..., N, 1, d); a shared (d,)
    row (or None) stays as it is."""
    return v if v is None or v.ndim <= 1 else v[..., None, :]


@dataclasses.dataclass(frozen=True, eq=False)
class LiuWestFilter:
    """One configuration object covering the reference's 8 LW variants."""

    model: StateSpaceModel
    num_particles: int
    delta: float = 0.99
    variant: str = "apf"            # "apf" (LWFilter) | "sisr" (LWFilter2)
    resampler: str = "multinomial"  # the reference's joint multinomial
    resample_every: int = 1
    functionals: Tuple[Callable, ...] = ()
    debug: bool = False             # print lcl and ESS every step

    def __post_init__(self):
        if self.variant not in ("apf", "sisr"):
            raise ValueError("variant must be 'apf' or 'sisr'")
        m = self.model
        m.require("sample_q1", "log_q1", "log_mu", "log_g", "sample_prior")
        if self.variant == "apf":
            m.require("prop_mu", "sample_f")
        else:
            m.require("sample_q", "log_f", "log_q")

    @property
    def shrinkage_a(self) -> float:
        return (3.0 * self.delta - 1.0) / (2.0 * self.delta)

    # per-particle hooks: unit clouds of one particle each (module note)
    def _log_g(self, p, y, x, z):
        return self.model.log_g(p, y, x[..., None, :], _unit(z))[..., 0]

    def _prop_mu(self, p, x, z):
        return self.model.prop_mu(p, x[..., None, :], _unit(z))[..., 0, :]

    def _sample_f(self, gen, p, x, z):
        return self.model.sample_f(gen, p, x[..., None, :], _unit(z))[..., 0, :]

    # ------------------------------------------------------------------
    def _proposal_components(self, trans_params, log_weights=None):
        """theta_bar (..., P) and chol(h^2 Vt) (..., P, P) of the cloud;
        weighted by ``log_weights`` when given, else uniform."""
        a = self.shrinkage_a
        if log_weights is None:
            w = torch.full(trans_params.shape[:-1],
                           1.0 / trans_params.shape[-2],
                           dtype=trans_params.dtype,
                           device=trans_params.device)
        else:
            mx = torch.amax(log_weights, dim=-1, keepdim=True)
            w = torch.exp(log_weights - mx)
            w = w / w.sum(-1, keepdim=True)
        theta_bar = (trans_params * w[..., None]).sum(-2)
        centered = trans_params - theta_bar[..., None, :]
        vt = torch.matmul((centered * w[..., None]).transpose(-1, -2),
                          centered)
        h2 = 1.0 - a * a
        chol = rv.chol_with_jitter(h2 * vt)
        return theta_bar, chol

    def _kernel_draw(self, gen, shrunk, chol):
        eps = torch.randn(shrunk.shape, generator=gen, dtype=shrunk.dtype,
                          device=shrunk.device)
        return shrunk + torch.matmul(eps, chol.transpose(-1, -2))

    def _constrain(self, trans_params):
        return self.model.transform.constrain(trans_params)

    def _apply_functionals(self, particles, z, untrans, log_w):
        outs = []
        for h in self.functionals:
            vals = (h(particles, z, untrans) if self.model.has_covariates
                    else h(particles, untrans))
            outs.append(weighted_expectation(vals, log_w))
        return tuple(outs)

    # ------------------------------------------------------------------
    def init(self, gen, y1, z1=None, batch_shape=()):
        """Time 1: parameters from the prior, states from q1.  Returns
        (state, lcl, expectations, ess) for filters of ``batch_shape``."""
        m = self.model
        n = self.num_particles
        untrans = m.sample_prior(gen, tuple(batch_shape) + (n,))
        trans = m.transform.unconstrain(untrans)
        particles = m.sample_q1(gen, untrans, y1, 1)[..., 0, :]
        x1 = particles[..., None, :]
        log_w = (m.log_mu(untrans, x1) + m.log_g(untrans, y1, x1, z1)
                 - m.log_q1(untrans, x1, y1))[..., 0]
        lcl = logsumexp(log_w) - math.log(float(n))
        exps = self._apply_functionals(particles, z1, untrans, log_w)
        e0 = ess(log_w)
        (particles, trans), log_w = resampling.maybe_resample(
            gen, log_w, (particles, trans), self.resample_every == 1,
            kind=self.resampler)
        return LWState(particles, trans, log_w, 1), lcl, exps, e0

    def _resample(self, gen, t, particles, trans, log_w):
        do_rs = (t + 1) % self.resample_every == 0
        return resampling.maybe_resample(gen, log_w, (particles, trans),
                                         do_rs, kind=self.resampler)

    def _step_apf(self, gen, state: LWState, y, z):
        n = self.num_particles
        a = self.shrinkage_a
        theta_bar, chol = self._proposal_components(state.trans_params,
                                                    state.log_weights)
        shrunk = a * state.trans_params + (1.0 - a) * theta_bar[..., None, :]
        shrunk_untrans = self._constrain(shrunk)
        untrans_old = self._constrain(state.trans_params)

        # first-stage (lookahead) weights at the shrunk parameters
        lookahead = self._prop_mu(untrans_old, state.particles, z)
        log_fsw = state.log_weights + self._log_g(shrunk_untrans, y,
                                                  lookahead, z)
        ks = resampling.multinomial_indices(gen, log_fsw)
        x_anc = resampling._gather(state.particles, ks)
        shrunk_anc = resampling._gather(shrunk, ks)
        untrans_anc = resampling._gather(untrans_old, ks)

        new_trans = self._kernel_draw(gen, shrunk_anc, chol)
        new_untrans = self._constrain(new_trans)
        new_particles = self._sample_f(gen, new_untrans, x_anc, z)
        log_num = self._log_g(new_untrans, y, new_particles, z)
        lookahead_anc = self._prop_mu(untrans_anc, x_anc, z)
        log_den = self._log_g(self._constrain(shrunk_anc), y, lookahead_anc,
                              z)
        new_log_w = log_num - log_den
        # carried-weight form: exact under every resampling schedule, the
        # reference's 3-term identity when the previous step resampled
        lcl = (logsumexp(log_fsw) - logsumexp(state.log_weights)
               + logsumexp(new_log_w) - math.log(float(n)))
        exps = self._apply_functionals(new_particles, z, new_untrans,
                                       new_log_w)
        e = ess(new_log_w)
        (new_particles, new_trans), new_log_w = self._resample(
            gen, state.t, new_particles, new_trans, new_log_w)
        return (LWState(new_particles, new_trans, new_log_w, state.t + 1),
                lcl, exps, e)

    def _step_sisr(self, gen, state: LWState, y, z):
        m = self.model
        a = self.shrinkage_a
        theta_bar, chol = self._proposal_components(state.trans_params,
                                                    state.log_weights)
        shrunk = a * state.trans_params + (1.0 - a) * theta_bar[..., None, :]
        new_trans = self._kernel_draw(gen, shrunk, chol)
        new_untrans = self._constrain(new_trans)

        x_old = state.particles[..., None, :]
        zu = _unit(z)
        x_new = m.sample_q(gen, new_untrans, x_old, y, zu)
        incr = (m.log_f(new_untrans, x_new, x_old, zu)
                + m.log_g(new_untrans, y, x_new, zu)
                - m.log_q(new_untrans, x_new, x_old, y, zu))[..., 0]
        new_particles = x_new[..., 0, :]
        new_log_w = state.log_weights + incr
        lcl = logsumexp(new_log_w) - logsumexp(state.log_weights)
        exps = self._apply_functionals(new_particles, z, new_untrans,
                                       new_log_w)
        e = ess(new_log_w)
        (new_particles, new_trans), new_log_w = self._resample(
            gen, state.t, new_particles, new_trans, new_log_w)
        return (LWState(new_particles, new_trans, new_log_w, state.t + 1),
                lcl, exps, e)

    def step(self, gen, state: LWState, y, z=None):
        if self.variant == "apf":
            return self._step_apf(gen, state, y, z)
        return self._step_sisr(gen, state, y, z)

    # ------------------------------------------------------------------
    def run(self, gen, ys, zs=None, batch_shape=()) -> LiuWestResult:
        """Filter a whole sequence: ``ys`` (T, dim_obs), ``zs`` (T,
        dim_cov) iff the model has covariates; ``batch_shape`` independent
        filters at once."""
        m = self.model
        ys = torch.as_tensor(ys)
        if ys.ndim == 1:
            ys = ys[:, None]
        if m.has_covariates:
            if zs is None:
                raise ValueError(f"model {m.name!r} requires covariates zs")
            zs = torch.as_tensor(zs)
        z_at = (lambda t: zs[t]) if m.has_covariates else (lambda t: None)

        state, lcl, exps, e = self.init(gen, ys[0], z_at(0), batch_shape)
        lcls, expss, esss = [lcl], [exps], [e]
        for t in range(1, ys.shape[0]):
            state, lcl, exps, e = self.step(gen, state, ys[t], z_at(t))
            if self.debug:
                print(f"time: {state.t}, log cond like: {lcl}, ess: {e}")
            lcls.append(lcl)
            expss.append(exps)
            esss.append(e)
        lcls = torch.stack(lcls, dim=-1)
        dim_t = lcls.ndim - 1
        return LiuWestResult(
            log_likelihood=lcls.sum(-1),
            log_cond_likes=lcls,
            expectations=tuple(torch.stack([x[k] for x in expss], dim=dim_t)
                               for k in range(len(self.functionals))),
            ess=torch.stack(esss, dim=-1),
            last_particles=state.particles,
            last_trans_params=state.trans_params,
            last_log_weights=state.log_weights,
        )

    def param_samples(self, result: LiuWestResult):
        """Constrained parameter particles (..., N, P)."""
        return self._constrain(result.last_trans_params)

    # ------------------------------------------------------------------
    def sim_future_obs(self, gen, state_particles, trans_params, num_steps,
                       last_obs=None):
        """Future observation paths from a (uniformly weighted) cloud:
        per step, the shrinkage components of the current parameter cloud,
        a kernel draw of each particle's theta around its own shrunk value,
        a transition draw (each step's sampled observation feeding back as
        the next covariate for a covariate model, starting from
        ``last_obs``) and an observation draw.

        ``state_particles`` (..., N, S), ``trans_params`` (..., N, P);
        returns (..., num_steps, N, dim_obs).
        """
        m = self.model
        m.require("sample_f", "sample_g")
        a = self.shrinkage_a
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
        obs_traj = []
        for _ in range(int(num_steps)):
            theta_bar, chol = self._proposal_components(trans)
            shrunk = a * trans + (1.0 - a) * theta_bar[..., None, :]
            trans = self._kernel_draw(gen, shrunk, chol)
            untrans = self._constrain(trans)
            xs = self._sample_f(gen, untrans, xs, zcur)
            obs = m.sample_g(gen, untrans, xs[..., None, :])[..., 0, :]
            if m.has_covariates:
                zcur = obs
            obs_traj.append(obs)
        return torch.stack(obs_traj, dim=-3)


__all__ = ["LiuWestFilter", "LiuWestResult", "LWState"]
