"""Adaptive particle marginal Metropolis-Hastings (PMMH), batched chains.

PyTorch counterpart of ``ssme_tpu/inference/pmmh.py``; the semantics are
the same:

- random-walk MVN proposal on the transformed space;
- Haario covariance adaptation inside the window (t0, t1):
  ``Ct = sd (Sigma_hat + eps I)``, ``sd = 2.4^2 / d``, ``eps = .01``, with
  the branch-free recursive moment updates;
- the MH ratio includes the log-Jacobian, so priors live on the
  constrained space;
- a NaN acceptance ratio rejects (comparison with NaN is false);
- the moving-average accept rate.

Chains are a leading batch dimension.  Every chain owns a
``torch.Generator`` on the device (the counterpart of its JAX key); chain
0's generator also seeds each iteration's likelihood launch, as JAX uses
chain 0's likelihood key.  The iteration loop is a Python loop that never
waits for the device: the iteration counter lives on the host, the
likelihood kernel reads its seed from a device tensor, and results reach
the host only at ``sample()``'s chunk boundaries.  Each iteration's host
work is marked by ``profiling`` spans (``HOST_SPANS``; ``pmmh.draw`` and
``pmmh.step`` keyed by the iteration's number).  JAX's
``MAX_SCAN_ITERS`` chunking guarded a crash of its TPU rig and has no
counterpart.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ssme_tpu_torch import profiling, rv
from ssme_tpu_torch.filters.bootstrap import replicated_log_like_fn
from ssme_tpu_torch.models.base import StateSpaceModel
from ssme_tpu_torch.ops._prng import TAG_CHAIN, philox4x32_10, seed_words
from ssme_tpu_torch.utils import logmeanexp

# the profiling spans opened here: ``init``, ``draw`` and ``step`` around
# the calls of those names, the rest inside ``step``
HOST_SPANS = ("pmmh.init", "pmmh.draw", "pmmh.step", "pmmh.adapt",
              "pmmh.propose", "pmmh.prior", "pmmh.likelihood", "pmmh.accept")


class PMMHState(NamedTuple):
    """Per-chain sampler state (leading axis = chains).

    ``generators`` advance in place as the chain runs; save and restore
    them with ``ssme_tpu_torch.io.checkpoint``.
    """

    trans_theta: torch.Tensor   # (C, d) current position, transformed
    log_like: torch.Tensor      # (C,)
    log_prior: torch.Tensor     # (C,) includes log-Jacobian
    mean: torch.Tensor          # (C, d) running mean of transformed samples
    sigma_hat: torch.Tensor     # (C, d, d) running covariance
    ct: torch.Tensor            # (C, d, d) current proposal covariance
    accept_ma: torch.Tensor     # (C,) moving-average accept rate
    iteration: int              # completed iterations
    generators: Tuple[torch.Generator, ...]  # one per chain


class PMMHResult(NamedTuple):
    samples: torch.Tensor        # (iters, C, d) constrained samples
    trans_samples: torch.Tensor  # (iters, C, d)
    log_likes: torch.Tensor      # (iters, C)
    log_priors: torch.Tensor     # (iters, C)
    new_log_likes: torch.Tensor  # (iters, C) proposed values
    new_log_priors: torch.Tensor
    log_accept_probs: torch.Tensor
    accepted: torch.Tensor       # (iters, C) bool
    accept_rate: torch.Tensor    # (iters, C) moving average
    final_state: PMMHState


def chain_generators(seed: int, num_chains: int, device) -> tuple:
    """One generator per chain, seeded with 64 bits of Philox output
    under the run's seed (counter (c, 0, 0, 2)), so chains draw
    decorrelated streams."""
    words = seed_words(seed)
    c = torch.arange(num_chains, dtype=torch.int64)
    zero = torch.zeros_like(c)
    w0, w1, _, _ = philox4x32_10(c, zero, zero, zero + TAG_CHAIN, words[0],
                                 words[1])
    return tuple(generator_from_seed((int(a) << 32) | int(b), device)
                 for a, b in zip(w0, w1))


def generator_from_seed(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


@dataclasses.dataclass(frozen=True, eq=False)
class AdaptivePMMH:
    """Configuration of the reference's adaptive PMMH plus chain batching.

    ``batched_log_like``: ``(gen, params (C, d), ys) -> (C,)`` evaluating
    every chain's replicate-averaged likelihood in one call (e.g.
    ``ops.svol_filter_kernel.svol_batched_log_like``, one kernel launch);
    by default the generic filter bank.  ``custom_log_like``:
    ``(gen, params (d,), ys) -> ()`` for one replicate of one chain.  For
    a model with covariates both hooks take ``zs`` as a fourth argument,
    as in JAX; the generic bank always receives it.  ``zs`` moves to the
    device of ``ys`` once per ``init``/``run_from`` call, never inside an
    iteration.
    """

    model: StateSpaceModel
    num_particles: int
    num_replicates: int = 1
    t0: int = 150
    t1: int = 1000
    eps: float = 0.01
    sd: Optional[float] = None
    resampler: str = "systematic"
    resample_every: int = 1
    custom_log_like: Optional[callable] = None
    batched_log_like: Optional[callable] = None

    def __post_init__(self):
        self.model.require("log_prior")

    @property
    def _sd(self) -> float:
        return (2.4 * 2.4 / self.model.dim_param) if self.sd is None \
            else self.sd

    def _log_prior_with_jacobian(self, trans_theta):
        tf = self.model.transform
        return (self.model.log_prior(tf.constrain(trans_theta))
                + tf.log_det_jacobian(trans_theta))

    def _log_like(self, gens, trans_theta, ys, zs=None):
        """(C,) replicate-averaged log-likelihoods of the chains' points."""
        params = self.model.transform.constrain(trans_theta)
        cov = (zs,) if self.model.has_covariates else ()
        if self.batched_log_like is not None:
            return self.batched_log_like(gens[0], params, ys, *cov)
        if self.custom_log_like is not None:
            vals = [torch.stack([self.custom_log_like(g, params[c], ys, *cov)
                                 for _ in range(self.num_replicates)])
                    for c, g in enumerate(gens)]
            return logmeanexp(torch.stack(vals), dim=-1)
        bank = replicated_log_like_fn(self.model, self.num_particles,
                                      self.num_replicates, self.resampler,
                                      self.resample_every)
        return bank(gens[0], params, ys, zs)

    @staticmethod
    def _covariates(zs, ys):
        """``zs`` as a float32 tensor on ``ys``'s device (None stays
        None); a tensor already there is used as it is."""
        if zs is None:
            return None
        return torch.as_tensor(zs, dtype=torch.float32, device=ys.device)

    def _update_moments_and_ct(self, theta, mean, sigma_hat, ct, i: int):
        """Branch-free ``update_moments_and_Ct`` for all chains; ``i`` is
        the number of samples seen so far (a host integer)."""
        fi = float(i)
        d = theta.shape[-1]
        if i >= 2:
            shrink = max(fi - 2.0, 0.0) / max(fi - 1.0, 1.0)
            diff = theta - mean
            sigma_hat = (sigma_hat * shrink
                         + diff[:, :, None] * diff[:, None, :] / max(fi, 1.0))
        if i >= 1:
            mean = ((fi - 1.0) * mean + theta) / max(fi, 1.0)
        if self.t0 < i < self.t1:
            eye = torch.eye(d, dtype=theta.dtype, device=theta.device)
            ct = self._sd * (sigma_hat + self.eps * eye)
        return mean, sigma_hat, ct

    @staticmethod
    def _accept(theta, old_ll, old_lp, accept_ma, proposed, new_ll, new_lp,
                log_u, i: int):
        log_accept = new_lp + new_ll - old_lp - old_ll
        accepted = log_u < log_accept  # NaN -> False
        theta = torch.where(accepted[:, None], proposed, theta)
        old_ll = torch.where(accepted, new_ll, old_ll)
        old_lp = torch.where(accepted, new_lp, old_lp)
        fi = float(i)
        accept_ma = (accepted.to(theta.dtype) / (fi + 1.0)
                     + fi * accept_ma / (fi + 1.0))
        return theta, old_ll, old_lp, accept_ma, log_accept, accepted

    # ------------------------------------------------------------------
    def init(self, seed: int, start_trans_theta, ys, c0=None,
             num_chains=1, device=None, zs=None) -> PMMHState:
        """Evaluate the starting point for every chain.

        ``start_trans_theta``: (d,) shared or (C, d) per chain.  ``c0``:
        initial proposal covariance (d, d), default 0.15 I.  ``device``
        defaults to the device of ``ys``.  ``zs``: (T, dim_cov)
        covariates of a model that has them.
        """
        with profiling.span("pmmh.init"):
            ys = torch.as_tensor(ys)
            zs = self._covariates(zs, ys)
            device = ys.device if device is None else torch.device(device)
            d = self.model.dim_param
            start = torch.as_tensor(start_trans_theta, dtype=torch.float32,
                                    device=device)
            if start.ndim == 1:
                start = start.expand(num_chains, d)
            start = start.contiguous()
            c = start.shape[0]
            if c0 is None:
                c0 = 0.15 * torch.eye(d, dtype=torch.float32)
            c0 = torch.as_tensor(c0, dtype=torch.float32, device=device)
            c0 = c0.expand(c, d, d).contiguous()
            gens = chain_generators(seed, c, device)
            return PMMHState(
                trans_theta=start,
                log_like=self._log_like(gens, start, ys, zs),
                log_prior=self._log_prior_with_jacobian(start),
                mean=torch.zeros((c, d), device=device),
                sigma_hat=torch.zeros((c, d, d), device=device),
                ct=c0,
                accept_ma=torch.zeros((c,), device=device),
                iteration=0,
                generators=gens,
            )

    def draw(self, state: PMMHState):
        """Each chain's proposal normals (C, d) and log-uniform (C,)."""
        with profiling.span("pmmh.draw", key=state.iteration + 1):
            d = state.trans_theta.shape[-1]
            kw = dict(dtype=state.trans_theta.dtype,
                      device=state.trans_theta.device)
            eps = torch.stack([torch.randn(d, generator=g, **kw)
                               for g in state.generators])
            u = torch.stack([torch.rand((), generator=g, **kw)
                             for g in state.generators])
            return eps, torch.log(u)

    def step(self, state: PMMHState, ys, eps=None, log_u=None, zs=None):
        """One MH iteration of every chain; returns (new state, the
        iteration's outputs).  ``eps`` (C, d) and ``log_u`` (C,) default
        to draws from the chains' generators; ``zs`` is used as given (on
        the device of ``ys``)."""
        i = state.iteration + 1
        with profiling.span("pmmh.step", key=i):
            if eps is None:
                eps, log_u = self.draw(state)
            with profiling.span("pmmh.adapt"):
                mean, sig, ct = self._update_moments_and_ct(
                    state.trans_theta, state.mean, state.sigma_hat,
                    state.ct, i)
            with profiling.span("pmmh.propose"):
                chol = rv.chol_with_jitter(ct)
                proposed = (state.trans_theta
                            + torch.matmul(chol, eps[..., None])[..., 0])
            with profiling.span("pmmh.prior"):
                new_lp = self._log_prior_with_jacobian(proposed)
            with profiling.span("pmmh.likelihood"):
                new_ll = self._log_like(state.generators, proposed, ys, zs)
            with profiling.span("pmmh.accept"):
                theta, ll, lp, ama, log_accept, accepted = self._accept(
                    state.trans_theta, state.log_like, state.log_prior,
                    state.accept_ma, proposed, new_ll, new_lp, log_u, i)
            new_state = PMMHState(theta, ll, lp, mean, sig, ct, ama, i,
                                  state.generators)
            return new_state, (theta, ll, lp, new_ll, new_lp, log_accept,
                               accepted, ama)

    def run_from(self, state: PMMHState, num_iters: int, ys,
                 zs=None) -> PMMHResult:
        """Advance every chain ``num_iters`` MH iterations (resumable)."""
        ys = torch.as_tensor(ys)
        zs = self._covariates(zs, ys)
        outs = []
        for _ in range(int(num_iters)):
            state, out = self.step(state, ys, zs=zs)
            outs.append(out)
        c, d = state.trans_theta.shape
        if outs:
            cols = [torch.stack(col) for col in zip(*outs)]
        else:
            kw = dict(device=state.trans_theta.device)
            cols = [torch.zeros((0, c, d), **kw)] + [
                torch.zeros((0, c), **kw) for _ in range(5)] + [
                torch.zeros((0, c), dtype=torch.bool, **kw),
                torch.zeros((0, c), **kw)]
        thetas, lls, lps, new_lls, new_lps, log_accepts, accepteds, amas = cols
        return PMMHResult(
            samples=self.model.transform.constrain(thetas),
            trans_samples=thetas,
            log_likes=lls,
            log_priors=lps,
            new_log_likes=new_lls,
            new_log_priors=new_lps,
            log_accept_probs=log_accepts,
            accepted=accepteds,
            accept_rate=amas,
            final_state=state,
        )

    @staticmethod
    def reset_adaptation(state: PMMHState) -> PMMHState:
        """Warm-restart the Haario adaptation: zero the running moments
        and the accept-rate average, keeping positions, likelihoods and
        the current proposal covariance."""
        return state._replace(
            mean=torch.zeros_like(state.mean),
            sigma_hat=torch.zeros_like(state.sigma_hat),
            iteration=0,
            accept_ma=torch.zeros_like(state.accept_ma))

    def run(self, seed: int, start_trans_theta, num_iters, ys, c0=None,
            num_chains=1, device=None, zs=None) -> PMMHResult:
        """Init at the start point, then ``num_iters`` iterations."""
        state = self.init(seed, start_trans_theta, ys, c0=c0,
                          num_chains=num_chains, device=device, zs=zs)
        return self.run_from(state, num_iters, ys, zs=zs)

    def sample(self, seed: int, start_trans_theta, num_iters, ys, c0=None,
               num_chains=1, chunk_size=250, sample_writer=None,
               message_writer=None, checkpoint_path=None,
               checkpoint_every_chunks=2, device=None, zs=None):
        """Host-driven chunked sampling with streaming output.

        Chunks of ``chunk_size`` iterations run on the device; between
        chunks the results come to the host once, stream to the writers
        (a single writer records chain 0, a list one chain per writer),
        and the chain state checkpoints atomically, so a killed run
        resumes exactly.  Returns (samples (iters run by this call, C, d)
        as numpy, final PMMHState).
        """
        from ssme_tpu_torch.io.checkpoint import (load_checkpoint,
                                                  save_checkpoint)

        ys = torch.as_tensor(ys)
        zs = self._covariates(zs, ys)
        state = self.init(seed, start_trans_theta, ys, c0=c0,
                          num_chains=num_chains, device=device, zs=zs)
        done = 0
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            state, meta = load_checkpoint(checkpoint_path,
                                          device=state.trans_theta.device)
            done = int(meta.get("completed_iters", 0))
        all_samples = []
        chunk_idx = 0
        while done < num_iters:
            take = min(int(chunk_size), num_iters - done)
            res = self.run_from(state, take, ys, zs=zs)
            state = res.final_state
            host = PMMHResult(*[t.cpu().numpy() for t in res[:-1]],
                              final_state=state)
            all_samples.append(host.samples)
            for writers in (sample_writer, message_writer):
                if writers is None:
                    continue
                if not isinstance(writers, (list, tuple)):
                    writers = [writers]
                for chain, w in enumerate(writers):
                    w.record_result(host, chain=chain, start_iter=done)
            done += take
            chunk_idx += 1
            if (checkpoint_path is not None
                    and chunk_idx % checkpoint_every_chunks == 0):
                save_checkpoint(checkpoint_path, state,
                                {"completed_iters": done})
        if checkpoint_path is not None:
            save_checkpoint(checkpoint_path, state, {"completed_iters": done})
        if not all_samples:
            d = self.model.dim_param
            return np.zeros((0, state.trans_theta.shape[0], d),
                            np.float32), state
        return np.concatenate(all_samples), state


__all__ = ["AdaptivePMMH", "PMMHResult", "PMMHState", "chain_generators",
           "generator_from_seed", "HOST_SPANS"]
