"""Float64 PMMH oracle: the reference's exact algorithm, in PyTorch.

PyTorch counterpart of ``ssme_tpu/oracle.py``, the judge of the accuracy
gate (``examples/accuracy_gate.py``): the same names and the same
algorithm, in float64 on an explicit device.

- adaptive MVN random walk on the transformed space with the Haario
  moment recursion, sd = 2.4^2/d, eps = .01;
- the log-Jacobian of {null, twice_fisher, log} in the MH ratio;
- the univariate-SVOL bootstrap PF likelihood with EVERY-STEP
  multinomial resampling;
- the replicates' log-mean-exp;
- a NaN acceptance ratio rejects.

The R replicates of a likelihood run as the rows of one (R, N) filter on
the device, drawn from one ``torch.Generator`` there.  A row's total is
frozen at the first step where it is not finite, the value the
reference's early return gives, with no read of the device inside the
loop over time.  The MH chain itself (a 3-vector, its moments and the
proposal's Cholesky factor) stays in float64 on the host with a CPU
generator of its own; the one read of the device per iteration is the
proposal's log-likelihood.  Agreement with ``ssme_tpu.oracle`` is to
float tolerance for the deterministic pieces and in distribution for
the filter and the chain (the random streams differ).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

SD = 2.4 * 2.4 / 3.0   # ada_pmmh_mvn.h:185
EPS = 0.01             # ada_pmmh_mvn.h:186

_F64 = torch.float64
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
# elements (rows x particles x steps) of the normals and uniforms drawn in
# one call to the generator: a few MB, so that the loop over time draws
# in bulk instead of launching two draws a step
_DRAW_ELEMENTS = 1 << 20


def constrain(z):
    """transforms {null, twice_fisher, log} (estimate_univ_svol.h:155);
    a float64 tensor on ``z``'s device."""
    z = torch.as_tensor(z, dtype=_F64)
    return torch.stack((z[0], torch.tanh(0.5 * z[1]), torch.exp(z[2])))


def log_jacobian(z):
    """parameters.h:334-338 (null), :376-380 (twice_fisher), :447-448
    (log)."""
    z = torch.as_tensor(z, dtype=_F64)
    return float((math.log(2.0) + z[1] - 2.0 * torch.log1p(torch.exp(z[1])))
                 + z[2])


def log_prior(theta_c):
    """beta~N(1,1), phi~U(0,1), ss~InvGamma(1e-3,1e-3)
    (estimate_univ_svol.h:94-101)."""
    beta, phi, ss = (float(v) for v in theta_c)
    # a product, not ** 2: a Python float's power raises on overflow
    lp_beta = -0.5 * math.log(2 * math.pi) - 0.5 * (beta - 1.0) * (beta - 1.0)
    lp_phi = 0.0 if 0.0 < phi < 1.0 else -math.inf
    a = b = 1e-3
    if ss <= 0:
        lp_ss = -math.inf
    else:
        lp_ss = (a * math.log(b) - math.lgamma(a) - (a + 1.0) * math.log(ss)
                 - b / ss)
    return lp_beta + lp_phi + lp_ss


def _pf_rows(gen, theta_c, ys, n_particles, n_rows):
    """(n_rows,) float64 log-likelihoods of ``n_rows`` independent
    bootstrap filters on ``gen``'s device (``pf_loglike`` per row).

    A row's total stays at its first non-finite value (the reference's
    early return): once a row's weights are all zero its -inf could turn
    into NaN, and the chain treats the two differently.  Resampling is an
    inverse-CDF draw on the unnormalised weights (numpy's
    ``choice(n, n, p=p)``), clamped to the last particle, so a dead row's
    NaN weights only give indices in a row already frozen."""
    dev = gen.device
    ys = torch.as_tensor(ys, dtype=_F64, device=dev).reshape(-1)
    with np.errstate(all="ignore"):
        beta, phi, ss = (np.float64(float(v)) for v in theta_c)
        sigma = np.sqrt(ss)
        sd0 = sigma / np.sqrt(1.0 - phi * phi)
    beta, phi, sigma, sd0 = float(beta), float(phi), float(sigma), float(sd0)
    t_len, n = ys.shape[0], n_particles
    block = max(1, _DRAW_ELEMENTS // (n_rows * n))
    total = torch.zeros(n_rows, dtype=_F64, device=dev)
    x = None
    for start in range(0, t_len, block):
        steps = min(block, t_len - start)
        eps = torch.randn((steps, n_rows, n), generator=gen, dtype=_F64,
                          device=dev)
        u = torch.rand((steps, n_rows, n), generator=gen, dtype=_F64,
                       device=dev)
        if x is None:
            x = eps[0] * sd0
        eps.mul_(sigma)
        for s in range(steps):
            t = start + s
            if t > 0:
                x = torch.add(eps[s], x, alpha=phi)   # phi x + sigma eps
            sd = torch.mul(x, 0.5).exp_().mul_(beta)
            r = torch.div(ys[t], sd)
            # -log(2 pi) / 2 - log(sd) - (y / sd)^2 / 2
            lw = torch.rsub(torch.log(sd).addcmul_(r, r, value=0.5),
                            -_HALF_LOG_2PI)
            m = torch.amax(lw, dim=1, keepdim=True)
            w = torch.sub(lw, m).exp_()
            inc = torch.log(w.sum(dim=1)).add_(m[:, 0])
            total = torch.where(torch.isfinite(total), total + inc, total)
            if t < t_len - 1:     # the last step's resample changes nothing
                cdf = torch.cumsum(w, dim=1)
                idx = torch.searchsorted(cdf, u[s].mul_(cdf[:, -1:]),
                                         right=True)
                x = torch.gather(x, 1, idx.clamp_(max=n - 1))
    # log mean w = log sum w - log N, taken out of the loop
    return total - t_len * math.log(n)


def pf_loglike(rng, theta_c, ys, n_particles):
    """Bootstrap PF, every-step multinomial resampling, float64, on
    ``rng``'s device (estimate_univ_svol.h:108-131 driving pf's BSFilter
    with mn_resampler); log cond-like per step = log mean weight."""
    return float(_pf_rows(rng, theta_c, ys, n_particles, 1)[0])


def loglike_reps(rng, z, ys, n_particles, n_replicates):
    """Replicate log-mean-exp (thread_pool.h:259-273); the replicates run
    as one batch on ``rng``'s device.  A NaN replicate gives NaN."""
    vals = _pf_rows(rng, constrain(z), ys, n_particles, n_replicates).cpu()
    m = torch.amax(vals)          # propagates NaN, as np.max
    if not torch.isfinite(m):
        return float(m)
    return float(m + torch.log(torch.mean(torch.exp(vals - m))))


def _generators(seed, device):
    """(the MH chain's CPU generator, the filters' generator on
    ``device``), seeded from ``seed`` by two independent words."""
    mh_seed, pf_seed = np.random.SeedSequence(seed).generate_state(
        2, dtype=np.uint64)
    mh = torch.Generator().manual_seed(int(mh_seed))
    pf = torch.Generator(device=device).manual_seed(int(pf_seed))
    return mh, pf


def oracle_pmmh(seed, ys, start_z, n_iters, n_particles, n_replicates,
                t0, t1, c0_scale=0.15, progress_every=0, *, device="cuda"):
    """The reference's commence_sampling loop (ada_pmmh_mvn.h:326-372),
    float64, the likelihoods on ``device`` (default the card; raises
    without one).  Returns (n_iters, 3) CONSTRAINED samples, a float64
    numpy array."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("oracle_pmmh on cuda: no CUDA device is "
                           "available (pass device='cpu')")
    rng, pf_rng = _generators(seed, device)
    ys = torch.as_tensor(ys, dtype=_F64, device=device).reshape(-1)
    d = 3
    z = torch.as_tensor(start_z, dtype=_F64).clone()
    mean = torch.zeros(d, dtype=_F64)
    sig = torch.zeros((d, d), dtype=_F64)
    eye = torch.eye(d, dtype=_F64)
    ct = c0_scale * eye
    old_lp = log_prior(constrain(z)) + log_jacobian(z)
    old_ll = loglike_reps(pf_rng, z, ys, n_particles, n_replicates)
    out = torch.empty((n_iters, d), dtype=_F64)
    n_acc = 0
    for i in range(1, n_iters + 1):
        # update_moments_and_Ct with the CURRENT position (:338,:213-250)
        if i >= 2:
            sig = (sig * (max(i - 2, 0) / (i - 1))
                   + torch.outer(z - mean, z - mean) / i)
        mean = ((i - 1) * mean + z) / i
        if t0 < i < t1:
            ct = SD * (sig + EPS * eye)
        # MVN proposal on the transformed space (:341,:260-269)
        chol = torch.linalg.cholesky(ct)
        z_new = z + chol @ torch.randn(d, generator=rng, dtype=_F64)
        new_lp = log_prior(constrain(z_new)) + log_jacobian(z_new)
        if math.isfinite(new_lp):
            new_ll = loglike_reps(pf_rng, z_new, ys, n_particles,
                                  n_replicates)
        else:
            new_ll = -math.inf
        log_accept = new_lp + new_ll - old_lp - old_ll
        log_u = float(torch.log(torch.rand((), generator=rng, dtype=_F64)))
        if log_u < log_accept:   # NaN -> False, reference :349
            z, old_lp, old_ll = z_new, new_lp, new_ll
            n_acc += 1
        out[i - 1] = constrain(z)
        if progress_every and i % progress_every == 0:
            print(f"oracle iter {i}/{n_iters} accept={n_acc / i:.3f} "
                  f"theta={out[i - 1].numpy()}", file=sys.stderr, flush=True)
    return out.numpy()


def batch_means_se(x, n_batches=20):
    """MC standard error of the mean via batch means (handles the heavy
    autocorrelation of an MCMC chain)."""
    x = np.asarray(x)
    n = (len(x) // n_batches) * n_batches
    bm = x[:n].reshape(n_batches, -1).mean(axis=1)
    return bm.std(ddof=1) / np.sqrt(n_batches)


__all__ = ["constrain", "log_jacobian", "log_prior", "pf_loglike",
           "loglike_reps", "oracle_pmmh", "batch_means_se", "SD", "EPS"]
