"""Whole-sequence Liu-West filter bank over model hooks: the CUDA template
kernel and its plain PyTorch version.

Replaces ``ssme_tpu/ops/liu_west_megakernel.py::lw_megakernel``: F
independent Liu-West filters, each on a joint (state, theta) cloud of N
particles, over T observations in one launch.  Per step: weighted
shrinkage moments of the transformed parameters, a P x P Cholesky of
h^2 Vt, the auxiliary-PF first stage (``variant="apf"``) or the SISR
form, kernel draws theta' = a theta + (1 - a) theta_bar + L e, the
transition, the weights and the conditional likelihood, the model's
functionals, and the joint resample on schedule or under the ESS gate.

An :class:`LWKernelModel` supplies hooks over one step of the bank, with
``cp`` the (P, F, N) constrained parameters (one per particle), ``state``
a tuple of ``num_state`` (F, N) leaves, ``y``/``z`` tuples of the step's
observation and covariate scalars:

- ``sample_prior(rng, shape) -> (P, F, N)``   constrained prior draws
- ``init(rng, cp, y, shape) -> state``        the t = 0 draw
- ``propagate(rng, cp, state, y, z) -> state``  the transition draw
- ``log_weight(cp, state, y, z) -> (F, N)``   the observation density
- ``prop_mu(cp, state, y, z) -> state``       the APF lookahead
- optional ``sample_q`` / ``log_fq``: the SISR form's own proposal and
  its log f - log q correction (default: the transition, 0)
- optional ``functionals``: ``h(cp, state) -> (F, N)`` whose
  self-normalised filtered means are emitted per step.

``transform_codes`` names each parameter's bijection (null, log, logit,
twice_fisher): the cloud keeps theta transformed, and hooks receive it
constrained.  ``rng.uniform(shape)`` returns the kernel's prior uniforms
and ``rng.normal(shape)`` the kernel's Philox normals of the step: a
hook's draw j is normal draw P + j, since draws 0 .. P-1 are the kernel
draws of theta (``ops/_prng.py``).

The kernel is one template over the functors of ``csrc/lw_models.cuh``,
``csrc/lw_megakernel_sys.cuh`` (kPer neighbouring particles per thread,
paired draws, 8 barriers in an APF step that resamples), in two families:
systematic (2 particles a thread, the values in registers) and roll (2, 4
or 8 a thread, the values in shared memory); the systematic family runs
in one of two layouts (:func:`layout_for`): "paired", each filter on a
cluster of two CTAs, one drawing the step's normals and offsets into the
other's shared memory (``csrc/lw_ring.cuh``), when the card holds every
filter's cluster at once, else "single", one CTA a filter; both give the
same bits.  ``csrc/lw_megakernel.cuh`` gives the step recursion and the
intended divergences from the Pallas kernel.  On a CUDA tensor only a
model whose ``cuda_instance`` names a functor there runs (a custom SISR
proposal too: the functor's, ``svol_leverage_lw_q_kernel_model``);
anything else raises.  Selection (``resampler``): "systematic" at N up
to 1024 (``MAX_LW_KERNEL_PARTICLES``), or the roll-based "metropolis" and
"rejection" resamplers (``ops/_select.py``) at a power-of-two N up to
4096 (``MAX_LW_METROPOLIS_PARTICLES``), moving the joint (state, logw,
theta) column by one ancestor index.  :func:`step_spans` reads either
family's instrumented twins.  On a CPU tensor every model
runs through :func:`lw_megakernel_reference`, which calls the hooks step
by step with the kernel's random bits.  The carried log-weights are
renormalised by their maximum after every step (the conditional
likelihoods are unchanged), so the cloud's log-weight row has maximum 0;
the decoders normalise it.  The cloud has rows [state x S, logw, theta x
P], without the Pallas kernel's zero pad rows.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable

import torch

from ssme_tpu_torch import profiling
from ssme_tpu_torch.ops import _cuda, _prng
from ssme_tpu_torch.ops._select import (RESAMPLER_CODES, as_rows,
                                        check_particles, check_resampler,
                                        plain_ancestor_fn, resample_rows)

# the profiling spans opened here: ``lw_megakernel``'s validation (on
# both paths) and each launch, from the prior box to the C call, keyed by
# its instance and layout (launch_key)
HOST_SPANS = ("lw.validate", "lw_megakernel.launch")

# the launch layouts (csrc/lw_megakernel_sys.cuh): the systematic family's
# cluster of two CTAs a filter, and one CTA a filter (every roll launch)
LAYOUTS = ("paired", "single")

# the dispatch table of csrc/lw_models.cuh (same names, same numbers;
# tests/test_torch_lw_megakernel.py parses the header and compares)
CUDA_LW_MODEL_IDS = {"svol_leverage_lw": 0, "svol_t_lw": 1,
                     "svol_leverage_lw_q": 2, "factor_svol_5_lw": 3}
# the instances whose functor has a SISR proposal (kHasProposal)
_CUDA_LW_PROPOSALS = frozenset({"svol_leverage_lw_q"})

# the systematic selection: N up to this (JAX's cap)
MAX_LW_KERNEL_PARTICLES = 1024
# the roll resamplers: a power of two up to this, several particles per
# thread above 1024 (JAX's name and cap)
MAX_LW_METROPOLIS_PARTICLES = 4096

_EPS_CHOL = 1e-9
_CODES = ("null", "log", "logit", "twice_fisher")
# the kernel's argument block: prior box and model constants
# (csrc/lw_megakernel.cuh kMaxParams: factor_svol_5_lw's 21)
_MAX_PARAMS = 21
_MAX_MODEL_ARGS = 4
# parameters above which the systematic family runs its wide row, theta
# in shared memory (csrc/lw_megakernel_sys.cuh kRegParams, lw_wide_row):
# both layouts, and no roll form
REG_PARAMS = 8
# the wide row's Cholesky: a pivot at or below this share of its column's
# diagonal leaves the rest of the column 0 (csrc/lw_megakernel_sys.cuh
# kRankRel, the semi-definite factor of a cloud that spans fewer than P
# directions)
_RANK_REL = 1e-4


def wide_row_bytes(kmodel, num_particles, paired=False):
    """Dynamic shared memory of the wide row of ``kmodel`` at N (csrc/
    lw_megakernel_sys.cuh WideRowLayout::bytes): theta's P leaves and the
    gather buffer's S + 1, each the padded row rounded up to 4 mod 32
    words (wide_leaf),
    then the single layout's stash of the step's P + kDraws normal pairs
    a thread (single_bytes) or, ``paired``, rank 0's ring of one step
    (pair_bytes: P + kDraws normal pairs a thread and the offsets)."""
    n, p, s = int(num_particles), kmodel.num_params, kmodel.num_state
    leaf = (n + n // 32 + 27) // 32 * 32 + 4
    threads = -(-n // 2 // 32) * 32
    dynamic = 4 * (p + s + 1) * leaf
    if not paired:
        return dynamic + 8 * (p + s) * threads   # the stash of normals
    return dynamic + 16 + 8 * (1 + (p + kmodel.num_state) * threads)


def launch_key(instance, layout):
    """The key of a launch's count (``_cuda.launches("ssme_lw_megakernel",
    key)``) and of its ``lw_megakernel.launch`` span: the CUDA instance
    and the layout, e.g. ``factor_svol_5_lw.single``."""
    return f"{instance}.{layout}"


def _to_transformed(code, row):
    """Constrained -> unconstrained, with the Pallas kernel's float
    operations (``parameters.h`` forward maps)."""
    if code == "null":
        return row
    if code == "log":
        return torch.log(row)
    if code == "logit":
        return torch.log(row) - torch.log1p(-row)
    if code == "twice_fisher":
        return torch.log1p(row) - torch.log1p(-row)
    raise ValueError(f"unknown transform code {code!r}")


def _to_constrained(code, row):
    """Unconstrained -> constrained (the inverse maps)."""
    if code == "null":
        return row
    if code == "log":
        return torch.exp(row)
    if code == "logit":
        return 1.0 / (1.0 + torch.exp(-row))
    if code == "twice_fisher":
        return torch.tanh(0.5 * row)
    raise ValueError(f"unknown transform code {code!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class LWKernelModel:
    """A Liu-West model as batched hooks (see the module docstring).

    ``cuda_instance``: the functor of ``csrc/lw_models.cuh`` computing the
    same hooks, or None for a model that runs on CPU tensors only;
    ``prior_bounds`` and ``cuda_args``: the call-time arguments of that
    functor (its uniform prior box, its model constants)."""

    num_params: int
    transform_codes: tuple
    sample_prior: Callable
    init: Callable
    propagate: Callable
    log_weight: Callable
    prop_mu: Callable = None
    sample_q: Callable = None       # SISR proposal; default = propagate
    log_fq: Callable = None         # SISR log f - log q; default = 0
    functionals: tuple = None       # optional h_k(cp, state) -> (F, N)
    num_state: int = 1
    dim_obs: int = 1
    dim_cov: int = 0
    name: str = "lw_kernel_model"
    cuda_instance: str = None
    prior_bounds: tuple = None
    cuda_args: tuple = ()

    def __post_init__(self):
        if len(self.transform_codes) != self.num_params:
            raise ValueError("transform_codes must have one code per "
                             "parameter")
        for c in self.transform_codes:
            if c not in _CODES:
                raise ValueError(f"unknown transform code {c!r}")
        if (self.sample_q is None) != (self.log_fq is None):
            raise ValueError(
                "sample_q and log_fq must be supplied together: a "
                "custom SISR proposal (qSamp) requires its logF - logQ "
                "weight correction, and vice versa")

    @property
    def tile_rows(self):
        """Cloud rows: [state x S, logw, theta x P]."""
        return self.num_state + 1 + self.num_params

    def constrain(self, th):
        """(P, ...) transformed -> (P, ...) constrained."""
        return torch.stack([_to_constrained(c, th[i])
                            for i, c in enumerate(self.transform_codes)])

    def transform(self, cp):
        """(P, ...) constrained -> (P, ...) transformed."""
        return torch.stack([_to_transformed(c, cp[i])
                            for i, c in enumerate(self.transform_codes)])


class _PlainRng(_prng.StepBlocks):
    """The ``rng`` the plain version hands to the hooks: the kernel's
    prior uniforms, and its normals of the current step starting at draw
    P (draws 0 .. P-1 are the kernel draws of theta).  Draws 0 .. P and
    both offsets (``offsets(t, tag)``, tags 1 and ``TAG_SELECT_OFFSET``)
    come in blocks of steps; later draws a step at a time."""

    def __init__(self, seed, rows, num_particles, num_steps, num_params):
        super().__init__(seed, rows, num_particles, num_steps,
                         width=num_params + 1, first_draw=num_params)
        self.num_params = num_params

    def normals(self, t, draw=0):
        """(F, N) normals of draw ``draw`` at step ``t``."""
        if draw <= self.num_params:
            return super().normals(t, draw)
        return _prng.normals_steps(
            self.seed, self.rows,
            torch.arange(t, t + 1, device=self.seed.device), self.n,
            draw=draw)[0]

    def uniform(self, shape):
        u = _prng.prior_uniforms(self.seed, self.rows, self.n,
                                 self.num_params)
        if tuple(shape) != tuple(u.shape):
            raise ValueError(f"rng.uniform({tuple(shape)}): the kernel draws "
                             f"the prior block {tuple(u.shape)}")
        return u


def _validate(kmodel, seed, ys, zs, num_filters, num_particles,
              resample_every, variant, ess_threshold, resampler,
              metropolis_iters=16):
    if not isinstance(ys, torch.Tensor):
        raise ValueError("ys must be a tensor")
    dev = ys.device
    if ys.ndim == 1 and kmodel.dim_obs > 1:
        ys = ys.reshape(-1, kmodel.dim_obs)
    ys = as_rows("ys", ys, None, kmodel.dim_obs, dev)
    if kmodel.dim_cov:
        if zs is None:
            raise ValueError(f"model {kmodel.name!r} needs covariates zs")
        zs = as_rows("zs", zs, ys.shape[0], kmodel.dim_cov, dev)
    elif zs is not None:
        raise ValueError(
            f"model {kmodel.name!r} has dim_cov=0 but covariates zs were "
            "supplied: build the kernel model with dim_cov set if the "
            "model should see them")
    check_resampler(resampler, metropolis_iters)
    n = int(num_particles)
    beyond = (f"above {MAX_LW_KERNEL_PARTICLES} use resampler='metropolis' "
              "(sweep-dependent evidence bias, _select."
              "metropolis_bias_estimate) or 'rejection', cap "
              f"{MAX_LW_METROPOLIS_PARTICLES}, or the generic filter "
              "(filters.LiuWestFilter)" if resampler == "systematic" else
              f"num_particles={n} exceeds the metropolis cap "
              f"{MAX_LW_METROPOLIS_PARTICLES}; use filters.LiuWestFilter")
    check_particles(n, resampler, roll_cap=MAX_LW_METROPOLIS_PARTICLES,
                    beyond=beyond)
    if variant not in ("apf", "sisr"):
        raise ValueError("variant must be 'apf' or 'sisr'")
    if variant == "apf" and kmodel.prop_mu is None:
        raise ValueError(f"model {kmodel.name!r} has no prop_mu hook "
                         "(required for the APF form)")
    if int(resample_every) != resample_every or resample_every < 1:
        raise ValueError("resample_every must be >= 1 (1 = the reference "
                         "schedule, liu_west_filter.h:480-481)")
    if int(num_filters) != num_filters or num_filters < 1:
        raise ValueError("num_filters must be a positive integer")
    seed = _prng.seed_words(seed, device=dev)
    if seed.device != dev:
        raise ValueError(f"seed is on {seed.device}, ys on {dev}")
    return seed, ys, zs


def _coefficients(delta):
    """(a, 1 - a, h^2) of the kernel shrinkage, in double on the host."""
    a = (3.0 * delta - 1.0) / (2.0 * delta)
    return a, 1.0 - a, 1.0 - a * a


def _fma_sub(a, b, c):
    """c - a b rounded once, as the kernel's fmaf(-a, b, c), of float32
    tensors: the product of two floats is exact in double."""
    return (c.double() - a.double() * b.double()).float()


def _cholesky(gram, h2, p, rank_rel=None):
    """Lower P x P Cholesky of h2 * gram with the floored diagonal, on
    lists of (F, 1) entries (h2: h^2, or the wide row's (F, 1) h^2 / sum
    w); every thread of the kernel does the same.
    With ``rank_rel`` (the wide row's rule, csrc/lw_megakernel_sys.cuh
    kRankRel) a pivot at or below rank_rel of its column's h^2 gram_jj
    leaves the rest of its column 0, and the arithmetic is the wide row's
    (wide_cholesky): each term one fused multiply-add, the entries below
    the diagonal times the reciprocal square root of the floored pivot
    (torch.rsqrt: on the card the kernel's rsqrtf), so that both versions
    take the rule's decisions alike from one Gram.  A column's entries
    below the diagonal are computed as one (F, P - jj - 1) tensor, each
    with the operations of an entry's own loop (a product and a
    subtraction a term, k in order, then the divide): the entries of an
    entry-by-entry loop, in P^2 / 2 torch operations rather than P^3 /
    3."""
    wide = rank_rel is not None
    cols = []  # column k: rows k .. p-1, (F, p - k)
    for jj in range(p):
        diag = h2 * gram[jj][jj]
        s = diag
        for k in range(jj):
            ljk = cols[k][:, jj - k:jj - k + 1]
            s = _fma_sub(ljk, ljk, s) if wide else s - ljk * ljk
        floored = torch.clamp(s, min=_EPS_CHOL)
        d = torch.sqrt(floored)
        if jj + 1 == p:
            cols.append(d)
            break
        below = h2 * torch.cat([gram[i][jj] for i in range(jj + 1, p)], -1)
        for k in range(jj):
            lk, ljk = cols[k][:, jj - k + 1:], cols[k][:, jj - k:jj - k + 1]
            below = _fma_sub(lk, ljk, below) if wide else below - lk * ljk
        below = below * torch.rsqrt(floored) if wide else below / d
        if wide:
            below = torch.where(s > rank_rel * diag, below,
                                torch.zeros_like(below))
        cols.append(torch.cat([d, below], -1))
    return [[cols[k][:, i - k:i - k + 1] if k <= i else None
             for k in range(p)] for i in range(p)]


def wide_moments(th, lw):
    """The wide row's shrinkage moments (csrc/lw_megakernel_sys.cuh
    moments_pass and moments_fold) of the (P, F, N) float32 cloud ``th``
    under the carried log-weights ``lw`` (F, N), in float64 as the
    kernel's tensor cores take them: about c, particle 0's theta, each
    particle's rows X = [w (theta - c), w] and D = [theta - c, 1], G =
    X' D in one product, then C = G - m m' / sum w and tbar = c + m / sum
    w (m: G's last row), rounded to float32 where the kernel keeps tbar,
    sum w and C.  Returns tbar (P entries (F, 1)), sum w (F, 1) and C, the
    weighted Gram about tbar, as :func:`_cholesky` takes it (entry (i, j
    <= i) an (F, 1) float32 tensor, None above the diagonal)."""
    p = th.shape[0]
    w = torch.exp(lw).double()[..., None]                     # (F, N, 1)
    c = th[:, :, :1].double()                                 # (P, F, 1)
    d = (th.double() - c).permute(1, 2, 0)                    # (F, N, P)
    g = torch.einsum("fna,fnb->fab", torch.cat([d * w, w], -1),
                     torch.cat([d, torch.ones_like(w)], -1))
    sw = g[:, p, p:]                                          # (F, 1)
    q = g[:, p, :p] / sw                                      # (F, P)
    cen = (g[:, :p, :p] - q[:, :, None] * g[:, p, None, :p]).float()
    tbar = (c[:, :, 0].T + q).float()
    gram = [[cen[:, i, j:j + 1] for j in range(i + 1)] + [None] * (p - i - 1)
            for i in range(p)]
    return [tbar[:, k:k + 1] for k in range(p)], sw.float(), gram


def _gather(leaves, anc):
    return tuple(torch.gather(v, 1, anc) for v in leaves)


def lw_megakernel_reference(kmodel, seed, ys, zs=None, num_filters=1,
                            num_particles=512, delta=0.99, resample_every=1,
                            variant="apf", ess_threshold=0.0,
                            resampler="systematic", metropolis_iters=16,
                            start=None):
    """Plain PyTorch version of :func:`lw_megakernel`, callable on either
    device and with any :class:`LWKernelModel`; consumes the kernel's
    Philox bits step by step.  Under a roll resampler the APF first stage
    selects on ``_prng.TAG_ROLL_SELECT``, the joint resample on
    ``TAG_ROLL_SWEEP``, and only the firing filters run the sweep loop.
    ``start=(t0, cloud)`` (t0 >= 1) resumes at step t0 from ``cloud``, the
    cloud a run over ys[:t0] returns, and runs steps t0 .. T-1 alone (the
    log-likelihood terms and functional paths of the steps before t0 are
    0): the steps of one run from one state, for comparing a step of two
    versions without the steps before it."""
    seed, ys, zs = _validate(kmodel, seed, ys, zs, num_filters,
                             num_particles, resample_every, variant,
                             ess_threshold, resampler, metropolis_iters)
    roll = resampler != "systematic"
    f, n, t_len = int(num_filters), int(num_particles), ys.shape[0]
    p, s_rows = kmodel.num_params, kmodel.num_state
    dev = ys.device
    a, one_minus_a, h2 = _coefficients(delta)
    log_n = math.log(float(n))
    ess_limit = float(ess_threshold) * n
    fns = tuple(kmodel.functionals or ())
    apf = variant == "apf"
    filters = torch.arange(f, device=dev)
    rng = _PlainRng(seed, filters, n, t_len, p)
    lcl = torch.zeros((f, t_len), dtype=torch.float32, device=dev)
    fpaths = torch.zeros((len(fns), f, t_len), dtype=torch.float32,
                         device=dev)

    def obs_at(t):
        return (tuple(ys[t].unbind()),
                () if zs is None else tuple(zs[t].unbind()))

    def weigh(t, cp, state, lw):
        """Max, normalised weights and their sums; writes the functionals."""
        m = torch.amax(lw, dim=-1, keepdim=True)
        wn = torch.exp(lw - m)
        s = wn.sum(-1, keepdim=True)
        for k, h in enumerate(fns):
            fpaths[k, :, t] = ((h(cp, state) * wn).sum(-1, keepdim=True)
                               / s)[:, 0]
        return m, wn, s, (wn * wn).sum(-1, keepdim=True)

    def maybe_resample(t, wn, s, s2, state, th, lw):
        if ess_threshold > 0.0:
            fire = s * s / s2 < ess_limit
        elif resample_every == 1 or (t + 1) % resample_every == 0:
            fire = True
        else:
            return state, th, lw
        ancestors = plain_ancestor_fn(
            resampler, metropolis_iters, seed, filters, t, n,
            None if roll else rng.offsets(t))
        picked, lw, _ = resample_rows(ancestors, wn, state + tuple(th.unbind()),
                                      lw, None, fire, 0.0, roll)
        return picked[:s_rows], torch.stack(picked[s_rows:]), lw

    if start is None:
        # t = 0: the prior draw, the init draw, the first weights
        t0 = 1
        y, z = obs_at(0)
        cp = kmodel.sample_prior(rng.at(0), (f, n))
        th = kmodel.transform(cp)
        state = tuple(kmodel.init(rng.at(0), cp, y, (f, n)))
        lw = kmodel.log_weight(cp, state, y, z)
        m, wn, s, s2 = weigh(0, cp, state, lw)
        lcl[:, 0] = ((m + torch.log(s)) - log_n)[:, 0]
        lw = lw - m
        state, th, lw = maybe_resample(0, wn, s, s2, state, th, lw)
    else:
        t0, cloud = int(start[0]), start[1]
        if not 1 <= t0 < t_len or cloud.shape != (f, s_rows + 1 + p, n):
            raise ValueError(f"start: a step in [1, {t_len}) and a cloud of "
                             f"shape {(f, s_rows + 1 + p, n)}")
        state = tuple(cloud[:, :s_rows].unbind(1))
        lw = cloud[:, s_rows]
        th = cloud[:, s_rows + 1:].transpose(0, 1).contiguous()

    for t in range(t0, t_len):
        y, z = obs_at(t)
        # weighted shrinkage moments; lw has maximum 0
        if p > REG_PARAMS:
            # the Gram about tbar, scaled by h^2 / sum w as the kernel
            # scales it
            tbar, wsum, gram = wide_moments(th, lw)
            scale = torch.full_like(wsum, h2) / wsum
        else:
            ww = torch.exp(lw)
            wsum = ww.sum(-1, keepdim=True)
            tbar = [(th[k] * ww).sum(-1, keepdim=True) / wsum
                    for k in range(p)]
            # the Gram's entry (i, j <= i): sum over the particles of
            # (cen_i w) cen_j, over sum w; row i's products and quotients
            # one torch operation each, its sums one a column, as entry by
            # entry
            cen = th - torch.stack(tbar)
            gram = []
            for i in range(p):
                prod = (cen[i] * ww) * cen[:i + 1]
                row = torch.cat([prod[j].sum(-1, keepdim=True)
                                 for j in range(i + 1)], -1) / wsum
                gram.append([row[:, j:j + 1] for j in range(i + 1)]
                            + [None] * (p - i - 1))
            scale = h2
        lmat = _cholesky(gram, scale, p,
                         _RANK_REL if p > REG_PARAMS else None)
        shrunk = torch.stack([a * th[k] + one_minus_a * tbar[k]
                              for k in range(p)])
        if apf:
            look = tuple(kmodel.prop_mu(kmodel.constrain(th), state, y, z))
            lfs = lw + kmodel.log_weight(kmodel.constrain(shrunk), look, y, z)
            mfs = torch.amax(lfs, dim=-1, keepdim=True)
            wfs = torch.exp(lfs - mfs)
            anc = plain_ancestor_fn(
                resampler, metropolis_iters, seed, filters, t, n,
                None if roll else rng.offsets(t, _prng.TAG_SELECT_OFFSET),
                _prng.TAG_ROLL_SELECT)(wfs, None)
            # systematic: the CDF's last entry, as the kernel's scan total
            total = (wfs.sum(-1, keepdim=True) if roll
                     else torch.cumsum(wfs, dim=-1)[:, -1:])
            lse_fs = mfs + torch.log(total)
            picked = _gather(state + look + tuple(shrunk.unbind()), anc)
            state_anc = picked[:s_rows]
            look_anc = picked[s_rows:2 * s_rows]
            shrunk_anc = picked[2 * s_rows:]
        else:
            state_anc, shrunk_anc = state, tuple(shrunk.unbind())
        # theta' row i = shrunk_anc[i] + sum over k <= i, in k order, of
        # L[i][k] e_k: the rows k .. p-1 take draw k's term together
        th_new = torch.stack(tuple(shrunk_anc))
        for k in range(p):
            col = torch.stack([lmat[i][k] for i in range(k, p)])
            if p > REG_PARAMS:  # the wide row's fmaf
                th_new[k:] = _fma_sub(-col, rng.normals(t, k), th_new[k:])
            else:
                th_new[k:] += col * rng.normals(t, k)
        cp = kmodel.constrain(th_new)
        prop = (kmodel.sample_q if not apf and kmodel.sample_q is not None
                else kmodel.propagate)
        new_state = tuple(prop(rng.at(t), cp, state_anc, y, z))
        if apf:
            lw_new = (kmodel.log_weight(cp, new_state, y, z)
                      - kmodel.log_weight(kmodel.constrain(
                          torch.stack(shrunk_anc)), look_anc, y, z))
        else:
            inc = kmodel.log_weight(cp, new_state, y, z)
            if kmodel.log_fq is not None:
                inc = inc + kmodel.log_fq(cp, new_state, state_anc, y, z)
            lw_new = lw + inc
        m, wn, s, s2 = weigh(t, cp, new_state, lw_new)
        lse_new = m + torch.log(s)
        if apf:
            val = ((lse_fs - torch.log(wsum)) + lse_new) - log_n
        else:
            val = lse_new - torch.log(wsum)
        lcl[:, t] = val[:, 0]
        state, th, lw = maybe_resample(t, wn, s, s2, new_state, th_new,
                                       lw_new - m)

    cloud = torch.stack(state + (lw,) + tuple(th.unbind()), dim=1)
    return _result(lcl, fpaths, cloud, len(fns))


def _result(lcl, fpaths, cloud, n_fns):
    out = {"log_cond_likes": lcl, "log_likelihood": lcl.sum(-1),
           "cloud": cloud}
    if n_fns:
        out["functional_paths"] = tuple(fpaths.unbind(0))
    return out


def _model_id(kmodel) -> int:
    if kmodel.cuda_instance is None:
        raise ValueError(
            f"model {kmodel.name!r} has no CUDA instance: on a CUDA tensor "
            "only the functors of csrc/lw_models.cuh run "
            f"({sorted(CUDA_LW_MODEL_IDS)}); a model written as Python hooks "
            "runs on CPU tensors, through the plain version (ROADMAP.md "
            "section 3, D1)")
    try:
        model_id = CUDA_LW_MODEL_IDS[kmodel.cuda_instance]
    except KeyError:
        raise ValueError(f"unknown CUDA instance {kmodel.cuda_instance!r}; "
                         f"valid: {sorted(CUDA_LW_MODEL_IDS)}") from None
    if (kmodel.sample_q is not None) != (
            kmodel.cuda_instance in _CUDA_LW_PROPOSALS):
        raise ValueError(
            f"model {kmodel.name!r}: its sample_q / log_fq hooks and the "
            f"functor {kmodel.cuda_instance!r} disagree on a SISR proposal; "
            "on a CUDA tensor the functor's proposal runs, never a Python "
            f"hook (proposal functors: {sorted(_CUDA_LW_PROPOSALS)})")
    return model_id


def _host_floats(values, width):
    """A float32 host array of ``width`` (zero-padded), passed by pointer
    and copied into the kernel's argument block."""
    arr = (ctypes.c_float * width)()
    for k, v in enumerate(values):
        arr[k] = float(v)
    return arr


def layout_for(num_filters, max_clusters):
    """The layout of a systematic launch of ``num_filters`` filters:
    "paired" when the card holds all their clusters at once
    (``max_clusters``, what ``cudaOccupancyMaxActiveClusters`` reports for
    the paired instance), else "single" (a count of 0 included): past the
    count, clusters would wait for a second wave of SMs.  The wide row's
    paired form holds a ring of one step after its cloud (109 KB and 94
    KB at N = 1024; csrc/lw_megakernel_sys.cuh wide_pair_fits weighs the
    ring's bytes beside the row's), so the count covers it too."""
    return "paired" if num_filters <= max_clusters else "single"


@functools.cache
def _max_clusters(model_id, num_particles):
    """The card's count of co-resident clusters of the paired instance of
    ``model_id`` at N (its twin takes the same layout), asked once; a
    failed query raises."""
    count = ctypes.c_int(0)
    _cuda.call("ssme_lw_megakernel_clusters", model_id, num_particles,
               ctypes.byref(count))
    return count.value


def lw_megakernel(kmodel, seed, ys, zs=None, num_filters=1,
                  num_particles=512, delta=0.99, resample_every=1,
                  variant="apf", ess_threshold=0.0, resampler="systematic",
                  metropolis_iters=16):
    """Run ``num_filters`` whole-sequence Liu-West filters of ``kmodel``
    in one launch.

    seed: (2,) int64 Philox key words on the device of ``ys``, or a Python
    int; ys: (T,) or (T, dim_obs) float32; zs: (T,) or (T, dim_cov)
    covariates, required iff the model has them.  ``num_particles`` is a
    multiple of 32 in [32, 1024] under ``resampler="systematic"``, a power
    of two in [32, 4096] under "metropolis" (``metropolis_iters`` sweeps
    per selection) or "rejection".  ``variant``: "apf" or "sisr";
    ``ess_threshold > 0`` resamples a filter when its ESS falls below
    that fraction of N, else every ``resample_every`` steps.

    Returns ``log_cond_likes`` (F, T), ``log_likelihood`` (F,), ``cloud``
    (F, S + 1 + P, N) with rows [state x S, logw, theta_trans x P] (decode
    with :func:`lw_cloud_params` / :func:`lw_cloud_weights` /
    :func:`lw_cloud_states`) and, for a model with functionals,
    ``functional_paths``: a tuple of (F, T) self-normalised filtered
    means.

    Launches the kernel for CUDA tensors (raising for a model without a
    CUDA instance; ``_cuda.launches`` counts the launches by instance and
    layout, :func:`launch_key`) and runs :func:`lw_megakernel_reference`
    for CPU tensors.
    """
    with profiling.span("lw.validate"):
        seed, ys, zs = _validate(kmodel, seed, ys, zs, num_filters,
                                 num_particles, resample_every, variant,
                                 ess_threshold, resampler, metropolis_iters)
    if ys.device.type == "cpu":
        return lw_megakernel_reference(kmodel, seed, ys, zs, num_filters,
                                       num_particles, delta, resample_every,
                                       variant, ess_threshold, resampler,
                                       metropolis_iters)
    if ys.device.type != "cuda":
        raise ValueError(f"lw_megakernel: unsupported device {ys.device}")
    return _launch(kmodel, seed, ys, zs, num_filters, num_particles, delta,
                   resample_every, variant, ess_threshold, resampler,
                   metropolis_iters)


def _launch(kmodel, seed, ys, zs, num_filters, num_particles, delta,
            resample_every, variant, ess_threshold, resampler="systematic",
            metropolis_iters=16, spans=None):
    """One launch on the card of validated arguments: the instance
    ``ssme_lw_megakernel`` picks or, given ``spans`` (int64 (F,
    len(SPAN_RECORD))), its instrumented twin
    (``ssme_lw_megakernel_spans``), which writes its record there, in
    the layout :func:`layout_for` gives, counted under the instance and
    that layout (:func:`launch_key`).  Returns the result dict."""
    model_id = _model_id(kmodel)
    if kmodel.num_params > REG_PARAMS and resampler != "systematic":
        raise ValueError(
            f"model {kmodel.name!r}: at {kmodel.num_params} parameters the "
            "kernel runs systematic selection only (its wide row has no "
            f"roll form); resampler={resampler!r} runs on CPU tensors")
    layout = "single"
    if resampler == "systematic":
        layout = layout_for(num_filters,
                            _max_clusters(model_id, int(num_particles)))
    key = launch_key(kmodel.cuda_instance, layout)
    with profiling.span("lw_megakernel.launch", key=key):
        bounds = kmodel.prior_bounds
        if bounds is None or len(bounds) != kmodel.num_params:
            raise ValueError(f"model {kmodel.name!r}: the CUDA instance "
                             "needs one (lo, hi) prior bound per parameter")
        f, n, t_len = int(num_filters), int(num_particles), ys.shape[0]
        dev = ys.device
        n_fns = len(kmodel.functionals or ())
        lcl = torch.empty((f, t_len), dtype=torch.float32, device=dev)
        fpaths = torch.empty((n_fns, f, t_len), dtype=torch.float32,
                             device=dev)
        cloud = torch.empty((f, kmodel.tile_rows, n), dtype=torch.float32,
                            device=dev)
        lo, scale = _prior_box(bounds)
        run = (int(variant == "apf"), int(resample_every),
               float(ess_threshold) * n if ess_threshold > 0.0 else 0.0)
        host = (_host_floats(_coefficients(delta), 3),
                _host_floats(lo, _MAX_PARAMS),
                _host_floats(scale, _MAX_PARAMS),
                _host_floats(kmodel.cuda_args, _MAX_MODEL_ARGS))
        outs = (lcl.data_ptr(), fpaths.data_ptr() if n_fns else None,
                cloud.data_ptr())
        zs_ptr = None if zs is None else zs.data_ptr()
        args = (model_id, seed.data_ptr(), ys.data_ptr(), zs_ptr, f, t_len, n,
                *run, RESAMPLER_CODES[resampler], int(metropolis_iters),
                2 if layout == "paired" else 1, *host, *outs)
        if spans is None:
            _cuda.launch("ssme_lw_megakernel", *args, device=dev, key=key)
        else:
            _cuda.launch("ssme_lw_megakernel_spans", *args, spans.data_ptr(),
                         device=dev, key=key)
        return _result(lcl, fpaths, cloud, n_fns)

# the barriers a step crosses, as the source note states them
# (csrc/lw_megakernel_sys.cuh), in both families (a roll selection's
# votes and tail barriers apart): at t = 0 and at t > 0, in a step that
# resamples and in one that does not; step_spans counts them on the card
BARRIERS_PER_STEP = {
    "apf": {"first_resample": 3, "first_other": 2, "resample": 8,
            "other": 7},
    "sisr": {"first_resample": 3, "first_other": 2, "resample": 5,
             "other": 4}}
# the wide row's (more than REG_PARAMS parameters): the moments take 3
# (the cloud published, the pass's partial tiles, the fold) where the
# registers' exchanges take 2, theta's
# gathers one each (the ancestors read before it, the own slots written
# after it: the kernel draws and the joint resample), and SISR one more to
# publish the factor
WIDE_BARRIERS_PER_STEP = {
    "apf": {"first_resample": 4, "first_other": 2, "resample": 11,
            "other": 9},
    "sisr": {"first_resample": 4, "first_other": 2, "resample": 9,
             "other": 7}}


def barriers_per_step(kmodel, variant):
    """The barriers a step of each kind crosses in ``kmodel``'s systematic
    instance (the source note's counts)."""
    table = (WIDE_BARRIERS_PER_STEP if kmodel.num_params > REG_PARAMS
             else BARRIERS_PER_STEP)
    return table[variant]
# the parts of a step its clock64 spans time (the wide row's fold of the
# moments apart, 0 in the other rows; the paired layout's waits on its
# ring apart), then the rest of the instrumented twins' record per filter
# (csrc/lw_megakernel_sys.cuh LWSpan)
SPAN_PARTS = ("moments", "moments_fold", "cholesky", "first_stage", "draws",
              "weigh", "resample", "ring_wait")
SPAN_RECORD = SPAN_PARTS + ("first_resamples", "resamples",
                            "barriers_first_resample",
                            "barriers_first_other", "barriers_resample",
                            "barriers_other", "votes", "tail_barriers",
                            "sweeps", "tail_slots", "fixups", "most_marks",
                            "kper", "threads", "cluster")


def step_spans(seed, ys, zs, num_filters=8, num_particles=512, delta=0.99,
               resample_every=1, variant="apf", ess_threshold=0.0,
               kmodel=None, resampler="systematic", metropolis_iters=16):
    """Where a step's time goes on the card, and what it does: one launch
    of the instrumented twin of ``kmodel``'s instance (default:
    svol_leverage_lw) in the resampler's family, recorded by thread 0 of
    each filter.  Returns {"cycles_per_step": {part: mean clock64 cycles
    a step} over SPAN_PARTS (the barriers' waits inside the part that
    ends in them; a roll selection counts in its part; "ring_wait" the
    paired layout's waits for its draws, 0 in the single one),
    "resamples": mean resamples a filter at t > 0, "first_resamples": the
    share of filters that resampled at t = 0, "barriers_per_step":
    {"first_resample", "first_other", "resample", "other": barriers a
    step of that kind crossed besides a roll selection's, mean over the
    filters' steps of that kind, or None where there was none}, "votes",
    "tail_barriers", "sweeps", "tail_slots": the roll selections' totals
    over the filters (0 under systematic selection), "fixups": the
    systematic selections' counts whose first guess missed (both a step's
    selections), summed over the filters, "most_marks": the most marks one
    thread wrote in a selection, over the filters (0 under a roll
    resampler), "kper", "threads",
    "cluster": the layout the launch ran (CTAs a filter: 2 paired, 1
    single), "outputs": the result dict, the plain instance's bits}."""
    kmodel = svol_leverage_lw_kernel_model() if kmodel is None else kmodel
    seed, ys, zs = _validate(kmodel, seed, ys, zs, num_filters,
                             num_particles, resample_every, variant,
                             ess_threshold, resampler, metropolis_iters)
    if ys.device.type != "cuda":
        raise ValueError("step_spans: the record is the card's")
    f, t_len = int(num_filters), ys.shape[0]
    spans = torch.zeros((f, len(SPAN_RECORD)), dtype=torch.int64,
                        device=ys.device)
    out = _launch(kmodel, seed, ys, zs, f, num_particles, delta,
                  resample_every, variant, ess_threshold, resampler,
                  metropolis_iters, spans=spans)
    rec = dict(zip(SPAN_RECORD, spans.double().sum(0).tolist()))
    layout = spans[:, SPAN_RECORD.index("kper"):]
    if not bool((layout == layout[:1]).all()):
        raise RuntimeError("step_spans: filters report different layouts")
    steps = {"first_resample": rec["first_resamples"],
             "first_other": f - rec["first_resamples"],
             "resample": rec["resamples"],
             "other": f * (t_len - 1) - rec["resamples"]}
    return {"cycles_per_step": {k: rec[k] / (f * t_len) for k in SPAN_PARTS},
            "resamples": rec["resamples"] / f,
            "first_resamples": rec["first_resamples"] / f,
            "barriers_per_step": {k: rec[f"barriers_{k}"] / v if v else None
                                  for k, v in steps.items()},
            **{k: rec[k] for k in ("votes", "tail_barriers", "sweeps",
                                   "tail_slots", "fixups")},
            "most_marks": int(spans[:, SPAN_RECORD.index("most_marks")].max()),
            "kper": int(layout[0, 0]), "threads": int(layout[0, 1]),
            "cluster": int(layout[0, 2]), "outputs": out}


def lw_cloud_params(kmodel: LWKernelModel, cloud):
    """(F, S + 1 + P, N) kernel cloud -> (F, N, P) constrained parameter
    particles.  Plain means are valid right after a resample (uniform
    weights); combine with :func:`lw_cloud_weights` otherwise."""
    th0 = kmodel.num_state + 1
    th = cloud[:, th0:th0 + kmodel.num_params, :]
    return torch.stack([_to_constrained(c, th[:, i])
                        for i, c in enumerate(kmodel.transform_codes)],
                       dim=-1)


def lw_cloud_weights(kmodel: LWKernelModel, cloud):
    """(F, S + 1 + P, N) -> (F, N) normalised particle weights."""
    lw = cloud[:, kmodel.num_state, :]
    w = torch.exp(lw - torch.amax(lw, dim=-1, keepdim=True))
    return w / w.sum(-1, keepdim=True)


def lw_cloud_states(kmodel: LWKernelModel, cloud):
    """(F, S + 1 + P, N) -> (F, S, N) state particle rows."""
    return cloud[:, :kmodel.num_state, :]


def lw_kernel_sim_future_obs(kmodel: LWKernelModel, model, cloud, gen,
                             num_steps: int, delta: float = 0.99,
                             variant: str = "apf", last_obs=None):
    """Future simulation from a kernel run's final cloud, on the host
    side: decodes the cloud and continues with
    :meth:`ssme_tpu_torch.filters.LiuWestFilter.sim_future_obs` of
    ``model`` (the matching state-space model, supplying ``sample_f``,
    ``sample_g`` and the transforms).  ``last_obs`` is required for a
    covariate model.  The cloud's carried weights are ignored, as the
    reference simulators continue from the raw particle set: under
    every-step resampling the final cloud is uniform.

    Returns (F, num_steps, N, dim_obs).
    """
    from ssme_tpu_torch.filters.liu_west import LiuWestFilter

    n = cloud.shape[-1]
    states = lw_cloud_states(kmodel, cloud).transpose(1, 2)       # (F, N, S)
    th0 = kmodel.num_state + 1
    trans = cloud[:, th0:th0 + kmodel.num_params, :].transpose(1, 2)
    filt = LiuWestFilter(model, num_particles=n, delta=delta,
                         variant=variant)
    return filt.sim_future_obs(gen, states.contiguous(), trans.contiguous(),
                               num_steps, last_obs=last_obs)


# ---------------------------------------------------------------------------
# Built-in Liu-West kernel models, memoised as in JAX
# ---------------------------------------------------------------------------

def _prior_box(prior_bounds):
    """float32 (lo, hi - lo) of a box, as the kernel and the hook use."""
    lo = [float(torch.tensor(b[0], dtype=torch.float32))
          for b in prior_bounds]
    scale = [float(torch.tensor(b[1], dtype=torch.float32)
                   - torch.tensor(b[0], dtype=torch.float32))
             for b in prior_bounds]
    return lo, scale


def _uniform_box_prior(prior_bounds):
    """``sample_prior(rng, shape)`` drawing each parameter from an
    independent uniform box: lo + (hi - lo) u with the kernel's prior
    uniforms."""
    lo, scale = _prior_box(prior_bounds)

    def sample_prior(rng, shape):
        u = rng.uniform((len(lo),) + tuple(shape))
        return torch.stack([lo[i] + scale[i] * u[i] for i in range(len(lo))])

    return sample_prior


@functools.lru_cache(maxsize=None)
def svol_leverage_lw_kernel_model(prior_bounds=None) -> LWKernelModel:
    """SVOL with leverage as an LW kernel model: parameters (phi, mu,
    sigma, rho), transforms {logit, null, log, twice_fisher}, covariate z
    = the lagged observation; the transition mean clamped to +-40 as in
    the model.  CUDA instance ``SvolLeverageLW``."""
    from ssme_tpu_torch.models.svol_leverage import (DEFAULT_PRIOR_BOUNDS,
                                                     STATE_CLAMP)
    if prior_bounds is None:
        prior_bounds = DEFAULT_PRIOR_BOUNDS

    def mean(cp, x, z):
        phi, mu, sig, rho = cp[0], cp[1], cp[2], cp[3]
        return torch.clamp(mu + phi * (x - mu)
                           + z[0] * rho * sig * torch.exp(-0.5 * x),
                           -STATE_CLAMP, STATE_CLAMP)

    def init(rng, cp, y, shape):
        phi, sig = cp[0], cp[2]
        sd0 = sig / torch.sqrt(1.0 - phi * phi)
        return (rng.normal(shape) * sd0,)

    def propagate(rng, cp, state, y, z):
        (x,) = state
        sd = cp[2] * torch.sqrt(1.0 - cp[3] * cp[3])
        return (mean(cp, x, z) + sd * rng.normal(x.shape),)

    def prop_mu(cp, state, y, z):
        return (mean(cp, state[0], z),)

    def log_weight(cp, state, y, z):
        # y ~ N(0, e^{x/2}), parameter-free
        (x,) = state
        zz = y[0] / torch.exp(0.5 * x)
        return -_prng.HALF_LOG_2PI - 0.5 * x - 0.5 * zz * zz

    return LWKernelModel(
        num_params=4,
        transform_codes=("logit", "null", "log", "twice_fisher"),
        sample_prior=_uniform_box_prior(prior_bounds),
        init=init, propagate=propagate, log_weight=log_weight,
        prop_mu=prop_mu, dim_cov=1, name="svol_leverage_lw",
        cuda_instance="svol_leverage_lw", prior_bounds=tuple(prior_bounds))


@functools.lru_cache(maxsize=None)
def svol_leverage_lw_q_kernel_model(kappa: float = 1.5,
                                    prior_bounds=None) -> LWKernelModel:
    """SVOL with leverage with a SISR proposal of its own: the transition
    widened by ``kappa``, x' ~ N(mean_f, (kappa sd)^2) with sd = sigma
    sqrt(1 - rho^2), and ``log_fq`` = log f - log q of the two normal
    densities (the evidence stays unbiased).  No JAX instance sets
    ``sample_q`` / ``log_fq``; this one is the test vehicle of the
    kernel's path for them, the same hooks run by the plain version and by
    JAX's ``lw_megakernel``.  At kappa = 1 it is the leverage model's SISR
    path bit for bit.  CUDA instance ``SvolLeverageQLW``, which takes
    kappa as a call-time argument; APF ignores the proposal, as in JAX."""
    base = svol_leverage_lw_kernel_model(prior_bounds)
    kappa = float(kappa)
    if not kappa > 0.0:
        raise ValueError(f"kappa must be positive, got {kappa}")

    def mean_sd(cp, state, y, z):
        """The transition's mean (the lookahead) and sd."""
        return (base.prop_mu(cp, state, y, z)[0],
                cp[2] * torch.sqrt(1.0 - cp[3] * cp[3]))

    def sample_q(rng, cp, state, y, z):
        m, sd = mean_sd(cp, state, y, z)
        return (m + (kappa * sd) * rng.normal(state[0].shape),)

    def log_fq(cp, new_state, state, y, z):
        m, sd = mean_sd(cp, state, y, z)
        d = new_state[0] - m
        sq = kappa * sd
        ef, eq = d / sd, d / sq
        return (-torch.log(sd) - 0.5 * ef * ef) - (-torch.log(sq)
                                                   - 0.5 * eq * eq)

    return dataclasses.replace(
        base, sample_q=sample_q, log_fq=log_fq, name="svol_leverage_lw_q",
        cuda_instance="svol_leverage_lw_q", cuda_args=(kappa,))


@functools.lru_cache(maxsize=None)
def svol_t_lw_kernel_model(
        nu: float = 5.0,
        prior_bounds=((0.5, 2.0), (0.6, 0.99), (0.05, 1.0)),
) -> LWKernelModel:
    """Student-t observation SVOL: joint estimation of (beta, phi, sigma)
    at a fixed dof ``nu``, transforms {log, twice_fisher, log}, the
    filtered mean log-volatility as its functional.  The t constant c_nu
    is computed in double on the host.  CUDA instance ``SvolTLW``, which
    takes (c_nu, nu, (nu + 1) / 2) as call-time arguments."""
    nu = float(nu)
    c_nu = (math.lgamma(0.5 * (nu + 1.0)) - math.lgamma(0.5 * nu)
            - 0.5 * math.log(nu * math.pi))
    half_nu1 = 0.5 * (nu + 1.0)

    def init(rng, cp, y, shape):
        phi, sig = cp[1], cp[2]
        return (rng.normal(shape) * (sig / torch.sqrt(1.0 - phi * phi)),)

    def propagate(rng, cp, state, y, z):
        (x,) = state
        return (cp[1] * x + cp[2] * rng.normal(x.shape),)

    def prop_mu(cp, state, y, z):
        return (cp[1] * state[0],)

    def log_weight(cp, state, y, z):
        beta = cp[0]
        (x,) = state
        zval = (y[0] / beta) * torch.exp(-0.5 * x)
        return (c_nu - torch.log(beta) - 0.5 * x
                - half_nu1 * torch.log1p(zval * zval / nu))

    return LWKernelModel(
        num_params=3,
        transform_codes=("log", "twice_fisher", "log"),
        sample_prior=_uniform_box_prior(prior_bounds),
        init=init, propagate=propagate, log_weight=log_weight,
        prop_mu=prop_mu,
        functionals=(lambda cp, state: state[0],),
        name="svol_t_lw", cuda_instance="svol_t_lw",
        prior_bounds=tuple(prior_bounds), cuda_args=(c_nu, nu, half_nu1))


# the uniform prior box of factor_svol_lw_kernel_model, in the parameter
# order [phi (2), mu (2), sigma (2), vec(L) (5 x 2, row-major), d (5)]: it
# holds the generating point of benchmark/data/factor_svol_5_returns.csv
# and picks one of the likelihood's sign and swap modes (column 1
# positive, l52 positive)
FACTOR_SVOL_5_PRIOR_BOUNDS = (
    (0.80, 0.995), (0.80, 0.995), (-3.0, 1.0), (-3.0, 1.0),
    (0.05, 0.5), (0.05, 0.5),
    (0.1, 1.5), (-1.0, 1.0), (0.1, 1.5), (-1.0, 1.0), (0.1, 1.5),
    (-1.0, 1.0), (0.1, 1.5), (-1.0, 1.0), (0.1, 1.5), (0.1, 1.0),
    (0.05, 1.0), (0.05, 1.0), (0.05, 1.0), (0.05, 1.0), (0.05, 1.0))


@functools.lru_cache(maxsize=None)
def factor_svol_lw_kernel_model(n_assets: int = 5,
                                prior_bounds=None) -> LWKernelModel:
    """Two-factor SVOL (``models/factor_svol.py``, k = 2) learned online:
    each particle carries its 6 + 3 n parameters [phi (2), mu (2), sigma
    (2), vec(L) (2 n, row-major), d (n)] under the model's transforms
    (twice_fisher x 2, null x 2, log x 2, null x 2n, log x n), the state is
    the two factors' log-volatilities, the observation n columns.  The
    density is the explicit 2 x 2 Woodbury of K2's factor hook
    (``models/factor_svol.py::two_factor_log_g``), on each particle's own
    parameters; the lookahead is the transition's mean mu + phi (x - mu);
    the functionals are the two factors' filtered log-volatilities.  The
    state and the lookahead are clamped to +-40 (the leverage model's
    STATE_CLAMP): Liu-West moves sigma and mu freely, and a factor the data
    hardly identify can walk to where e^-x overflows float32 (x = -83 at
    sigma 7 in 313 steps, F=64 N=1024 on the card); past 40 no density
    changes in float32.  The
    prior is a uniform box (default :data:`FACTOR_SVOL_5_PRIOR_BOUNDS` at
    n = 5).  CUDA instance ``FactorSvolLW`` (``factor_svol_5_lw``) at n = 5,
    the count the kernel compiles; another count runs on CPU tensors
    only."""
    from ssme_tpu_torch.models.factor_svol import (transforms,
                                                   two_factor_log_g)
    from ssme_tpu_torch.models.svol_leverage import STATE_CLAMP
    na = int(n_assets)
    num_params = 6 + 3 * na
    if prior_bounds is None:
        if na != 5:
            raise ValueError("factor_svol_lw_kernel_model: give prior_bounds "
                             f"for n_assets={na} (the default box is 5's)")
        prior_bounds = FACTOR_SVOL_5_PRIOR_BOUNDS
    if len(prior_bounds) != num_params:
        raise ValueError(f"prior_bounds needs {num_params} (lo, hi) pairs")

    def mean(cp, x, j):
        return cp[2 + j] + cp[j] * (x - cp[2 + j])

    def clamp(v):
        return torch.clamp(v, -STATE_CLAMP, STATE_CLAMP)

    def init(rng, cp, y, shape):
        return tuple(cp[2 + j] + rng.normal(shape)
                     * (cp[4 + j] / torch.sqrt(1.0 - cp[j] * cp[j]))
                     for j in range(2))

    def propagate(rng, cp, state, y, z):
        means = [mean(cp, state[j], j) for j in range(2)]
        return tuple(clamp(means[j] + cp[4 + j] * rng.normal(state[j].shape))
                     for j in range(2))

    def prop_mu(cp, state, y, z):
        return tuple(clamp(mean(cp, state[j], j)) for j in range(2))

    def log_weight(cp, state, y, z):
        ell = [(cp[6 + 2 * i], cp[7 + 2 * i]) for i in range(na)]
        d = [cp[6 + 2 * na + i] for i in range(na)]
        return two_factor_log_g(ell, d, state[0], state[1], y)

    return LWKernelModel(
        num_params=num_params, transform_codes=transforms(na, 2),
        sample_prior=_uniform_box_prior(prior_bounds),
        init=init, propagate=propagate, log_weight=log_weight,
        prop_mu=prop_mu,
        functionals=(lambda cp, state: state[0],
                     lambda cp, state: state[1]),
        num_state=2, dim_obs=na, name=f"factor_svol_{na}x2_lw",
        cuda_instance="factor_svol_5_lw" if na == 5 else None,
        prior_bounds=tuple(tuple(b) for b in prior_bounds))


__all__ = ["LWKernelModel", "lw_megakernel", "lw_megakernel_reference",
           "lw_cloud_params", "lw_cloud_weights", "lw_cloud_states",
           "lw_kernel_sim_future_obs", "step_spans", "BARRIERS_PER_STEP",
           "LAYOUTS", "layout_for", "launch_key", "barriers_per_step",
           "wide_row_bytes", "wide_moments",
           "WIDE_BARRIERS_PER_STEP", "REG_PARAMS",
           "factor_svol_lw_kernel_model", "FACTOR_SVOL_5_PRIOR_BOUNDS",
           "SPAN_PARTS", "SPAN_RECORD", "svol_leverage_lw_kernel_model",
           "svol_leverage_lw_q_kernel_model", "svol_t_lw_kernel_model",
           "CUDA_LW_MODEL_IDS", "MAX_LW_KERNEL_PARTICLES",
           "MAX_LW_METROPOLIS_PARTICLES"]
