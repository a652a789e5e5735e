"""Generic whole-sequence filter bank over model hooks: the CUDA template
kernel and its plain PyTorch version.

Replaces ``ssme_tpu/ops/filter_megakernel.py::filter_megakernel``.  A
:class:`KernelModel` supplies, over (B, N) particle blocks,

- ``init(rng, p, y, z, shape) -> state``        the time-1 draw
- ``propagate(rng, p, state, y, z) -> state``   the transition draw
- ``log_weight(p, state, y, z) -> (B, N)``      the observation density
- optional ``prop_mu(p, state, y, z) -> state`` the auxiliary-PF lookahead
  (required by ``mode="apf"``)
- optional ``functional(p, state) -> (B, N)``   whose filtered mean is
  emitted per step (default: the first state leaf), or a vector
  ``functionals`` of them, one output path each

with ``p`` the (B, num_params) constrained parameter rows, ``y``/``z``
tuples of the step's observation and covariate scalars, ``state`` a
tuple of ``num_state`` (B, N) leaves (resampled together) and
``rng.normal(shape)`` the kernel's Philox normals of the current step
(``ops/_prng.py``: draw 0 on the first call of a hook, draw 1 on the
second, ...).

The kernel is one template over the model functors of
``csrc/kernel_models.cuh`` and the selection family, entered through
``csrc/filter_megakernel.cu``: ``csrc/filter_megakernel_sys.cuh`` (kPer
neighbouring particles per thread, paired draws, the block primitives of
``csrc/row_select.cuh``; the roll resamplers of ``csrc/roll_select.cuh``
in the same layout); ``csrc/filter_megakernel.cuh``'s header comment
gives the step recursion of both modes and the intended divergences from
the Pallas kernel.  A hook written in Python cannot be compiled into
it: on a CUDA tensor only a model whose ``cuda_instance`` names a functor
there runs, with that functor's single functional, and any other model,
or one with vector ``functionals``, raises.  On a CPU tensor every model
runs through :func:`filter_megakernel_reference`, which calls the hooks
step by step with the kernel's random bits.

Selection (``resampler``): "systematic", N a multiple of 32 in [32, 1024]
(the JAX package's ``MAX_KERNEL_PARTICLES``), or
the roll-based "metropolis" and "rejection" resamplers
(``ops/_select.py``), N a power of two in [32, 4096] (as JAX's
``MAX_METROPOLIS_PARTICLES``; 8 and 16 particles per thread at 2048 and
4096).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Callable

import torch

from ssme_tpu_torch import profiling
from ssme_tpu_torch.filters.bootstrap import replicated_log_like_fn
from ssme_tpu_torch.models.svol import kernel_rows
from ssme_tpu_torch.models.svol_leverage import STATE_CLAMP
from ssme_tpu_torch.ops import _cuda, _prng
from ssme_tpu_torch.ops._select import (MAX_PARTICLES, MAX_ROLL_PARTICLES,
                                        RESAMPLER_CODES, as_rows,
                                        check_particles, check_resampler,
                                        metropolis_bias_estimate,
                                        metropolis_sweeps_for,
                                        plain_ancestor_fn, resample_rows)
from ssme_tpu_torch.utils import logmeanexp

# the profiling span opened here: each launch of ``filter_megakernel``,
# from the model's id to the launch count, keyed by the CUDA instance
HOST_SPANS = ("filter_megakernel.launch",)

# the dispatch table of csrc/kernel_models.cuh (same names, same numbers;
# tests/test_torch_megakernel.py parses the header and compares)
CUDA_MODEL_IDS = {"svol": 0, "svol_leverage": 1, "svol_t": 2,
                  "poisson_ar": 3, "factor_svol_3": 4, "factor_svol_4": 5,
                  "factor_svol_5": 6}
# the asset counts the factor-SVOL functor is compiled for
FACTOR_ASSET_COUNTS = tuple(sorted(
    int(name.rsplit("_", 1)[1]) for name in CUDA_MODEL_IDS
    if name.startswith("factor_svol_")))


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
    # one per-step filtered-mean path per entry; overrides ``functional``
    functionals: tuple = None
    prop_mu: Callable = None      # APF lookahead; required for mode="apf"
    name: str = "kernel_model"
    cuda_instance: str = None

    @property
    def functional_list(self):
        if self.functionals is not None:
            return tuple(self.functionals)
        return (self.functional or (lambda p, state: state[0]),)


def _validate(kmodel, seed, params, ys, zs, num_particles, ess_threshold,
              gate_stride, mode, resampler, metropolis_iters=16):
    if mode not in ("bootstrap", "apf"):
        raise ValueError(f"mode must be 'bootstrap' or 'apf', got {mode!r}")
    if mode == "apf" and kmodel.prop_mu is None:
        raise ValueError(f"model {kmodel.name!r} has no prop_mu hook "
                         "(required for the auxiliary-PF mode)")
    check_resampler(resampler, metropolis_iters)
    if not isinstance(params, torch.Tensor) or params.ndim != 2 \
            or params.shape[1] != kmodel.num_params or params.shape[0] < 1:
        raise ValueError(f"params must be a (B, {kmodel.num_params}) tensor "
                         f"of model {kmodel.name!r} rows")
    if params.dtype != torch.float32 or not params.is_contiguous():
        raise ValueError("params must be contiguous float32")
    dev = params.device
    ys = as_rows("ys", ys, None, kmodel.dim_obs, dev)
    if kmodel.dim_cov:
        if zs is None:
            raise ValueError(f"model {kmodel.name!r} needs covariates zs")
        zs = as_rows("zs", zs, ys.shape[0], kmodel.dim_cov, dev)
    elif zs is not None:
        raise ValueError(f"model {kmodel.name!r} has dim_cov=0 but "
                         "covariates zs were supplied")
    seed = _prng.seed_words(seed, device=dev)
    if seed.device != dev:
        raise ValueError(f"seed is on {seed.device}, params on {dev}")
    check_particles(int(num_particles), resampler)
    if int(gate_stride) != gate_stride or gate_stride < 1:
        raise ValueError("gate_stride must be a positive integer")
    if gate_stride > 1 and (mode != "bootstrap" or ess_threshold >= 1.0):
        raise ValueError(
            "gate_stride > 1 accumulates weights between ESS checks: it "
            "applies to the ESS-adaptive bootstrap mode only (APF selects "
            "every step; the every-step schedule, ess_threshold >= 1, "
            "requires gate_stride=1)")
    return seed, ys, zs


def filter_megakernel_reference(kmodel, seed, params, ys, zs=None,
                                num_particles=512, ess_threshold=1.0,
                                gate_stride=1, return_cloud=False,
                                mode="bootstrap", resampler="systematic",
                                metropolis_iters=16):
    """Plain PyTorch version of :func:`filter_megakernel`, callable on
    either device and with any :class:`KernelModel`; consumes the
    kernel's Philox bits step by step.

    The APF mode is JAX's ``apf_step``: first-stage weights lw +
    log g(lookahead), a systematic selection of (state, lookahead) on
    them with the step's resampling offset (tag 1, which the bootstrap
    resample would use), the lookahead density re-evaluated at the
    selected points, the transition, second-stage weights log g(x') -
    log g(lookahead), and lcl = [LSE(fsw) - LSE(lw)] + [LSE(w') - log N].
    Under a roll resampler the first stage selects on the first-stage
    sweep tags (``_prng.TAG_ROLL_SELECT``), the resample on
    ``TAG_ROLL_SWEEP``, and only the firing rows run the sweep loop.
    """
    seed, ys, zs = _validate(kmodel, seed, params, ys, zs, num_particles,
                             ess_threshold, gate_stride, mode, resampler,
                             metropolis_iters)
    roll = resampler != "systematic"
    n, g = int(num_particles), int(gate_stride)
    b, t_len = params.shape[0], ys.shape[0]
    dev = params.device
    log_n = math.log(float(n))
    apf = mode == "apf"
    always = ess_threshold >= 1.0
    ess_limit = float(ess_threshold) * n
    fns = kmodel.functional_list
    rows = torch.arange(b, device=dev)
    rng = _prng.StepBlocks(seed, rows, n, t_len)

    def ancestors(t, tag=_prng.TAG_ROLL_SWEEP):
        return plain_ancestor_fn(resampler, metropolis_iters, seed, rows, t,
                                 n, None if roll else rng.offsets(t), tag)

    lcl = torch.zeros((b, t_len), dtype=torch.float32, device=dev)
    fpaths = torch.zeros((len(fns), b, t_len), dtype=torch.float32,
                         device=dev)
    carry = torch.full((b, 1), log_n, dtype=torch.float32, device=dev)
    s_last = s2_last = torch.ones_like(carry)

    def weigh(t, state, lw):
        """Max, normalised weights and their sums; writes the means."""
        m = torch.amax(lw, dim=-1, keepdim=True)
        wn = torch.exp(lw - m)
        s = wn.sum(-1, keepdim=True)
        for k, fn in enumerate(fns):
            fpaths[k, :, t] = ((fn(params, state) * wn).sum(-1, keepdim=True)
                               / s)[:, 0]
        return m, wn, s, (wn * wn).sum(-1, keepdim=True)

    for t in range(t_len):
        y = tuple(ys[t].unbind())
        z = () if zs is None else tuple(zs[t].unbind())
        if apf and t > 0:
            look = tuple(kmodel.prop_mu(params, state, y, z))
            fsw = lw + kmodel.log_weight(params, look, y, z)
            m_fs = torch.amax(fsw, dim=-1, keepdim=True)
            w_fs = torch.exp(fsw - m_fs)
            lse_fs = m_fs + torch.log(w_fs.sum(-1, keepdim=True))
            anc = ancestors(t, _prng.TAG_ROLL_SELECT)(w_fs, None)
            picked = tuple(torch.gather(v, 1, anc) for v in state + look)
            lg_look = kmodel.log_weight(params, picked[kmodel.num_state:], y,
                                        z)
            state = tuple(kmodel.propagate(
                rng.at(t), params, picked[:kmodel.num_state], y, z))
            lw = kmodel.log_weight(params, state, y, z) - lg_look
            m, wn, s, s2 = weigh(t, state, lw)
            lcl[:, t] = (((lse_fs - carry) + (m + torch.log(s)))
                         - log_n)[:, 0]
        else:
            if t == 0:
                state = tuple(kmodel.init(rng.at(0), params, y, z, (b, n)))
                lw = torch.zeros((b, n), dtype=torch.float32, device=dev)
                wn = torch.ones_like(lw)
            else:
                if g == 1:
                    fire = True if always else s_last * s_last / s2_last < \
                        ess_limit
                    state, lw, carry = resample_rows(
                        ancestors(t), wn, state, lw, carry, fire, log_n, roll)
                state = tuple(kmodel.propagate(rng.at(t), params, state, y,
                                               z))
            lw = lw + kmodel.log_weight(params, state, y, z)
            if not (g == 1 or t % g == g - 1 or t == t_len - 1):
                continue
            m, wn, s, s2 = weigh(t, state, lw)
            lcl[:, t] = ((m + torch.log(s)) - carry)[:, 0]
        lw = lw - m
        carry = torch.log(s)
        s_last, s2_last = s, s2
        if g > 1:
            state, lw, carry = resample_rows(ancestors(t), wn, state, lw,
                                             carry, s * s / s2 < ess_limit,
                                             log_n, roll)
    fmean = fpaths[0] if len(fns) == 1 else tuple(fpaths.unbind(0))
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
    if kmodel.functionals is not None:
        raise ValueError(
            f"model {kmodel.name!r}: vector functionals run on CUDA tensors "
            "only as a functor's own, and the functors of "
            "csrc/kernel_models.cuh have one each; a model with "
            "functionals runs on CPU tensors (ROADMAP.md section 3, D1)")
    try:
        return CUDA_MODEL_IDS[kmodel.cuda_instance]
    except KeyError:
        raise ValueError(
            f"unknown CUDA instance {kmodel.cuda_instance!r}; valid: "
            f"{sorted(CUDA_MODEL_IDS)} (the factor-SVOL functor is compiled "
            f"for {', '.join(map(str, FACTOR_ASSET_COUNTS))} assets)"
        ) from None


def filter_megakernel(kmodel, seed, params, ys, zs=None, num_particles=512,
                      ess_threshold=1.0, gate_stride=1, return_cloud=False,
                      mode="bootstrap", resampler="systematic",
                      metropolis_iters=16):
    """B whole-sequence particle filters of ``kmodel`` in one launch.

    seed: (2,) int64 Philox key words on the params' device, or a Python
    int; params: (B, num_params) float32 constrained rows; ys: (T,) or
    (T, dim_obs); zs: (T,) or (T, dim_cov) covariates, required iff the
    model has them.  ``num_particles``: a multiple of 32 in [32, 1024]
    under ``resampler="systematic"``, a power of two in [32, 4096] under
    "metropolis" (``metropolis_iters`` sweeps per selection; biased at a
    finite count, ``_select.metropolis_bias_estimate``) or "rejection"
    (unbiased).
    Returns (total (B,), lcl (B, T), fmean): total = sum_t
    log p(y_t | y_{1:t-1}); fmean the (B, T) filtered mean of the model's
    functional, or a tuple of one (B, T) path per entry of a vector
    ``functionals``.  ``return_cloud`` appends (cloud, cloud_log_weights):
    a tuple of ``num_state`` (B, N) leaves after the last observation and
    the (B, N) max-normalised carried log-weights.

    mode: "bootstrap" (propagate through the transition, weight by the
    observation density) or "apf" (Pitt-Shephard auxiliary PF through
    the model's ``prop_mu``: a first-stage selection every step;
    ``ess_threshold`` is ignored and ``gate_stride`` must be 1).

    ess_threshold (bootstrap): resample when a row's ESS falls below this
    fraction of N (1.0 = every step).  gate_stride g > 1 (ESS-adaptive
    bootstrap only): weights accumulate between checks at t = g-1 (mod g)
    and t = T-1; lcl and fmean are zero off those columns and sum(lcl)
    stays the exact evidence.

    Launches the kernel for CUDA tensors (raising for a model without a
    CUDA instance, or with vector functionals) and runs
    :func:`filter_megakernel_reference` for CPU tensors.
    """
    seed, ys, zs = _validate(kmodel, seed, params, ys, zs, num_particles,
                             ess_threshold, gate_stride, mode, resampler,
                             metropolis_iters)
    if params.device.type == "cpu":
        return filter_megakernel_reference(
            kmodel, seed, params, ys, zs, num_particles, ess_threshold,
            gate_stride, return_cloud, mode, resampler, metropolis_iters)
    if params.device.type != "cuda":
        raise ValueError(f"filter_megakernel: unsupported device "
                         f"{params.device}")
    with profiling.span("filter_megakernel.launch",
                        key=kmodel.cuda_instance):
        model_id = _model_id(kmodel)
        b, t_len, n = params.shape[0], ys.shape[0], int(num_particles)
        dev = params.device
        total = torch.empty((b,), dtype=torch.float32, device=dev)
        lcl = torch.empty((b, t_len), dtype=torch.float32, device=dev)
        fmean = torch.empty_like(lcl)
        cloud = cloud_lw = None
        if return_cloud:
            cloud = torch.empty((kmodel.num_state, b, n),
                                dtype=torch.float32, device=dev)
            cloud_lw = torch.empty((b, n), dtype=torch.float32, device=dev)
        _cuda.launch(
            "ssme_filter_megakernel", model_id, int(mode == "apf"),
            seed.data_ptr(), params.data_ptr(), ys.data_ptr(),
            None if zs is None else zs.data_ptr(), b, t_len, n,
            float(ess_threshold) * n, int(ess_threshold >= 1.0),
            int(gate_stride), RESAMPLER_CODES[resampler],
            int(metropolis_iters), total.data_ptr(), lcl.data_ptr(),
            fmean.data_ptr(), None if cloud is None else cloud.data_ptr(),
            None if cloud_lw is None else cloud_lw.data_ptr(),
            device=dev, key=kmodel.cuda_instance)
        if return_cloud:
            return total, lcl, fmean, tuple(cloud.unbind(0)), cloud_lw
        return total, lcl, fmean


# the barriers a step crosses, as the source note states them
# (csrc/filter_megakernel_sys.cuh): under systematic selection a bootstrap
# step that resamples, a check that does not (and APF's t = 0), a step
# without a check, an APF step; under the roll resamplers every check
# crosses 2 and an APF step 4, plus the selection's votes and tail
# barriers (counted apart); step_spans counts them on the card
BARRIERS_PER_STEP = {"resample": 3, "check": 2, "other": 0, "apf": 5}
ROLL_BARRIERS_PER_STEP = {"resample": 2, "check": 2, "other": 0, "apf": 4}
# the parts of a step its clock64 spans time (roll: the selection counts
# as the walk), then the rest of the instrumented twins' record per row
# (csrc/filter_megakernel_sys.cuh SysSpan)
SPAN_PARTS = ("propagate", "max", "sums", "stage", "walk", "gather")
SPAN_RECORD = SPAN_PARTS + ("checks", "resamples", "apf_steps",
                            "barriers_resample", "barriers_check",
                            "barriers_other", "barriers_apf", "votes",
                            "tail_barriers", "sweeps", "tail_slots",
                            "fixups", "most_marks", "kper", "threads")
# the twins' (functor, mode) under each selection family
SPAN_TWINS = {"systematic": (("svol_leverage", "bootstrap"),
                             ("svol_leverage", "apf")),
              "roll": (("svol_leverage", "bootstrap"),
                       ("svol_leverage", "apf"), ("svol", "bootstrap"))}


def step_spans(seed, params, ys, zs, num_particles=512, ess_threshold=1.0,
               gate_stride=1, mode="bootstrap", resampler="systematic",
               metropolis_iters=16, kmodel=None):
    """Where a step's time goes on the card, and what it does: one launch
    of an instrumented twin (``SPAN_TWINS``; ``kmodel`` defaults to the
    svol_leverage model, rows (phi, mu, sigma, rho), covariates ``zs``),
    recorded by thread 0 of each row.  Returns {"cycles_per_step": {part:
    mean clock64 cycles a step} over SPAN_PARTS (the barriers' waits inside
    the part that ends in them; APF's first stage counts under the same
    parts), "checks", "resamples", "apf_steps": mean counts per row,
    "barriers_per_step": {"resample", "check", "other", "apf": barriers a
    step of that kind crossed, mean over the rows' steps of that kind, or
    None where there was none; under a roll resampler without the
    selections' votes and tail barriers}, "fixups": the systematic
    selections' counts whose first guess missed, summed over the rows,
    "most_marks": the most marks one thread wrote in a selection, over
    the rows (0 under a roll resampler), "kper", "threads": the layout the
    launch ran, "outputs": (total, lcl, fmean), the plain instance's bits}
    and, under a roll resampler, "votes", "tail_barriers", "tail_slots":
    their totals over the rows, "sweeps": (B, T) int32, the sweeps each
    selection ran at the step of its draws (1 + its last accept sweep,
    4096 at the cap; 0 where none), and "ratio": (B, T) float32, its
    largest weight over its mean weight, N / sum(w) (0 where none)."""
    kmodel = kmodel or svol_leverage_kernel_model()
    family = "systematic" if resampler == "systematic" else "roll"
    if (kmodel.cuda_instance, mode) not in SPAN_TWINS[family]:
        raise ValueError(f"no instrumented twin of {kmodel.cuda_instance!r} "
                         f"in {mode} mode under {resampler!r}; twins: "
                         f"{SPAN_TWINS[family]}")
    seed, ys, zs = _validate(kmodel, seed, params, ys, zs, num_particles,
                             ess_threshold, gate_stride, mode, resampler,
                             metropolis_iters)
    if params.device.type != "cuda":
        raise ValueError("step_spans: the record is the card's")
    b, t_len, n = params.shape[0], ys.shape[0], int(num_particles)
    dev = params.device
    total = torch.empty((b,), dtype=torch.float32, device=dev)
    lcl = torch.empty((b, t_len), dtype=torch.float32, device=dev)
    fmean = torch.empty_like(lcl)
    spans = torch.zeros((b, len(SPAN_RECORD)), dtype=torch.int64, device=dev)
    sweeps = ratio = None
    if family == "roll":
        sweeps = torch.zeros((b, t_len), dtype=torch.int32, device=dev)
        ratio = torch.zeros((b, t_len), dtype=torch.float32, device=dev)
    _cuda.launch(
        "ssme_filter_megakernel_spans", CUDA_MODEL_IDS[kmodel.cuda_instance],
        int(mode == "apf"), seed.data_ptr(), params.data_ptr(),
        ys.data_ptr(), None if zs is None else zs.data_ptr(), b, t_len, n,
        float(ess_threshold) * n, int(ess_threshold >= 1.0),
        int(gate_stride), RESAMPLER_CODES[resampler], int(metropolis_iters),
        total.data_ptr(), lcl.data_ptr(), fmean.data_ptr(), spans.data_ptr(),
        None if sweeps is None else sweeps.data_ptr(),
        None if ratio is None else ratio.data_ptr(), device=dev,
        key=kmodel.cuda_instance)
    rec = dict(zip(SPAN_RECORD, spans.double().sum(0).tolist()))
    layout = spans[:, SPAN_RECORD.index("kper"):]
    if not bool((layout == layout[:1]).all()):
        raise RuntimeError("step_spans: rows report different layouts")
    steps = {"resample": rec["resamples"],
             "check": rec["checks"] - rec["resamples"] - rec["apf_steps"],
             "other": b * t_len - rec["checks"], "apf": rec["apf_steps"]}
    # the roll selections' votes and tail barriers fall in resample steps
    # (bootstrap) or APF steps
    sel = rec["votes"] + rec["tail_barriers"]
    bars = {k: rec[f"barriers_{k}"] for k in steps}
    bars["apf" if mode == "apf" else "resample"] -= sel
    out = {"cycles_per_step": {k: rec[k] / (b * t_len) for k in SPAN_PARTS},
           "checks": rec["checks"] / b, "resamples": rec["resamples"] / b,
           "apf_steps": rec["apf_steps"] / b,
           "barriers_per_step": {k: bars[k] / v if v else None
                                 for k, v in steps.items()},
           "fixups": rec["fixups"],
           "most_marks": int(spans[:, SPAN_RECORD.index("most_marks")].max()),
           "kper": int(layout[0, 0]), "threads": int(layout[0, 1]),
           "outputs": (total, lcl, fmean)}
    if sweeps is not None:
        out.update(votes=rec["votes"], tail_barriers=rec["tail_barriers"],
                   tail_slots=rec["tail_slots"], sweeps=sweeps, ratio=ratio)
    return out


def megakernel_log_like(kmodel, num_particles: int, num_replicates: int,
                        constrain=None, ess_threshold: float = 0.5, *,
                        gate_stride: int = 1, model=None,
                        resampler: str = "systematic",
                        metropolis_iters: int = None,
                        metropolis_bias_budget: float = 0.5):
    """PMMH ``batched_log_like`` hook for a kernel model: all chains x
    replicates in ONE launch.

    Returns ``ll(gen, params (C, P), ys, zs=None) -> (C,)``.  ``constrain``
    maps the PMMH's constrained parameters to kernel rows (e.g. ss ->
    sigma).  Rows are chain-major (row c*R + r is replicate r of chain c),
    reduced by a per-chain log-mean-exp.  The two seed words are drawn on
    the device with ``gen``, so the host never waits.  No padding rows:
    the ESS gate is per row.  Every parameter after ``ess_threshold`` is
    keyword-only: JAX's sixth positional parameter is ``model``, the
    port's order differs, so a positional call raises ``TypeError``.

    Cap: 1024 particles under ``resampler="systematic"``, 4096 under the
    roll resamplers.  Large-N bridge: above the cap, pass the matching
    ``StateSpaceModel`` as ``model`` and the hook is the generic bank
    ``filters.bootstrap.replicated_log_like_fn`` at the same particle
    count, replicates and ESS gate; it takes the PMMH's parameters as
    they are (``constrain``, ``gate_stride`` and the resampler are kernel
    plumbing and unused there).  Without ``model`` it raises.

    ``resampler="metropolis"`` biases the evidence at a finite sweep
    count, and the bias depends on theta, so it distorts the
    pseudo-marginal posterior itself.  As in JAX, ``metropolis_iters=None``
    takes the sweep count from ``_select.metropolis_sweeps_for`` so that
    the predicted bias stays within ``metropolis_bias_budget`` nats (it
    raises when no count within 256 does), and an explicit count whose
    predicted bias exceeds the budget warns.  "rejection" is unbiased.
    """
    r = num_replicates
    check_resampler(resampler)
    cap = MAX_PARTICLES if resampler == "systematic" else MAX_ROLL_PARTICLES
    if num_particles > cap:
        if model is None:
            raise ValueError(
                f"num_particles={num_particles} exceeds the kernel's cap "
                f"({cap} under resampler={resampler!r}); pass the matching "
                "StateSpaceModel as model= to run the generic filter bank "
                "instead (the large-N bridge), or take "
                "resampler='rejection' (unbiased, cap "
                f"{MAX_ROLL_PARTICLES})")
        return replicated_log_like_fn(
            model, num_particles, r,
            ess_threshold=None if ess_threshold >= 1.0
            else float(ess_threshold))

    def sweeps(t_len):
        if resampler != "metropolis":
            return 16 if metropolis_iters is None else metropolis_iters
        if metropolis_iters is None:
            return metropolis_sweeps_for(metropolis_bias_budget, t_len,
                                         ess_threshold)
        est = metropolis_bias_estimate(metropolis_iters, t_len, ess_threshold)
        if est > metropolis_bias_budget:
            need = metropolis_sweeps_for(metropolis_bias_budget, t_len,
                                         ess_threshold, max_sweeps=1 << 20)
            warnings.warn(
                f"metropolis_iters={metropolis_iters} predicts ~{est:.2f} "
                f"nats of theta-dependent evidence bias at T={t_len} (budget "
                f"{metropolis_bias_budget}); a biased evidence distorts the "
                f"pseudo-marginal posterior: use metropolis_iters={need}, "
                "resampler='rejection' (unbiased), or raise the budget "
                "deliberately", stacklevel=3)
        return metropolis_iters

    def ll(gen, params, ys, zs=None):
        c = params.shape[0]
        p = constrain(params) if constrain is not None else params
        rows = p[:, None].expand(c, r, p.shape[1]).reshape(
            c * r, p.shape[1]).contiguous()
        vals, _, _ = filter_megakernel(
            kmodel, _prng.draw_seed(gen, p.device), rows, ys, zs,
            num_particles=num_particles, ess_threshold=ess_threshold,
            gate_stride=gate_stride, resampler=resampler,
            metropolis_iters=int(sweeps(int(ys.shape[0]))))
        return logmeanexp(vals.reshape(c, r), dim=-1)

    return ll


def megakernel_swarm_evidence(kmodel, seed, param_draws, ys, zs=None,
                              num_particles: int = 512,
                              ess_threshold: float = 1.0,
                              return_cloud: bool = False,
                              gate_stride: int = 1,
                              resampler: str = "systematic",
                              metropolis_iters: int = 16):
    """Swarm conditional evidence for a kernel model: one filter per
    parameter draw (the kernel's row axis), per-step aggregation across
    models.

    Returns the JAX keys: ``log_cond_like`` (T,) = logmeanexp over models,
    ``mean_log_cond_like`` (T,) = the arithmetic mean of logs,
    ``per_model_log_cond_likes`` (M, T), ``functional_paths`` (one (T,)
    swarm-averaged path per functional of the model) and
    ``functional_path``, the first of them; with ``return_cloud`` also
    ``final_cloud`` (tuple of ``num_state`` (M, N)) and
    ``final_log_weights`` (M, N), the input of
    :func:`ssme_tpu_torch.inference.swarm.forecast_from_cloud`.  With
    ``gate_stride > 1`` the per-model lcls coarsen to per-check block
    sums (totals unchanged) and the functional paths are zero off the
    check columns.  ``resampler`` and ``metropolis_iters`` as in
    :func:`filter_megakernel`.
    """
    outs = filter_megakernel(kmodel, seed, param_draws.contiguous(), ys, zs,
                             num_particles=num_particles,
                             ess_threshold=ess_threshold,
                             return_cloud=return_cloud,
                             gate_stride=gate_stride, resampler=resampler,
                             metropolis_iters=metropolis_iters)
    _, lcls, fmeans = outs[:3]
    if not isinstance(fmeans, tuple):
        fmeans = (fmeans,)
    paths = tuple(f.mean(0) for f in fmeans)
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
    exactly the bits of the SVOL kernel (``csrc/svol_filter_sys.cu``)."""

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

    def prop_mu(p, state, y, z):
        # APF lookahead = the transition mean
        return (p[:, 1:2] * state[0],)

    return KernelModel(num_params=3, init=init, propagate=propagate,
                       log_weight=log_weight, prop_mu=prop_mu, name="svol",
                       cuda_instance="svol")


# constrained (beta, phi, ss) rows -> svol_kernel_model rows (beta, phi, sigma)
svol_kernel_rows = kernel_rows


def _leverage_mean(p, x, z):
    phi, mu, sigma, rho = p[:, 0:1], p[:, 1:2], p[:, 2:3], p[:, 3:4]
    return torch.clamp(mu + phi * (x - mu)
                       + z[0] * rho * sigma * torch.exp(-0.5 * x),
                       -STATE_CLAMP, STATE_CLAMP)


@functools.lru_cache(maxsize=None)
def svol_leverage_kernel_model() -> KernelModel:
    """SVOL with leverage (``models/svol_leverage.py``); rows (phi, mu,
    sigma, rho); covariate z = the lagged observation.  The transition
    mean is clamped to +-STATE_CLAMP, as in the model, in the transition
    and in the lookahead.  CUDA instance ``SvolLeverageModel``."""

    def init(rng, p, y, z, shape):
        phi, sigma = p[:, 0:1], p[:, 2:3]
        return (rng.normal(shape) * (sigma / torch.sqrt(1.0 - phi * phi)),)

    def propagate(rng, p, state, y, z):
        sigma, rho = p[:, 2:3], p[:, 3:4]
        (x,) = state
        sd = sigma * torch.sqrt(1.0 - rho * rho)
        return (_leverage_mean(p, x, z) + sd * rng.normal(x.shape),)

    def log_weight(p, state, y, z):
        (x,) = state
        zval = y[0] * torch.exp(-0.5 * x)
        return -_prng.HALF_LOG_2PI - 0.5 * x - 0.5 * zval * zval

    def prop_mu(p, state, y, z):
        return (_leverage_mean(p, state[0], z),)

    return KernelModel(num_params=4, init=init, propagate=propagate,
                       log_weight=log_weight, prop_mu=prop_mu, dim_cov=1,
                       name="svol_leverage", cuda_instance="svol_leverage")


@functools.lru_cache(maxsize=None)
def factor_svol_kernel_model(n_assets: int = 5) -> KernelModel:
    """Multivariate factor SVOL (``models/factor_svol.py``) with k = 2
    factors as a two-leaf kernel model: the state is (x1, x2), resampled
    together.  Rows: the model's constrained [phi (2), mu (2), sigma (2),
    vec(L) (2n, row-major), d (n)].

    The Woodbury density y ~ N(0, L diag(e^x) L' + diag(d)) becomes
    explicit 2 x 2 formulas per particle: M = diag(e^-x) + A with the
    per-row A = L' D^-1 L, v = L' D^-1 y and y' D^-1 y, so det and
    inverse are a handful of elementwise operations.  No ``prop_mu``, as
    in JAX.  CUDA instance ``FactorSvolModel<n_assets>`` for the counts of
    :data:`FACTOR_ASSET_COUNTS`; another count runs on CPU tensors only
    and raises on a CUDA tensor."""
    na = int(n_assets)
    num_params = 6 + 2 * na + na

    def unpack(p):
        phi = (p[:, 0:1], p[:, 1:2])
        mu = (p[:, 2:3], p[:, 3:4])
        sigma = (p[:, 4:5], p[:, 5:6])
        ell = [(p[:, 6 + 2 * i:7 + 2 * i], p[:, 7 + 2 * i:8 + 2 * i])
               for i in range(na)]
        d = [p[:, 6 + 2 * na + i:7 + 2 * na + i] for i in range(na)]
        return phi, mu, sigma, ell, d

    def init(rng, p, y, z, shape):
        phi, mu, sigma, _, _ = unpack(p)
        return tuple(mu[j] + rng.normal(shape)
                     * (sigma[j] / torch.sqrt(1.0 - phi[j] * phi[j]))
                     for j in range(2))

    def propagate(rng, p, state, y, z):
        phi, mu, sigma, _, _ = unpack(p)
        return tuple(mu[j] + phi[j] * (state[j] - mu[j])
                     + sigma[j] * rng.normal(state[j].shape)
                     for j in range(2))

    def log_weight(p, state, y, z):
        _, _, _, ell, d = unpack(p)
        x1, x2 = state
        a11 = a12 = a22 = v1 = v2 = yy = sum_log_d = 0.0
        for i in range(na):
            l1, l2 = ell[i]
            dinv = 1.0 / d[i]
            a11 = a11 + l1 * l1 * dinv
            a12 = a12 + l1 * l2 * dinv
            a22 = a22 + l2 * l2 * dinv
            v1 = v1 + l1 * dinv * y[i]
            v2 = v2 + l2 * dinv * y[i]
            yy = yy + y[i] * y[i] * dinv
            sum_log_d = sum_log_d + torch.log(d[i])
        m11 = torch.exp(-x1) + a11
        m22 = torch.exp(-x2) + a22
        det = m11 * m22 - a12 * a12
        quad_corr = (m22 * v1 * v1 - 2.0 * a12 * v1 * v2
                     + m11 * v2 * v2) / det
        logdet = torch.log(det) + x1 + x2 + sum_log_d
        return (-na * _prng.HALF_LOG_2PI - 0.5 * logdet
                - 0.5 * (yy - quad_corr))

    return KernelModel(num_params=num_params, init=init,
                       propagate=propagate, log_weight=log_weight,
                       num_state=2, dim_obs=na,
                       functional=lambda p, state: state[0],
                       name=f"factor_svol_{na}x2",
                       cuda_instance=f"factor_svol_{na}")


@functools.lru_cache(maxsize=None)
def poisson_ar_kernel_model() -> KernelModel:
    """Poisson AR(1) counts (``models/poisson_ar.py``); rows (phi, mu,
    sigma).  log(y!) = gammaln(y + 1) depends on the data only, so it
    comes in as a second observation column: ``ys`` rows
    ``[y, gammaln(y + 1)]`` (dim_obs = 2, :func:`poisson_obs_rows`).  CUDA
    instance ``PoissonArModel``."""

    def init(rng, p, y, z, shape):
        phi, mu, sigma = p[:, 0:1], p[:, 1:2], p[:, 2:3]
        return (mu + rng.normal(shape) * (sigma / torch.sqrt(1.0 - phi * phi)),)

    def propagate(rng, p, state, y, z):
        phi, mu, sigma = p[:, 0:1], p[:, 1:2], p[:, 2:3]
        (x,) = state
        return (mu + phi * (x - mu) + sigma * rng.normal(x.shape),)

    def prop_mu(p, state, y, z):
        phi, mu = p[:, 0:1], p[:, 1:2]
        return (mu + phi * (state[0] - mu),)

    def log_weight(p, state, y, z):
        (x,) = state
        return y[0] * x - torch.exp(x) - y[1]

    return KernelModel(num_params=3, init=init, propagate=propagate,
                       log_weight=log_weight, prop_mu=prop_mu, dim_obs=2,
                       name="poisson_ar", cuda_instance="poisson_ar")


def poisson_obs_rows(counts):
    """(T,) counts -> (T, 2) float32 kernel observation rows
    ``[y, gammaln(y + 1)]`` on the counts' device."""
    y = torch.as_tensor(counts).to(torch.float32).reshape(-1)
    return torch.stack([y, torch.lgamma(y + 1.0)], dim=-1)


@functools.lru_cache(maxsize=None)
def svol_t_kernel_model() -> KernelModel:
    """Student-t observation SVOL (``models/svol_t.py``).  The t constant
    c_nu needs gammaln of the row's nu, so it comes in as a derived
    parameter column: rows ``[beta, phi, sigma, nu, c_nu]``
    (:func:`svol_t_param_rows`).  CUDA instance ``SvolTModel``."""

    def init(rng, p, y, z, shape):
        phi, sigma = p[:, 1:2], p[:, 2:3]
        return (rng.normal(shape) * (sigma / torch.sqrt(1.0 - phi * phi)),)

    def propagate(rng, p, state, y, z):
        phi, sigma = p[:, 1:2], p[:, 2:3]
        (x,) = state
        return (phi * x + sigma * rng.normal(x.shape),)

    def prop_mu(p, state, y, z):
        return (p[:, 1:2] * state[0],)

    def log_weight(p, state, y, z):
        beta, nu, c_nu = p[:, 0:1], p[:, 3:4], p[:, 4:5]
        (x,) = state
        zval = (y[0] / beta) * torch.exp(-0.5 * x)
        return (c_nu - torch.log(beta) - 0.5 * x
                - 0.5 * (nu + 1.0) * torch.log1p(zval * zval / nu))

    return KernelModel(num_params=5, init=init, propagate=propagate,
                       log_weight=log_weight, prop_mu=prop_mu,
                       name="svol_t", cuda_instance="svol_t")


def svol_t_param_rows(params):
    """(B, 4) constrained (beta, phi, ss, nu) rows -> (B, 5) kernel rows
    ``[beta, phi, sigma, nu, c_nu]`` on the rows' device, with c_nu the t
    constant of ``rv.t_logpdf``: its nu > 200 asymptotic form is chosen
    by ``torch.where``, so PMMH can call this every iteration as
    ``constrain`` without a host read."""
    p = params.to(torch.float32)
    beta, phi, ss, nu = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    a = 0.5 * nu
    c_exact = (torch.lgamma(a + 0.5) - torch.lgamma(a)
               - 0.5 * torch.log(nu * math.pi))
    c_asym = (0.5 * torch.log(a) - 0.5 * torch.log(nu * math.pi)
              + torch.log1p(-1.0 / (8.0 * a) + 1.0 / (128.0 * a * a)))
    c_nu = torch.where(nu > 200.0, c_asym, c_exact)
    return torch.stack([beta, phi, torch.sqrt(ss), nu, c_nu], dim=-1)


__all__ = ["KernelModel", "filter_megakernel", "filter_megakernel_reference",
           "megakernel_log_like", "megakernel_swarm_evidence",
           "svol_kernel_model", "svol_kernel_rows",
           "svol_leverage_kernel_model", "factor_svol_kernel_model",
           "poisson_ar_kernel_model", "poisson_obs_rows",
           "svol_t_kernel_model", "svol_t_param_rows", "CUDA_MODEL_IDS",
           "FACTOR_ASSET_COUNTS", "step_spans", "BARRIERS_PER_STEP",
           "ROLL_BARRIERS_PER_STEP", "SPAN_PARTS", "SPAN_RECORD",
           "SPAN_TWINS"]
