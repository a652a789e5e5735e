"""Whole-sequence univariate-SVOL bootstrap filter bank: CUDA kernel and
its plain PyTorch version.

Replaces ``ssme_tpu/ops/svol_filter_kernel.py::svol_filter_pallas``.  The
kernel, ``csrc/svol_filter_sys.cu``, has two families on one layout
(kPer neighbouring particles per thread, paired Philox draws): systematic
selection (three barriers in a step that resamples, a forward walk for
the ancestors) and the roll-based ``"metropolis"`` and ``"rejection"``
resamplers (``csrc/roll_select.cuh``, keyed by slot); its header note
gives the step recursion, the layout and the intended divergences from
the Pallas kernel.  :func:`svol_filter_reference` runs the same
recursion step by step with plain tensor operations and the same Philox
bits (``ops/_prng.py``), on either device.

:func:`svol_filter` launches a kernel for CUDA tensors and runs the plain
version for CPU tensors; on a CUDA tensor it never falls back.  N runs to
4096 particles under each resampler (``ops/_select.py``; a power of two
under the roll ones); above 4096 it raises and points to the generic bank
of ``filters/bootstrap.py``.
"""

from __future__ import annotations

import math

import torch

from ssme_tpu_torch import profiling
from ssme_tpu_torch.models.svol import kernel_rows
from ssme_tpu_torch.ops import _cuda, _prng
from ssme_tpu_torch.ops._select import (MAX_ROLL_PARTICLES, RESAMPLER_CODES,
                                        check_particles, check_resampler,
                                        plain_ancestor_fn, resample_rows)
from ssme_tpu_torch.utils import logmeanexp


# the profiling span opened here: each launch, from the library to the
# launch count
HOST_SPANS = ("svol_filter.launch",)

# above the cap the two buffers of N floats would pass the 48 KB of static
# shared memory (csrc/svol_filter_sys.cu); JAX's kernel has no cap in code
_BEYOND = ("above 4096 particles run the generic bank, "
           "ssme_tpu_torch.filters.bootstrap.replicated_log_like_fn")


def _validate(seed, params, ys, num_particles, ess_threshold, gate_stride,
              resampler="systematic", metropolis_iters=16):
    if not isinstance(params, torch.Tensor) or params.ndim != 2 \
            or params.shape[1] != 3 or params.shape[0] < 1:
        raise ValueError("params must be a (B, 3) tensor of "
                         "[beta, phi, sigma] rows")
    dev = params.device
    if not isinstance(ys, torch.Tensor):
        raise ValueError("ys must be a tensor")
    if ys.ndim == 2 and ys.shape[1] == 1:
        ys = ys.reshape(-1)
    if ys.ndim != 1 or ys.shape[0] < 1:
        raise ValueError(f"ys must be (T,) or (T, 1), got {tuple(ys.shape)}")
    seed = _prng.seed_words(seed, device=dev)
    for name, t, dtype in (("params", params, torch.float32),
                           ("ys", ys, torch.float32),
                           ("seed", seed, torch.int64)):
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, params on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_resampler(resampler, metropolis_iters)
    check_particles(int(num_particles), resampler,
                    systematic_cap=MAX_ROLL_PARTICLES, beyond=_BEYOND)
    if int(gate_stride) != gate_stride or gate_stride < 1:
        raise ValueError("gate_stride must be a positive integer")
    if gate_stride > 1 and ess_threshold >= 1.0:
        raise ValueError(
            "gate_stride > 1 accumulates weights between ESS checks; the "
            "every-step schedule (ess_threshold >= 1) requires "
            "gate_stride=1")
    return seed, ys


def svol_filter_reference(seed, params, ys, num_particles=512,
                          ess_threshold=1.0, gate_stride=1,
                          resampler="systematic", metropolis_iters=16):
    """Plain PyTorch version of :func:`svol_filter`, callable on either
    device; consumes the kernel's Philox bits step by step."""
    seed, ys = _validate(seed, params, ys, num_particles, ess_threshold,
                         gate_stride, resampler, metropolis_iters)
    roll = resampler != "systematic"
    n, g = int(num_particles), int(gate_stride)
    b, t_len = params.shape[0], ys.shape[0]
    rows = torch.arange(b, device=params.device)
    beta, phi, sigma = params[:, 0:1], params[:, 1:2], params[:, 2:3]
    log_n = math.log(float(n))
    always = ess_threshold >= 1.0
    ess_limit = float(ess_threshold) * n
    c0 = -_prng.HALF_LOG_2PI - torch.log(beta)

    lcl = torch.zeros((b, t_len), dtype=torch.float32, device=params.device)
    xmean = torch.zeros_like(lcl)
    draws = _prng.StepBlocks(seed, rows, n, t_len)
    carry = torch.full_like(beta, log_n)
    s_last = s2_last = torch.ones_like(beta)
    for t in range(t_len):
        if t == 0:
            x = draws.normals(0) * (sigma / torch.sqrt(1.0 - phi * phi))
            lw = torch.zeros_like(x)
            wn = torch.ones_like(x)
        else:
            if g == 1:
                fire = True if always else s_last * s_last / s2_last < ess_limit
                (x,), lw, carry = resample_rows(
                    plain_ancestor_fn(resampler, metropolis_iters, seed, rows,
                                      t, n, draws.offsets(t)),
                    wn, (x,), lw, carry, fire, log_n, roll)
            x = phi * x + sigma * draws.normals(t)
        z = (ys[t] / beta) * torch.exp(-0.5 * x)
        lw = lw + ((c0 - 0.5 * x) - 0.5 * z * z)
        if not (g == 1 or t % g == g - 1 or t == t_len - 1):
            continue
        m = torch.amax(lw, dim=-1, keepdim=True)
        wn = torch.exp(lw - m)
        s = wn.sum(-1, keepdim=True)
        s2 = (wn * wn).sum(-1, keepdim=True)
        lcl[:, t] = ((m + torch.log(s)) - carry)[:, 0]
        xmean[:, t] = ((x * wn).sum(-1, keepdim=True) / s)[:, 0]
        lw = lw - m
        carry = torch.log(s)
        s_last, s2_last = s, s2
        if g > 1:
            (x,), lw, carry = resample_rows(
                plain_ancestor_fn(resampler, metropolis_iters, seed, rows, t,
                                  n, draws.offsets(t)),
                wn, (x,), lw, carry, s * s / s2 < ess_limit, log_n, roll)
    return lcl.sum(-1), lcl, xmean


def svol_filter(seed, params, ys, num_particles=512, ess_threshold=1.0,
                gate_stride=1, resampler="systematic", metropolis_iters=16):
    """B whole-sequence SVOL bootstrap filters in one launch.

    seed: (2,) int64 Philox key words on the params' device, or a Python
    int; params: (B, 3) float32 constrained [beta, phi, sigma] (sigma,
    not sigma^2); ys: (T,) or (T, 1) float32.  ``num_particles`` is a
    multiple of 32 up to 1024 or of 128 up to 4096.  Returns (total (B,),
    lcl (B, T), xmean (B, T)): total = sum_t log p(y_t | y_{1:t-1}); xmean
    the filtered E[x_t | y_{1:t}].

    ess_threshold: resample when a row's ESS falls below this fraction of
    N (1.0 = every step).  gate_stride g > 1 (ESS-adaptive schedules
    only): weights accumulate between checks at t = g-1 (mod g) and
    t = T-1; lcl and xmean are zero off those columns and sum(lcl) stays
    the exact evidence.

    resampler: "systematic", "metropolis" (``metropolis_iters`` sweeps;
    biased at a finite count, ``_select.metropolis_bias_estimate``) or
    "rejection" (unbiased), both at a power-of-two N in [32, 4096].
    """
    seed, ys = _validate(seed, params, ys, num_particles, ess_threshold,
                         gate_stride, resampler, metropolis_iters)
    if params.device.type == "cpu":
        return svol_filter_reference(seed, params, ys, num_particles,
                                     ess_threshold, gate_stride, resampler,
                                     metropolis_iters)
    if params.device.type != "cuda":
        raise ValueError(f"svol_filter: unsupported device {params.device}")
    return _launch(seed, params, ys, num_particles, ess_threshold,
                   gate_stride, resampler, metropolis_iters)


def _launch(seed, params, ys, num_particles, ess_threshold, gate_stride,
            resampler, metropolis_iters, spans=None):
    """One K1 launch on validated CUDA inputs: the instance of the
    resampler's family or, with ``spans`` an int64 (B, len(SPAN_RECORD))
    tensor, its instrumented twin (counted as ``ssme_svol_filter_spans``)."""
    with profiling.span("svol_filter.launch"):
        b, t_len = params.shape[0], ys.shape[0]
        dev = params.device
        total = torch.empty((b,), dtype=torch.float32, device=dev)
        lcl = torch.empty((b, t_len), dtype=torch.float32, device=dev)
        xmean = torch.empty_like(lcl)
        n = int(num_particles)
        _cuda.launch(
            "ssme_svol_filter" if spans is None else "ssme_svol_filter_spans",
            seed.data_ptr(), params.data_ptr(), ys.data_ptr(), b, t_len, n,
            float(ess_threshold) * n, int(ess_threshold >= 1.0),
            int(gate_stride), RESAMPLER_CODES[resampler],
            int(metropolis_iters), total.data_ptr(), lcl.data_ptr(),
            xmean.data_ptr(), None if spans is None else spans.data_ptr(),
            device=dev)
        return total, lcl, xmean


# the barriers a step of the kernel crosses, as its source note states
# them (csrc/svol_filter_sys.cu): systematic, and roll besides the
# selections' votes and tail barriers; step_spans counts them on the card
BARRIERS_PER_STEP = {"resample": 3, "check": 2, "other": 0}
ROLL_BARRIERS_PER_STEP = {"resample": 2, "check": 2, "other": 0}
# the parts of a step its clock64 spans time, then the rest of the
# instrumented instances' record per row (csrc/svol_filter_sys.cu Span)
SPAN_PARTS = ("propagate", "max", "sums", "stage", "walk", "gather")
SPAN_RECORD = SPAN_PARTS + ("checks", "resamples", "barriers_resample",
                            "barriers_check", "barriers_other", "votes",
                            "tail_barriers", "sweeps", "tail_slots", "kper",
                            "threads")


def step_spans(seed, params, ys, num_particles=512, ess_threshold=1.0,
               gate_stride=1, resampler="systematic", metropolis_iters=16):
    """Where a step's time goes on the card, and what it does: one launch
    of the instrumented twin of the resampler's instance, recorded by
    thread 0 of each row.  Returns {"cycles_per_step": {part: mean clock64
    cycles a step} over SPAN_PARTS (the barriers' waits inside the part
    that ends in them; a roll selection counts as the walk), "checks",
    "resamples": mean counts per row, "barriers_per_step": {"resample",
    "check", "other": barriers a step of that kind crossed, besides a roll
    selection's votes and tail barriers, mean over the rows' steps of that
    kind, or None where there was none}, "votes", "tail_barriers",
    "sweeps", "tail_slots": the roll selections' totals over the rows (0
    under systematic selection), "kper", "threads": the layout the launch
    ran, "outputs": (total, lcl, xmean), the plain instance's bits}."""
    seed, ys = _validate(seed, params, ys, num_particles, ess_threshold,
                         gate_stride, resampler, metropolis_iters)
    if params.device.type != "cuda":
        raise ValueError("step_spans: the record is the card's")
    spans = torch.zeros((params.shape[0], len(SPAN_RECORD)),
                        dtype=torch.int64, device=params.device)
    out = _launch(seed, params, ys, num_particles, ess_threshold,
                  gate_stride, resampler, metropolis_iters, spans=spans)
    rec = dict(zip(SPAN_RECORD, spans.double().sum(0).tolist()))
    b, t_len = params.shape[0], ys.shape[0]
    layout = spans[:, SPAN_RECORD.index("kper"):]
    if not bool((layout == layout[:1]).all()):
        raise RuntimeError("step_spans: rows report different layouts")
    steps = {"resample": rec["resamples"],
             "check": rec["checks"] - rec["resamples"],
             "other": b * t_len - rec["checks"]}
    return {"cycles_per_step": {k: rec[k] / (b * t_len) for k in SPAN_PARTS},
            "checks": rec["checks"] / b, "resamples": rec["resamples"] / b,
            "barriers_per_step": {k: rec[f"barriers_{k}"] / v if v else None
                                  for k, v in steps.items()},
            **{k: rec[k] for k in ("votes", "tail_barriers", "sweeps",
                                   "tail_slots")},
            "kper": int(layout[0, 0]), "threads": int(layout[0, 1]),
            "outputs": out}


def svol_replicated_log_like(num_particles: int, num_replicates: int,
                             ess_threshold: float = 0.5,
                             gate_stride: int = 1):
    """PMMH likelihood hook ``ll(gen, params (3,), ys) -> ()``: the
    log-mean-exp of ``num_replicates`` filters run in one launch."""
    r = num_replicates

    def ll(gen, params, ys):
        rows = kernel_rows(params)[None].expand(r, 3).contiguous()
        vals, _, _ = svol_filter(_prng.draw_seed(gen, params.device), rows,
                                 ys, num_particles=num_particles,
                                 ess_threshold=ess_threshold,
                                 gate_stride=gate_stride)
        return logmeanexp(vals)

    return ll


def svol_batched_log_like(num_particles: int, num_replicates: int,
                          ess_threshold: float = 0.5, gate_stride: int = 1):
    """PMMH ``batched_log_like`` hook: all chains x replicates in ONE
    kernel launch.

    Returns ``ll(gen, params (C, 3), ys) -> (C,)`` with ``params`` the
    constrained (beta, phi, ss) rows.  Rows are chain-major (row c*R + r
    is replicate r of chain c), reduced by a per-chain log-mean-exp.  The
    two seed words are drawn on the device with ``gen``, so the host
    never waits.  No padding rows: the ESS gate is per row.
    """
    r = num_replicates

    def ll(gen, params, ys):
        c = params.shape[0]
        rows = kernel_rows(params)[:, None].expand(c, r, 3).reshape(
            c * r, 3).contiguous()
        vals, _, _ = svol_filter(_prng.draw_seed(gen, params.device), rows,
                                 ys, num_particles=num_particles,
                                 ess_threshold=ess_threshold,
                                 gate_stride=gate_stride)
        return logmeanexp(vals.reshape(c, r), dim=-1)

    return ll


def svol_swarm_evidence(seed, param_draws, ys, num_particles=512,
                        ess_threshold: float = 1.0, gate_stride: int = 1):
    """Particle-swarm conditional evidence through the SVOL kernel: one
    filter per parameter draw (the kernel's row axis), per-step
    aggregation across models.

    ``param_draws``: (M, 3) constrained (beta, phi, ss) rows (e.g. from
    ``ssme_tpu_torch.io.ParamSampler``).  Returns ``log_cond_like`` (T,) =
    logmeanexp over models, ``mean_log_cond_like`` (T,) = the arithmetic
    mean of logs, ``per_model_log_cond_likes`` (M, T) and
    ``volatility_path`` (T,) = the swarm's E[x_t]; with ``gate_stride >
    1`` the lcls coarsen to per-check block sums and the path is zero off
    the check columns.
    """
    _, lcls, xmeans = svol_filter(seed, kernel_rows(param_draws).contiguous(),
                                  ys, num_particles=num_particles,
                                  ess_threshold=ess_threshold,
                                  gate_stride=gate_stride)
    return {
        "log_cond_like": logmeanexp(lcls, dim=0),
        "mean_log_cond_like": lcls.mean(0),
        "per_model_log_cond_likes": lcls,
        "volatility_path": xmeans.mean(0),
    }


__all__ = ["svol_filter", "svol_filter_reference", "svol_batched_log_like",
           "svol_replicated_log_like", "svol_swarm_evidence", "step_spans",
           "BARRIERS_PER_STEP", "ROLL_BARRIERS_PER_STEP", "SPAN_PARTS",
           "SPAN_RECORD"]
