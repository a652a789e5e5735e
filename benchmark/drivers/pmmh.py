"""Driver of the PMMH cells: ``AdaptivePMMH.step`` in a loop, each
iteration's likelihoods from the configuration's kernel hook.

Set-up builds the sampler and its hook, puts every chain at a start the
benchmark draws from the seed (the configuration's ``pmmh.start``), sets
the Haario state as the traffic says, and runs the warm-up iterations
through the same calls as the window.  Each iteration of the window is
``draw`` (the chains' proposal normals and uniforms from their
generators) then ``step``, as ``step`` does by itself when it is given no
draws; the benchmark keeps the draws and what the step returned, and its
own wrapper around the hook keeps the points the hook was handed.

After the window the plain reference (``benchmark/reference``) replays
every recorded iteration (proposal, prior and Jacobian, decision,
position) and estimates, with draws of its own, the likelihoods of a
sample of the window's iterations drawn from the seed; ``judge`` turns
both into the numbers compared.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.lib.trace import Spans
from benchmark.lib.window import Run, run_window, synchronize
from benchmark.reference import filters
from benchmark.reference.pmmh import SD_SCALE, EPS, Model, follow

DRAW_SPAN = "inference.pmmh.draw"
STEP_SPAN = "inference.pmmh.step"
# a decision whose log u lies within this many nats of the reference's
# log acceptance ratio is not judged: the program sums its float32
# likelihoods (~4000 nats, a unit in the last place of 5e-4) in float32
DECISION_MARGIN = 1e-2
# the likelihood is judged at the sampled proposals that the reference puts
# no more than this many nats under the median sampled proposal: the
# chains sit near the median, so a proposal further down is never
# accepted, and there the estimator's spread grows with the distance (a
# proposal at 1e5 nats down reads 1e4 nats apart between two sets of
# draws).  The rule reads the reference's values only.
LL_JUDGED_WITHIN = 50.0


def _program(config, traffic, device):
    """(StateSpaceModel, batched hook, covariates or None) of the
    configuration, built from the program."""
    from ssme_tpu_torch.models import svol, svol_leverage

    n, r = config["num_particles"], traffic["replicates"]
    ess, g = traffic["ess_threshold"], traffic["gate_stride"]
    hook = config["pmmh"]["hook"]
    if hook == "svol_filter_kernel":
        from ssme_tpu_torch.ops.svol_filter_kernel import \
            svol_batched_log_like
        return (svol.make_model(),
                svol_batched_log_like(n, r, ess_threshold=ess,
                                      gate_stride=g), None)
    if hook == "filter_megakernel":
        from ssme_tpu_torch.ops.filter_megakernel import (
            megakernel_log_like, svol_leverage_kernel_model)
        bounds = tuple(tuple(b[1:]) for b in config["pmmh"]["prior"])
        return (svol_leverage.make_model(prior_bounds=bounds),
                megakernel_log_like(svol_leverage_kernel_model(), n, r,
                                    ess_threshold=ess, gate_stride=g),
                svol_leverage.lagged_covariates)
    raise ValueError(f"unknown hook {hook!r}")


def start_state(cell, model, seed):
    """Transformed start positions (C, d) and the Haario (mean,
    sigma_hat, ct) the window starts from, float64 on the host, drawn
    from the seed."""
    spec = cell.config["pmmh"]["start"]
    c = cell.traffic["chains"]
    rng = np.random.default_rng(seed)
    if "draws" in spec:
        draws = np.load(cell.data_path(spec["draws"])).astype(np.float64)
        z_all = model.unconstrain(torch.as_tensor(draws))
        theta = z_all[torch.as_tensor(rng.choice(len(draws), c))]
        mean = z_all.mean(0)
        cov = torch.cov(z_all.T)
    else:
        mu = np.asarray(spec["normal"]["mean"], np.float64)
        sd = np.asarray(spec["normal"]["sd"], np.float64)
        lo = np.array([p[1] for p in cell.config["pmmh"]["prior"]])
        hi = np.array([p[2] for p in cell.config["pmmh"]["prior"]])
        pts = np.clip(mu + sd * rng.standard_normal((c, len(mu))),
                      lo + 1e-3 * (hi - lo), hi - 1e-3 * (hi - lo))
        theta = model.unconstrain(torch.as_tensor(pts))
        mean = model.unconstrain(torch.as_tensor(mu))
        # the posterior sd carried to the transformed space
        step = 1e-6 * np.maximum(np.abs(mu), 1.0)
        slope = (model.unconstrain(torch.as_tensor(mu + step))
                 - mean) / torch.as_tensor(step)
        cov = torch.diag((torch.as_tensor(sd) * slope) ** 2)
    d = theta.shape[1]
    ct = SD_SCALE / d * (cov + EPS * torch.eye(d, dtype=torch.float64))
    return (theta, mean.expand(c, d).clone(), cov.expand(c, d, d).clone(),
            ct.expand(c, d, d).clone())


class Recorder:
    """The benchmark's wrapper around the hook: a span named for the
    hook's module, and the points each call was handed."""

    def __init__(self, inner, spans, span):
        self.inner, self.spans, self.span = inner, spans, span
        self.params = []

    def __call__(self, gen, params, ys, *zs):
        with self.spans.span(self.span):
            self.params.append(params)
            return self.inner(gen, params, ys, *zs)

    def reset(self):
        self.params = []


def count_failed(spec, proposals, log_likes):
    """Iterations in which the hook gave a non-finite likelihood at a
    proposal inside the model's domain (the configuration's ``domain``:
    one [lo, hi] a parameter, null for no bound)."""
    inside = torch.ones_like(log_likes, dtype=torch.bool)
    for k, (lo, hi) in enumerate(spec.get("domain", [])):
        if lo is not None:
            inside &= proposals[..., k] > lo
        if hi is not None:
            inside &= proposals[..., k] < hi
    return int((inside & ~torch.isfinite(log_likes)).any(-1).sum())


def reference_log_likes(cell, model_name, proposals, seed, ys, dtype,
                        device):
    """(k, C) chain log-likelihoods of k iterations' constrained proposals
    (k, C, d) in ``dtype``, with draws from a generator seeded by ``seed``:
    R replicates a chain, a log-mean-exp."""
    tr = cell.traffic
    k, c, d = proposals.shape
    r = tr["replicates"]
    rows = proposals.to(device)[:, :, None].expand(k, c, r, d).reshape(
        k * c * r, d)
    tot = filters.bootstrap_log_likes(
        model_name, seed, rows, ys.to(device), cell.config["num_particles"],
        tr["ess_threshold"], tr["gate_stride"], dtype)
    return filters.log_mean_exp(tot.reshape(k, c, r).double(), dim=-1).cpu()


def _finite_gap(a, b):
    """(max |a - b| over the entries finite on both sides, entries finite
    on one side only)."""
    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    both = fa & fb
    gap = float((a - b)[both].abs().max()) if bool(both.any()) else 0.0
    return gap, int((fa != fb).sum())


def judge(ref, start, rec, outputs, ref_ll):
    """The numbers compared, as (name, value) pairs.

    ``ref`` is the float64 reference following the program's recorded
    chain ``rec`` (its positions, likelihood values and draws, from
    ``start``: ``reference.pmmh.follow``); ``outputs`` is what is
    judged on it: ``proposal`` (I, C, d) transformed, ``accepted`` (I, C),
    ``theta`` (I, C, d) and ``log_like`` (I, C) after each iteration, and
    ``sample_ll`` (k, C) the likelihoods of the sampled iterations'
    proposals, against the reference's ``ref_ll`` (k, C), estimated with
    draws of its own: ``ll_mean_gap`` and ``ll_rms_gap`` are the mean and
    root mean square of the gaps at the proposals within
    ``LL_JUDGED_WITHIN`` of the median.  ``mismatches`` counts the decisions that differ from the reference's, the chains
    whose likelihood after the step is not the one their decision keeps,
    and the proposals and positions finite on one side only."""
    acc = outputs["accepted"]
    expected = torch.where(acc[..., None], ref["proposal"], ref["previous"])
    prev_ll = torch.cat([start["log_like"][None], rec["log_like"][:-1]])
    keep = torch.where(acc, rec["new_log_like"], prev_ll).double()
    judged = ref["margin"] > DECISION_MARGIN
    kept = outputs["log_like"].double()
    mismatch = int(((ref["decision"] != acc) & judged).sum()) \
        + int(((keep != kept) & ~(keep.isnan() & kept.isnan())).sum())
    prop_gap, prop_odd = _finite_gap(outputs["proposal"], ref["proposal"])
    state_gap, state_odd = _finite_gap(outputs["theta"], expected)
    prog_ll, ref_ll = outputs["sample_ll"].double(), ref_ll.double()
    # a proposal outside the model's domain (beta <= 0) has no likelihood
    # on either side: it is left out; one side alone is a gap of inf
    fp, fr = torch.isfinite(prog_ll), torch.isfinite(ref_ll)
    floor = (ref_ll[fr].median() if bool(fr.any()) else 0.0) \
        - LL_JUDGED_WITHIN
    near = (fr & (ref_ll >= floor)) | (~fr & fp)
    gap = torch.where(fp & fr, prog_ll - ref_ll,
                      torch.full_like(ref_ll, math.inf))[near]
    return [
        ("ll_mean_gap", abs(float(gap.mean()))),
        ("ll_rms_gap", float(gap.pow(2).mean().sqrt())),
        ("proposal_gap", prop_gap),
        ("state_gap", state_gap),
        ("mismatches", float(mismatch + prop_odd + state_odd)),
    ]


def run(cell, seed, seconds, trace, t_process, device, limits,
        control=False):
    """One run of the cell; ``control`` also returns the readings of the
    control (the reference in bfloat16 in the program's place) on the
    same recorded window."""
    from ssme_tpu_torch.inference import AdaptivePMMH

    cfg, tr = cell.config, cell.traffic
    span = cfg["pmmh"]["hook"]
    ys = cell.series(device)
    model_p, hook, covariates = _program(cfg, tr, device)
    zs = None if covariates is None else covariates(ys)
    spans = Spans()
    recorder = Recorder(hook, spans, span)
    pmmh = AdaptivePMMH(model_p, num_particles=cfg["num_particles"],
                        num_replicates=tr["replicates"], t0=tr["t0"],
                        t1=tr["t1"], batched_log_like=recorder)
    ref_model = Model(cfg["pmmh"])
    theta0, mean0, sig0, ct0 = start_state(cell, ref_model, seed)
    f32 = dict(dtype=torch.float32, device=device)
    state = pmmh.init(seed, theta0.to(**f32), ys, num_chains=tr["chains"],
                      zs=zs)
    state = state._replace(mean=mean0.to(**f32), sigma_hat=sig0.to(**f32),
                           ct=ct0.to(**f32),
                           iteration=int(tr["start_iteration"]))
    recorder.reset()
    start = dict(theta=state.trans_theta, log_like=state.log_like,
                 mean=state.mean, sigma_hat=state.sigma_hat, ct=state.ct,
                 iteration=state.iteration)
    steps = []
    box = [state]

    def one(_):
        with spans.span(DRAW_SPAN):
            eps, log_u = pmmh.draw(box[0])
        with spans.span(STEP_SPAN):
            box[0], out = pmmh.step(box[0], ys, eps, log_u, zs=zs)
        steps.append((eps, log_u, out[0], out[1], out[3], out[6]))

    for i in range(int(tr["warmup_iterations"])):
        one(i)
    synchronize(device)
    warm = len(steps)
    setup_s = time.time() - t_process
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window_s, iters, intervals, tr_obj = run_window(one, seconds, device,
                                                    spans, trace)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # -- after the window: the reference replays the recorded run -------
    t_ref = time.perf_counter()
    cols = [torch.stack(c).cpu() for c in zip(*steps)]
    rec = dict(eps=cols[0], log_u=cols[1], theta=cols[2], log_like=cols[3],
               new_log_like=cols[4], accepted=cols[5])
    start = {k: (v.cpu() if torch.is_tensor(v) else v)
             for k, v in start.items()}
    proposals_c = torch.stack(recorder.params).cpu().double()
    outputs = dict(proposal=ref_model.unconstrain(proposals_c),
                   theta=rec["theta"], log_like=rec["log_like"],
                   accepted=rec["accepted"])
    rng = np.random.default_rng([seed, 1])
    k = min(int(tr["check_iterations"]), iters)
    picks = warm + np.sort(rng.choice(iters, k, replace=False))
    ref = follow(ref_model, start, rec, tr["t0"], tr["t1"], torch.float64)
    sample_c = ref_model.constrain(ref["proposal"][picks])
    ref_ll = reference_log_likes(cell, cfg["model"], sample_c,
                                 filters.stream_seed(seed, 2), ys, torch.float64,
                                 device)
    outputs["sample_ll"] = rec["new_log_like"][picks]
    numbers = judge(ref, start, rec, outputs, ref_ll)
    failed = count_failed(cfg["pmmh"], proposals_c[warm:],
                          rec["new_log_like"][warm:])
    run_ = Run(
        setup_s=setup_s, window_s=window_s, iterations=iters,
        props=float(iters) * tr["chains"] * tr["replicates"]
        * cfg["num_particles"] * ys.shape[0],
        intervals_ms=intervals,
        checks=[(n, v, limits[n]) for n, v in numbers],
        attempted=iters, failed=failed, memory_peak_bytes=int(peak),
        layer_span=span, layer=cfg["paths"][span],
        launch_shape=dict(B=tr["chains"] * tr["replicates"],
                          N=cfg["num_particles"], T=int(ys.shape[0])),
        trace=tr_obj, notes={"reference_s": time.perf_counter() - t_ref})
    if control:
        run_.notes["control"] = control_numbers(
            cell, ref_model, ref, start, rec, sample_c, filters.stream_seed(seed, 3),
            ys, ref_ll, device)
    return run_


def control_numbers(cell, model, ref, start, rec, sample_c, seed, ys,
                    ref_ll, device):
    """The numbers the control gives: the reference computed in
    bfloat16, in the program's place, on the same recorded MH draws and
    chain; its likelihoods at the sampled iterations' proposals
    ``sample_c``, as the hook is handed them, with draws of its own
    (``seed``)."""
    tr = cell.traffic
    low = follow(model, start, rec, tr["t0"], tr["t1"], torch.bfloat16)
    acc = low["decision"]
    prev_ll = torch.cat([start["log_like"][None], rec["log_like"][:-1]])
    ctrl_ll = reference_log_likes(cell, cell.config["model"], sample_c,
                                  seed, ys, torch.bfloat16, device)
    outputs = dict(proposal=low["proposal"], accepted=acc,
                   theta=torch.where(acc[..., None], low["proposal"],
                                     low["previous"]),
                   log_like=torch.where(acc, rec["new_log_like"], prev_ll),
                   sample_ll=ctrl_ll)
    return judge(ref, start, rec, outputs, ref_ll)
