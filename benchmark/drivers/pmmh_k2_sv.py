"""Driver of the PMMH cell of factor SV as Pitt & Shephard publish it
(stochastic idiosyncratic variances): ``AdaptivePMMH.step`` in a loop,
each iteration's likelihoods from one launch of ``megakernel_log_like``
over K2's ``factor_svol_sv_<n>`` instance.

As ``drivers/pmmh_k2.py`` (whose ``series`` it imports, with
``drivers/pmmh.py``'s ``judge``, ``Recorder``, ``count_failed`` and
``start_state``), apart from the model: the program is
``models/factor_svol.py::make_sv_model`` over K2's idiosyncratic-SV
instance, and the plain reference is ``reference/factor_svol_sv.py``,
whose filter resamples every step (so the traffic must ask for that
schedule) and whose ``follow`` factors each proposal covariance once.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers.pmmh import (DRAW_SPAN, STEP_SPAN, Recorder,
                                    count_failed, judge, start_state)
from benchmark.drivers.pmmh_k2 import series
from benchmark.lib.trace import Spans
from benchmark.lib.window import Run, run_window, synchronize
from benchmark.reference import factor_svol_sv as reference
from benchmark.reference.filters import log_mean_exp, stream_seed


def _program(config, traffic, device):
    """(StateSpaceModel, batched hook, covariates or None) of the
    configuration, built from the program."""
    from ssme_tpu_torch.models import factor_svol
    from ssme_tpu_torch.ops.filter_megakernel import (
        factor_svol_sv_kernel_model, megakernel_log_like)

    if config["model"] != "factor_svol_sv" \
            or config["pmmh"]["hook"] != "filter_megakernel":
        raise ValueError(f"unknown model {config['model']!r} or hook "
                         f"{config['pmmh']['hook']!r}")
    na, k = config["n_assets"], config["k_factors"]
    return (factor_svol.make_sv_model(na, k),
            megakernel_log_like(factor_svol_sv_kernel_model(na),
                                config["num_particles"],
                                traffic["replicates"],
                                ess_threshold=traffic["ess_threshold"],
                                gate_stride=traffic["gate_stride"]), None)


def reference_log_likes(cell, proposals, seed, ys, dtype, device):
    """(k, C) chain log-likelihoods of k iterations' constrained proposals
    (k, C, d) in ``dtype``, with draws from a generator seeded by ``seed``:
    R replicates a chain, a log-mean-exp."""
    cfg, tr = cell.config, cell.traffic
    k, c, d = proposals.shape
    r = tr["replicates"]
    rows = proposals.to(device)[:, :, None].expand(k, c, r, d).reshape(
        k * c * r, d)
    tot = reference.bootstrap_log_likes(seed, rows, ys.to(device),
                                        cfg["num_particles"],
                                        cfg["k_factors"], dtype)
    return log_mean_exp(tot.reshape(k, c, r).double(), dim=-1).cpu()


def run(cell, seed, seconds, trace, t_process, device, limits,
        control=False):
    """One run of the cell; ``control`` also returns the readings of the
    control (the reference in bfloat16 in the program's place) on the
    same recorded window."""
    from ssme_tpu_torch.inference import AdaptivePMMH

    cfg, tr = cell.config, cell.traffic
    if tr["ess_threshold"] < 1.0 or tr["gate_stride"] != 1:
        raise ValueError("the factor-SV reference resamples every step: "
                         "the traffic needs ess_threshold 1.0, stride 1")
    # the benchmark's span around the hook, and the K2 instance it runs,
    # whose frozen counts are the configuration's paths["<span>.<instance>"]
    span, instance = cfg["pmmh"]["hook"], cfg["pmmh"]["instance"]
    ys = series(cell, device)
    model_p, hook, _ = _program(cfg, tr, device)
    spans = Spans()
    recorder = Recorder(hook, spans, span)
    pmmh = AdaptivePMMH(model_p, num_particles=cfg["num_particles"],
                        num_replicates=tr["replicates"], t0=tr["t0"],
                        t1=tr["t1"], batched_log_like=recorder)
    ref_model = reference.Model(cfg["pmmh"])
    theta0, mean0, sig0, ct0 = start_state(cell, ref_model, seed)
    f32 = dict(dtype=torch.float32, device=device)
    state = pmmh.init(seed, theta0.to(**f32), ys, num_chains=tr["chains"])
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
            box[0], out = pmmh.step(box[0], ys, eps, log_u)
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
    ref = reference.follow(ref_model, start, rec, tr["t0"], tr["t1"],
                           torch.float64)
    sample_c = ref_model.constrain(ref["proposal"][picks])
    ref_ll = reference_log_likes(cell, sample_c, stream_seed(seed, 2), ys,
                                 torch.float64, device)
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
        layer_span=span, layer=cfg["paths"][f"{span}.{instance}"],
        launch_shape=dict(B=tr["chains"] * tr["replicates"],
                          N=cfg["num_particles"], T=int(ys.shape[0])),
        trace=tr_obj, notes={"reference_s": time.perf_counter() - t_ref,
                             "kernel_instance": instance})
    if control:
        run_.notes["control"] = control_numbers(
            cell, ref_model, ref, start, rec, sample_c, stream_seed(seed, 3),
            ys, ref_ll, device)
    return run_


def control_numbers(cell, model, ref, start, rec, sample_c, seed, ys,
                    ref_ll, device):
    """The numbers the control gives: the reference computed in
    bfloat16, in the program's place, on the same recorded MH draws and
    chain; its likelihoods at the sampled iterations' proposals
    ``sample_c`` with draws of its own (``seed``)."""
    tr = cell.traffic
    low = reference.follow(model, start, rec, tr["t0"], tr["t1"],
                           torch.bfloat16)
    acc = low["decision"]
    prev_ll = torch.cat([start["log_like"][None], rec["log_like"][:-1]])
    ctrl_ll = reference_log_likes(cell, sample_c, seed, ys, torch.bfloat16,
                                  device)
    outputs = dict(proposal=low["proposal"], accepted=acc,
                   theta=torch.where(acc[..., None], low["proposal"],
                                     low["previous"]),
                   log_like=torch.where(acc, rec["new_log_like"], prev_ll),
                   sample_ll=ctrl_ll)
    return judge(ref, start, rec, outputs, ref_ll)
