"""Driver of the Liu-West cells: one launch of the leverage Liu-West
filter bank (``ops/svol_leverage_lw_kernel.py::svol_leverage_lw``) per
iteration, over the whole series, each with new key words drawn from the
seed.

After the window the plain reference (``benchmark/reference/liu_west.py``)
runs, for each of a sample of the window's passes drawn from the seed, a
bank of as many filters in float64 with draws of its own, and ``judge``
compares the two banks' log-likelihoods and final parameter clouds.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.lib.trace import Spans
from benchmark.lib.window import Run, run_window, synchronize
from benchmark.reference import liu_west
from benchmark.reference.filters import stream_seed

SPAN = "svol_leverage_lw_kernel"
MAX_PASSES = 1 << 13
# the least standard error of a cloud mean's gap (constrained units)
SE_FLOOR = 1e-4


def cloud_params(cloud):
    """(F, N, 4) constrained (phi, mu, sigma, rho) of a program cloud
    (F, 6, N) whose rows are [x, log-weight, theta transformed x 4]."""
    return liu_west.to_constrained(cloud[:, 2:6].permute(1, 0, 2).double()
                                   ).permute(1, 2, 0)


def judge(ll, cloud, ref_ll, ref_cloud):
    """The numbers compared, between the program's filters and as many
    of the reference's (independent draws, so filter i of one bank is
    no twin of filter i of the other): the mean gap of the
    log-likelihoods; the widest gap between the two banks' sorted
    log-likelihoods, which a fault in a single filter moves; and the
    largest z-score over the parameters of the filters' cloud means (the
    mean of the filters' differences over its standard error)."""
    gap = ll.double() - ref_ll.double()
    qq = torch.sort(ll.double()).values - torch.sort(ref_ll.double()).values
    d = cloud.double().mean(1) - ref_cloud.double().mean(1)   # (F, 4)
    z = d.mean(0) / torch.clamp(d.std(0) / math.sqrt(d.shape[0]),
                                min=SE_FLOOR)
    return [("ll_mean_gap", abs(float(gap.mean()))),
            ("ll_sorted_max_gap", float(qq.abs().max())),
            ("cloud_z", float(z.abs().max()))]


def run(cell, seed, seconds, trace, t_process, device, limits,
        control=False):
    from ssme_tpu_torch.ops.svol_leverage_lw_kernel import svol_leverage_lw

    cfg, tr = cell.config, cell.traffic
    ys = cell.series(device)
    f, n = tr["filters"], cfg["num_particles"]
    bounds = tuple(tuple(b) for b in cfg["liu_west"]["prior_bounds"])
    gen = torch.Generator().manual_seed(seed)
    words = torch.randint(0, 2 ** 32, (MAX_PASSES, 2), generator=gen,
                          dtype=torch.int64)
    seeds = words.to(device)
    outs = []
    spans = Spans()

    def one(i):
        with spans.span(SPAN):
            out = svol_leverage_lw(seeds[i], ys, num_filters=f,
                                   num_particles=n, delta=tr["delta"],
                                   prior_bounds=bounds,
                                   variant=tr["variant"])
        outs.append((out["log_likelihood"], out["cloud"]))

    for i in range(int(tr["warmup_iterations"])):
        one(i)
    synchronize(device)
    warm = len(outs)
    setup_s = time.time() - t_process
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window_s, iters, intervals, tr_obj = run_window(
        lambda i: one(warm + i), seconds, device, spans, trace)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    t_ref = time.perf_counter()
    rng = np.random.default_rng([seed, 1])
    picks = warm + np.sort(rng.choice(iters, min(int(tr["check_passes"]),
                                                 iters), replace=False))
    lls = torch.stack([outs[i][0] for i in range(warm, len(outs))]).cpu()
    ll = torch.cat([outs[i][0] for i in picks]).cpu()
    cloud = torch.cat([cloud_params(outs[i][1].cpu()) for i in picks])
    ref = [liu_west.liu_west_apf(stream_seed(seed, 2, i), ys, f, n,
                                 tr["delta"], bounds, torch.float64, device)
           for i in picks]
    ref_ll = torch.cat([r[0] for r in ref]).cpu()
    ref_cloud = torch.cat([r[1] for r in ref]).cpu()
    run_ = Run(
        setup_s=setup_s, window_s=window_s, iterations=iters,
        props=float(iters) * f * n * ys.shape[0], intervals_ms=intervals,
        checks=[(k, v, limits[k]) for k, v in judge(ll, cloud, ref_ll,
                                                     ref_cloud)],
        attempted=iters, failed=int((~torch.isfinite(lls)).any(-1).sum()),
        memory_peak_bytes=int(peak), layer_span=SPAN,
        layer=cfg["paths"][SPAN],
        launch_shape=dict(B=f, N=n, T=int(ys.shape[0])), trace=tr_obj,
        notes={"reference_s": time.perf_counter() - t_ref})
    if control:
        low = [liu_west.liu_west_apf(stream_seed(seed, 3, i), ys, f, n,
                                     tr["delta"], bounds, torch.bfloat16,
                                     device) for i in picks]
        run_.notes["control"] = judge(
            torch.cat([r[0] for r in low]).cpu(),
            torch.cat([r[1] for r in low]).cpu(), ref_ll, ref_cloud)
    return run_
