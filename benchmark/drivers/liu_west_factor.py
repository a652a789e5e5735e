"""Driver of the Liu-West cells of the factor SV configuration: one
launch of K3's Liu-West filter bank over the configuration's (T, n)
panel per iteration (``ops/liu_west_megakernel.py::lw_megakernel`` on
``factor_svol_lw_kernel_model(n, box)``), each with new key words drawn
from the seed.

Before the window the seed picks ``check_passes`` of the window's first
``FIRST_PASSES`` passes; only their outputs stay on the card (and the
window's first pass's, in case the window ends before a pick), so the
caching allocator does not grow with the window.  After it the plain
reference (``benchmark/reference/liu_west_factor.py``) runs, for each
picked pass, a bank of as many filters in float64 with draws of its own,
and ``drivers/liu_west.py``'s ``judge`` compares the two banks'
log-likelihoods and final parameter clouds (all 21 parameters).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers.liu_west import MAX_PASSES, judge
from benchmark.lib.trace import Spans
from benchmark.lib.window import Run, run_window, synchronize
from benchmark.reference import liu_west_factor as reference
from benchmark.reference.filters import stream_seed

# the benchmark's span around each call into the measured layer, and the
# CUDA instance it runs, whose frozen counts are the configuration's
# paths["<span>.<instance>"]
SPAN = "lw_megakernel"
INSTANCE = "factor_svol_5_lw"
# the picked passes lie among the window's first this many
FIRST_PASSES = 16


def series(cell, device):
    """The configuration's observations (T, n), float32 on ``device``."""
    ys = np.loadtxt(cell.data_path(cell.config["data"]), delimiter=",",
                    ndmin=2)
    if ys.shape[1] != cell.config["n_assets"]:
        raise ValueError(f"{cell.config['data']} has {ys.shape[1]} "
                         f"columns, want {cell.config['n_assets']}")
    return torch.as_tensor(ys, dtype=torch.float32).contiguous().to(device)


def prior_bounds(cell):
    return tuple(tuple(b) for b in cell.config["liu_west"]["prior_bounds"])


def cloud_params(km, cloud):
    """(F, N, P) constrained parameters of a program cloud (F, S + 1 + P,
    N) whose rows are [x x S, log-weight, theta transformed x P]."""
    th = cloud[:, km.num_state + 1:].permute(1, 0, 2).double()
    kinds = reference.transform_kinds(km.dim_obs)
    return reference.to_constrained(th, kinds).permute(1, 2, 0)


def run(cell, seed, seconds, trace, t_process, device, limits,
        control=False):
    from ssme_tpu_torch.ops import liu_west_megakernel as lwm

    cfg, tr = cell.config, cell.traffic
    if cfg["model"] != "factor_svol" or cfg["k_factors"] != 2:
        raise ValueError(f"unknown model {cfg['model']!r}")
    ys = series(cell, device)
    f, n = tr["filters"], cfg["num_particles"]
    bounds = prior_bounds(cell)
    km = lwm.factor_svol_lw_kernel_model(cfg["n_assets"], bounds)
    if km.cuda_instance != INSTANCE and device.type == "cuda":
        raise ValueError(f"no CUDA instance for {cfg['n_assets']} assets")
    gen = torch.Generator().manual_seed(seed)
    words = torch.randint(0, 2 ** 32, (MAX_PASSES, 2), generator=gen,
                          dtype=torch.int64)
    seeds = words.to(device)
    rng = np.random.default_rng([seed, 1])
    picks = sorted(int(i) for i in rng.choice(
        FIRST_PASSES, int(tr["check_passes"]), replace=False))
    warm = int(tr["warmup_iterations"])
    kept = {}
    lls = []
    spans = Spans()

    def one(i):
        with spans.span(SPAN):
            out = lwm.lw_megakernel(km, seeds[i], ys, None, num_filters=f,
                                    num_particles=n, delta=tr["delta"],
                                    variant=tr["variant"])
        lls.append(out["log_likelihood"])
        if i - warm in picks or i == warm:
            kept[i - warm] = (out["log_likelihood"], out["cloud"])

    for i in range(warm):
        one(i)
    synchronize(device)
    setup_s = time.time() - t_process
    lls.clear()
    kept.clear()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window_s, iters, intervals, tr_obj = run_window(
        lambda i: one(warm + i), seconds, device, spans, trace)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    t_ref = time.perf_counter()
    checked = [i for i in picks if i < iters] or [0]
    ll = torch.cat([kept[i][0] for i in checked]).cpu()
    cloud = torch.cat([cloud_params(km, kept[i][1].cpu()) for i in checked])
    ref = [reference.liu_west_apf(stream_seed(seed, 2, i), ys, f, n,
                                  tr["delta"], bounds, torch.float64, device)
           for i in checked]
    ref_ll = torch.cat([r[0] for r in ref]).cpu()
    ref_cloud = torch.cat([r[1] for r in ref]).cpu()
    failed = int(sum(int((~torch.isfinite(v)).any()) for v in lls))
    run_ = Run(
        setup_s=setup_s, window_s=window_s, iterations=iters,
        props=float(iters) * f * n * ys.shape[0], intervals_ms=intervals,
        checks=[(k, v, limits[k]) for k, v in judge(ll, cloud, ref_ll,
                                                     ref_cloud)],
        attempted=iters, failed=failed, memory_peak_bytes=int(peak),
        layer_span=SPAN, layer=cfg["paths"][f"{SPAN}.{INSTANCE}"],
        launch_shape=dict(B=f, N=n, T=int(ys.shape[0])), trace=tr_obj,
        notes={"reference_s": time.perf_counter() - t_ref,
               "kernel_instance": INSTANCE, "checked_passes": checked})
    if control:
        low = [reference.liu_west_apf(stream_seed(seed, 3, i), ys, f, n,
                                      tr["delta"], bounds, torch.bfloat16,
                                      device) for i in checked]
        run_.notes["control"] = judge(
            torch.cat([r[0] for r in low]).cpu(),
            torch.cat([r[1] for r in low]).cpu(), ref_ll, ref_cloud)
    return run_
