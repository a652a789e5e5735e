#!/usr/bin/env python
"""Times of the filter kernels and of the paths that run them, on one
card, as one JSON line.

    python scripts/kernel_timing.py [ROOT] [--label NAME] [--reps 10]
                                    [--k1] [--k2] [--k3] [--roll] [--paths]
                                    [--bits]

ROOT (default: this checkout) is the tree whose ``ssme_tpu_torch`` is
imported, so that two trees can be timed in turns within one call on one
card, e.g. a parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists: parent, change, change, parent.  Each kernel
time is the mean over ``--reps`` launches after one warm-up, by CUDA
events, over all of ``data/spy_returns.csv``.

- ``--k1`` (with ``--k2``, the default when none of ``--k1``, ``--k2``,
  ``--k3``, ``--roll``, ``--bits`` is given): the SVOL
  filter kernel (K1) at B=256 and B=128 rows, N=512, at svol's chain
  start (as ``chip_smoke.py`` phase 6) and at the SPY posterior (the
  accuracy gate's means), parity (every step) and adaptive (ESS 0.5,
  checks every 8 steps); B=256 at N=2048 and 4096, systematic, ESS 0.5,
  at (0.9, 0.98, 0.02), as phase 26; where the tree has them, the
  instrumented record of a step (``step_spans``) at N=512, both
  schedules, and at N=2048, ESS 0.5;
- ``--k2``: the generic filter kernel (K2), SVOL-leverage at its tuned
  (ESS 0.5) and parity schedules and in APF mode (B=128, N=512 and 1024),
  svol_t parity (B=256, N=512 and 1024), svol APF and bootstrap (B=256,
  N=512), and Poisson AR (bootstrap and APF, B=128) and factor SVOL with
  4 assets (B=32) at their phase-18 shapes (``data/k2_families_jax.json``);
  where the tree has them, the systematic family's step records
  (``step_spans``) of the leverage cases at N=512 and 1024, and the factor
  SV model as published (``factor_svol_sv_10``, 12 leaves) at the
  benchmark cell's shape (B=256, N=1024, T=3084 x 10) with its twin's;
- ``--k3``: the Liu-West kernel (K3) under systematic selection over SPY,
  F=8 and 64 filters, N=512 and 1024, the leverage model's APF every
  step (``apf``), APF at ESS 0.5 (``apf-ess``) and SISR every step
  (``sisr``), and svol_t's APF (``svol_t-apf``): ms per launch
  (``k3_ms``, through ``lw_megakernel``); where the tree has them, the
  instrumented twins' step records of the leverage model's and svol_t's
  APF at F=64, N=512 and 1024 (``k3_spans``);
- ``--roll``: every filter kernel under the roll resamplers (both), over
  SPY at ESS 0.5 as ``chip_smoke.py`` phases 22 and 26-27, with
  phase 22's Metropolis sweep count: K2 (svol, B=256, N=2048 and 4096 at
  phase 22's point, N=2048 at svol's chain start), K1 (B=256, N=512,
  2048, 4096) and K3 (F=64, N=512, 2048, 4096, APF; ``--reps`` capped at
  3 above 512), ms per launch (``roll_ms``); where the tree has them, the
  generic kernel's roll twins' records at those K2 points
  (``roll_spans``: cycles a step by part, votes and tail slots a
  selection, sweeps a selection: median, 99th percentile, maximum) and
  the SVOL and Liu-West kernels' roll twins' records at their points
  (cycles a step by part, barriers, votes, sweeps and tail slots);
- ``--paths``: adaptive PMMH at N=2048 (C=64 x R=4, 10 iterations, ms per
  iteration, phase 28) and the ``spy_flagship`` CLI for 500 iterations
  per schedule (wall seconds, phase 29);
- ``--bits``: sha256 prefixes of the outputs of K1 (systematic, N=512
  and 2048) on fixed inputs (``bits``), and apart from them those of K1
  and K3 under the roll resamplers (both, N=512 and 2048:
  ``bits_k1_roll``, ``bits_k3_roll``), of K2's and K3's systematic
  families (``bits_k2_systematic``, ``bits_k3_systematic``) and of K2's
  roll family (``bits_k2_roll``), and, in a tree that has it, of K2's
  ``factor_svol_sv_10`` at N=512 and 1024 (``bits_k2_sv``), to show
  which families two trees
  compute the same bits in: a change of their arithmetic, their CDF's
  rounding order or their layout changes them.

Needs a CUDA card; imports no JAX.
"""

import argparse
import contextlib
import hashlib
import inspect
import io
import json
import math
import os
import sys
import tempfile
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("root", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--label", default=None)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--k1", action="store_true")
    p.add_argument("--k2", action="store_true")
    p.add_argument("--k3", action="store_true")
    p.add_argument("--roll", action="store_true")
    p.add_argument("--paths", action="store_true")
    p.add_argument("--bits", action="store_true")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import ssme_tpu_torch
    from ssme_tpu_torch.bench import gpu_identity
    from ssme_tpu_torch.io import read_data

    if not ssme_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {ssme_tpu_torch.__file__}, not from "
                           f"{root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: kernel_timing runs on the card "
                           "only")
    dev = torch.device("cuda")
    ys = torch.as_tensor(read_data(os.path.join(root, "data",
                                                "spy_returns.csv"),
                                   num_cols=1), device=dev)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    out = {"tree": args.label or root, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": gpu_identity(), "reps": args.reps}
    both = not (args.k1 or args.k2 or args.k3 or args.roll or args.bits)
    if args.k1 or both:
        out.update(_k1(torch, ys[:, 0].contiguous(), dev, ms))
    if args.k2 or both:
        out.update(_k2(torch, ys[:, 0].contiguous(), dev, ms))
    if args.k3:
        out.update(_k3(torch, ys[:, 0].contiguous(), ms))
    if args.roll:
        out.update(_roll(torch, ys[:, 0].contiguous(), dev, ms,
                         min(args.reps, 3)))
    if args.paths:
        out.update(_paths(ys, dev))
    if args.bits:
        out.update(_bits(torch, ys[:, 0].contiguous(), dev))
    print(json.dumps(out), flush=True)


def _k1(torch, ys, dev, ms):
    """K1 ms per launch and, where the tree has it, its step record."""
    from ssme_tpu_torch.models import svol
    from ssme_tpu_torch.ops import svol_filter_kernel as sfk

    def rows(theta, b):
        row = torch.tensor([float(theta[0]), float(theta[1]),
                            math.sqrt(float(theta[2]))], device=dev)
        return row.expand(b, 3).contiguous()

    schedules = {"parity": (1.0, 1), "adaptive": (0.5, 8)}
    start = svol.make_model().transform.constrain(
        torch.tensor(svol.START_TRANS_THETA))
    posterior = (0.846, 0.9747, 0.0652)    # data/torch_accuracy_gate*.json
    k1 = {}
    for b in (256, 128):
        for point, theta in (("", start), ("/posterior", posterior)):
            params = rows(theta, b)
            for sched, (ess, g) in schedules.items():
                k1[f"B{b}/N512/{sched}{point}"] = ms(
                    lambda: sfk.svol_filter(11, params, ys, num_particles=512,
                                            ess_threshold=ess, gate_stride=g))
    params = rows((0.9, 0.98, 0.02), 256)
    for n in (2048, 4096):
        k1[f"B256/N{n}/ess0.5"] = ms(lambda: sfk.svol_filter(
            11, params, ys, num_particles=n, ess_threshold=0.5))
    out = {"k1_ms": k1}
    if hasattr(sfk, "step_spans"):
        def record(*a):
            rec = sfk.step_spans(*a)
            rec.pop("outputs", None)  # a tree's twin may return its bits
            return rec
        out["spans"] = {f"N512/{sched}": record(
            11, rows(start, 256), ys, 512, ess, g)
            for sched, (ess, g) in schedules.items()}
        out["spans"]["N2048/ess0.5"] = record(
            11, rows((0.9, 0.98, 0.02), 256), ys, 2048, 0.5)
    return out


def _k2(torch, ys, dev, ms):
    """K2 ms per launch at the main paths' and the families' shapes, and,
    where the tree has them, the systematic family's step records."""
    from ssme_tpu_torch.models import svol_leverage
    from ssme_tpu_torch.ops import filter_megakernel as fmk

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(fmk.__file__))))
    out, spans = {}, {}
    lev = fmk.svol_leverage_kernel_model()
    zs = svol_leverage.lagged_covariates(ys)
    rows = torch.tensor([(0.95, -0.1, 0.3, -0.7)] * 128, device=dev)
    for n in (512, 1024):
        for name, ess, mode in (("tuned", 0.5, "bootstrap"),
                                ("parity", 1.0, "bootstrap"),
                                ("apf", 1.0, "apf")):
            kw = dict(num_particles=n, ess_threshold=ess, mode=mode)
            out[f"leverage_{name}/N{n}"] = ms(lambda: fmk.filter_megakernel(
                lev, 11, rows, ys, zs, **kw))
            if hasattr(fmk, "step_spans"):
                rec = fmk.step_spans(11, rows, ys, zs, **kw)
                rec.pop("outputs")
                spans[f"leverage_{name}/N{n}"] = rec
    svt = fmk.svol_t_param_rows(torch.tensor(
        [(0.868, 0.975, 0.064, 10.0)] * 256)).to(dev)
    for n in (512, 1024):
        out[f"svol_t_parity/N{n}"] = ms(lambda: fmk.filter_megakernel(
            fmk.svol_t_kernel_model(), 11, svt, ys, num_particles=n))
    srows = fmk.svol_kernel_rows(torch.tensor(
        [(0.868, 0.975, 0.064)] * 256)).to(dev).contiguous()
    for mode in ("apf", "bootstrap"):
        out[f"svol_{mode}"] = ms(lambda: fmk.filter_megakernel(
            fmk.svol_kernel_model(), 11, srows, ys, num_particles=512,
            mode=mode))
    with open(os.path.join(root, "data", "k2_families_jax.json")) as f:
        ref = json.load(f)
    counts = fmk.poisson_obs_rows(torch.tensor(
        ref["poisson_ar_counts"])).to(dev).contiguous()
    prows = torch.tensor([(0.9, 1.0, 0.3)] * 128, device=dev)
    for mode in ("bootstrap", "apf"):
        out[f"poisson_ar_{mode}"] = ms(lambda: fmk.filter_megakernel(
            fmk.poisson_ar_kernel_model(), 11, prows, counts,
            num_particles=512, mode=mode))
    fys = torch.tensor(ref["factor_svol_ys"], dtype=torch.float32,
                       device=dev)
    frows = torch.tensor(ref["factor_svol_params"], dtype=torch.float32,
                         device=dev).expand(32, -1).contiguous()
    out["factor_svol_4"] = ms(lambda: fmk.filter_megakernel(
        fmk.factor_svol_kernel_model(4), 11, frows, fys, num_particles=512))
    if hasattr(fmk, "factor_svol_sv_kernel_model"):
        # the factor SV model as published over the 10-column panel at the
        # benchmark cell's shape (B=256, N=1024, T=3084), and its twin
        from ssme_tpu_torch.examples.estimate_factor_svol import (DATA_SV,
                                                                  START_SV)
        panel = torch.as_tensor(np.loadtxt(DATA_SV, delimiter=","),
                                dtype=torch.float32, device=dev).contiguous()
        sv = fmk.factor_svol_sv_kernel_model(10)
        svrows = torch.tensor([START_SV] * 256, device=dev)
        out["factor_svol_sv_10"] = ms(lambda: fmk.filter_megakernel(
            sv, 11, svrows, panel, num_particles=1024))
        rec = fmk.step_spans(11, svrows, panel, None, 1024, kmodel=sv)
        rec.pop("outputs")
        spans["factor_svol_sv_10/N1024"] = rec
    return {"k2_ms": out, "k2_spans": spans}


def _k3(torch, ys, ms):
    """K3 systematic ms per launch over SPY and, where the tree has them,
    the twins' step records (svol_leverage_lw and svol_t_lw, APF)."""
    from ssme_tpu_torch.models import svol_leverage
    from ssme_tpu_torch.ops import liu_west_megakernel as lwm

    zs = svol_leverage.lagged_covariates(ys)[:, 0].contiguous()
    lev, svt = lwm.svol_leverage_lw_kernel_model(), lwm.svol_t_lw_kernel_model()
    runs = {"apf": (lev, zs, dict(variant="apf")),
            "apf-ess": (lev, zs, dict(variant="apf", ess_threshold=0.5)),
            "sisr": (lev, zs, dict(variant="sisr")),
            "svol_t-apf": (svt, None, dict(variant="apf"))}
    out, spans = {}, {}
    for f in (8, 64):
        for n in (512, 1024):
            for run, (km, z, kw) in runs.items():
                out[f"F{f}/N{n}/{run}"] = ms(lambda: lwm.lw_megakernel(
                    km, 11, ys, z, num_filters=f, num_particles=n, **kw))
    if hasattr(lwm, "step_spans"):
        for n in (512, 1024):
            for run in ("apf", "svol_t-apf"):
                km, z, kw = runs[run]
                rec = lwm.step_spans(11, ys, z, 64, n, kmodel=km, **kw)
                rec.pop("outputs")
                spans[f"F64/N{n}/{run}"] = rec
    return {"k3_ms": out, "k3_spans": spans}


def _roll(torch, ys, dev, ms, few):
    """Every filter kernel's roll family over SPY at ESS 0.5 and, where the
    tree has them, the generic kernel's roll twins' records."""
    from ssme_tpu_torch.models import svol, svol_leverage
    from ssme_tpu_torch.ops import _select
    from ssme_tpu_torch.ops import filter_megakernel as fmk
    from ssme_tpu_torch.ops import liu_west_megakernel as lwm
    from ssme_tpu_torch.ops import svol_filter_kernel as sfk

    def ms_few(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(few):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / few

    sweeps = _select.metropolis_sweeps_for(0.5, ys.shape[0], 0.5)
    point = fmk.svol_kernel_rows(torch.tensor([[0.9, 0.98, 0.02]] * 256))
    start = fmk.svol_kernel_rows(svol.make_model().transform.constrain(
        torch.tensor(svol.START_TRANS_THETA)).expand(256, -1))
    k2_rows = {"point": point.to(dev).contiguous(),
               "start": start.to(dev).contiguous()}
    km = fmk.svol_kernel_model()
    lw_km = lwm.svol_leverage_lw_kernel_model()
    lw_zs = svol_leverage.lagged_covariates(ys)[:, 0].contiguous()
    # the SVOL and Liu-West kernels' roll twins, in a tree that has them
    twins = "resampler" in inspect.signature(sfk.step_spans).parameters
    out, spans = {}, {}
    for r in ("metropolis", "rejection"):
        roll = dict(ess_threshold=0.5, resampler=r, metropolis_iters=sweeps)
        for n, at in ((2048, "point"), (4096, "point"), (2048, "start")):
            kw = dict(num_particles=n, **roll)
            out[f"K2/{r}/N{n}/{at}"] = ms_few(lambda: fmk.filter_megakernel(
                km, 11, k2_rows[at], ys, **kw))
            if hasattr(fmk, "SPAN_TWINS"):
                rec = fmk.step_spans(11, k2_rows[at], ys, None, n, kmodel=km,
                                     **roll)
                sw = rec.pop("sweeps")
                sw = sw[sw > 0].double()
                rec.pop("outputs")
                rec.pop("ratio")
                rec["sweeps_per_selection"] = {
                    "median": float(torch.quantile(sw, 0.5)),
                    "p99": float(torch.quantile(sw, 0.99)),
                    "max": float(sw.max()), "count": int(sw.numel())}
                spans[f"K2/{r}/N{n}/{at}"] = rec
        for n in (512, 2048, 4096):
            out[f"K1/{r}/N{n}"] = ms_few(lambda: sfk.svol_filter(
                11, point.to(dev).contiguous(), ys, num_particles=n, **roll))
            if twins:
                rec = sfk.step_spans(11, point.to(dev).contiguous(), ys, n,
                                     **roll)
                rec.pop("outputs")
                spans[f"K1/{r}/N{n}"] = rec
        for n in (512, 2048, 4096):
            kw = dict(num_filters=64, num_particles=n, resampler=r,
                      metropolis_iters=sweeps)
            out[f"K3/{r}/N{n}"] = ms_few(lambda: lwm.lw_megakernel(
                lw_km, 11, ys, lw_zs, **kw))
            if twins:
                rec = lwm.step_spans(11, ys, lw_zs, kmodel=lw_km, **kw)
                rec.pop("outputs")
                spans[f"K3/{r}/N{n}"] = rec
    return {"roll_ms": out, "roll_spans": spans, "roll_sweeps": sweeps}


def _paths(ys, dev):
    """Phase 28's PMMH at N=2048 and phase 29's flagship CLI."""
    import torch

    from ssme_tpu_torch.examples import spy_flagship
    from ssme_tpu_torch.inference import AdaptivePMMH
    from ssme_tpu_torch.models import svol
    from ssme_tpu_torch.ops import svol_filter_kernel as sfk

    iters = 10
    pmmh = AdaptivePMMH(svol.make_model(), num_particles=2048,
                        num_replicates=4, t0=150, t1=1000,
                        batched_log_like=sfk.svol_batched_log_like(
                            2048, 4, ess_threshold=0.5))
    state = pmmh.init(0, svol.START_TRANS_THETA, ys, num_chains=64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pmmh.run_from(state, iters, ys)
    torch.cuda.synchronize()
    res = {"pmmh_n2048_ms_per_iteration":
           (time.perf_counter() - t0) * 1e3 / iters, "flagship_s": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for ess in (1.0, 0.5):
            argv = ["--iters", "500", "--burn", "250", "--chunk", "250",
                    "--ess", str(ess), "--tag", f"timing_ess{ess}",
                    "--out-dir", tmp, "--device", dev.type]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()):
                spy_flagship.main(argv)
            res["flagship_s"][f"ess{ess}"] = time.perf_counter() - t0
    return res


def _bits(torch, ys, dev):
    """sha256 prefixes of K1's systematic outputs on fixed inputs, and
    apart from them those of K1's and K3's roll families, of K2's and K3's
    systematic families and of K2's roll family."""
    from ssme_tpu_torch.models.svol_leverage import lagged_covariates
    from ssme_tpu_torch.ops import filter_megakernel as fmk
    from ssme_tpu_torch.ops import liu_west_megakernel as lwm
    from ssme_tpu_torch.ops import svol_filter_kernel as sfk

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    ys = ys[:512].contiguous()
    zs = lagged_covariates(ys)
    rows = torch.tensor([[0.9, 0.98, math.sqrt(0.02)]] * 64, device=dev)
    lev = torch.tensor([[0.958, -0.080, 0.311, -0.751]] * 64, device=dev)
    out, k1_roll, k3_roll = {}, {}, {}
    k2_sys, k3_sys, k2_roll = {}, {}, {}
    for n in (512, 2048):
        out[f"K1/systematic/N{n}"] = digest(*sfk.svol_filter(
            3, rows, ys, num_particles=n, ess_threshold=0.5))
    for r in ("metropolis", "rejection"):
        for n in (512, 2048):
            k1_roll[f"K1/{r}/N{n}"] = digest(*sfk.svol_filter(
                3, rows, ys, num_particles=n, ess_threshold=0.5,
                resampler=r, metropolis_iters=16))
    for r in ("systematic", "rejection"):
        for name, km, p, z, mode in (
                ("svol", fmk.svol_kernel_model(), rows, None, "bootstrap"),
                ("svol_leverage", fmk.svol_leverage_kernel_model(), lev, zs,
                 "bootstrap"),
                ("svol", fmk.svol_kernel_model(), rows, None, "apf")):
            key = f"K2/{name}/{mode}/{r}"
            (k2_sys if r == "systematic" else k2_roll)[key] = digest(
                *fmk.filter_megakernel(km, 3, p, ys, z, num_particles=512,
                                       mode=mode, resampler=r)[:2])
    # the other K2 instances, systematic: svol_t, Poisson AR and factor
    # SVOL at each count compiled (its first n columns and parameters of
    # the benchmark's 5-asset generating point)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        fmk.__file__))))
    with open(os.path.join(root, "data", "k2_families_jax.json")) as f:
        ref = json.load(f)
    svt = fmk.svol_t_param_rows(torch.tensor(
        [(0.868, 0.975, 0.064, 10.0)] * 64)).to(dev)
    counts = fmk.poisson_obs_rows(torch.tensor(
        ref["poisson_ar_counts"])).to(dev).contiguous()
    prows = torch.tensor([(0.9, 1.0, 0.3)] * 64, device=dev)
    k2_sys["K2/svol_t/bootstrap/systematic"] = digest(*fmk.filter_megakernel(
        fmk.svol_t_kernel_model(), 3, svt, ys, num_particles=512)[:2])
    k2_sys["K2/poisson_ar/apf/systematic"] = digest(*fmk.filter_megakernel(
        fmk.poisson_ar_kernel_model(), 3, prows, counts, num_particles=512,
        mode="apf")[:2])
    panel = torch.as_tensor(np.loadtxt(os.path.join(
        root, "benchmark", "data", "factor_svol_5_returns.csv"),
        delimiter=",", ndmin=2)[:512], dtype=torch.float32, device=dev)
    ell = [(0.9, 0.0), (0.8, 0.3), (0.7, 0.5), (0.6, -0.4), (0.5, 0.6)]
    d = [0.30, 0.25, 0.35, 0.40, 0.30]
    for na in fmk.FACTOR_ASSET_COUNTS:
        row = ([0.98, 0.95, -0.5, -1.5, 0.15, 0.25]
               + [v for pair in ell[:na] for v in pair] + d[:na])
        frows = torch.tensor([row] * 64, device=dev)
        k2_sys[f"K2/factor_svol_{na}/bootstrap/systematic"] = digest(
            *fmk.filter_megakernel(fmk.factor_svol_kernel_model(na), 3, frows,
                                   panel[:, :na].contiguous(),
                                   num_particles=1024)[:2])
    km = lwm.svol_leverage_lw_kernel_model()
    for variant in ("apf", "sisr"):
        o = lwm.lw_megakernel(km, 3, ys, zs[:, 0].contiguous(),
                              num_filters=16, num_particles=512,
                              variant=variant)
        k3_sys[f"K3/{variant}/systematic"] = digest(o["log_cond_likes"],
                                                    o["cloud"])
    # K3's three register-row instances in both layouts: paired at F=16,
    # one CTA a filter at F=128 (more clusters than the card holds)
    for name, kmodel, z in (
            ("svol_leverage_lw", km, zs[:, 0].contiguous()),
            ("svol_t_lw", lwm.svol_t_lw_kernel_model(), None),
            ("svol_leverage_lw_q", lwm.svol_leverage_lw_q_kernel_model(1.5),
             zs[:, 0].contiguous())):
        for variant in ("apf", "sisr"):
            for f in (16, 128):
                o = lwm.lw_megakernel(kmodel, 3, ys, z, num_filters=f,
                                      num_particles=512, variant=variant)
                k3_sys[f"K3/{name}/{variant}/F{f}"] = digest(
                    o["log_cond_likes"], o["cloud"],
                    *o.get("functional_paths", ()))
    # the wide row (factor_svol_5_lw) in both layouts at N=1024 over the
    # panel's first 128 steps
    fkm = lwm.factor_svol_lw_kernel_model()
    for variant in ("apf", "sisr"):
        for f in (16, 128):
            o = lwm.lw_megakernel(fkm, 3, panel[:128], None, num_filters=f,
                                  num_particles=1024, variant=variant)
            k3_sys[f"K3/factor_svol_5_lw/{variant}/F{f}"] = digest(
                o["log_cond_likes"], o["cloud"], *o["functional_paths"])
    for r in ("metropolis", "rejection"):
        for n in (512, 2048):
            for variant in ("apf", "sisr"):
                o = lwm.lw_megakernel(km, 3, ys, zs[:, 0].contiguous(),
                                      num_filters=16, num_particles=n,
                                      variant=variant, resampler=r,
                                      metropolis_iters=16)
                key = f"K3/{variant}/{r}" + ("" if n == 512 else f"/N{n}")
                k3_roll[key] = digest(o["log_cond_likes"], o["cloud"])
    groups = {"bits": out, "bits_k1_roll": k1_roll, "bits_k3_roll": k3_roll,
              "bits_k2_systematic": k2_sys, "bits_k3_systematic": k3_sys,
              "bits_k2_roll": k2_roll}
    if hasattr(fmk, "factor_svol_sv_kernel_model"):
        # K2's factor_svol_sv_10 at both kPer over the 10-column panel's
        # first 512 steps, at its generating point
        from ssme_tpu_torch.examples.estimate_factor_svol import (DATA_SV,
                                                                  START_SV)
        sv_panel = torch.as_tensor(np.loadtxt(DATA_SV, delimiter=",")[:512],
                                   dtype=torch.float32,
                                   device=dev).contiguous()
        svrows = torch.tensor([START_SV] * 64, device=dev)
        groups["bits_k2_sv"] = {
            f"K2/factor_svol_sv_10/bootstrap/systematic/N{n}": digest(
                *fmk.filter_megakernel(fmk.factor_svol_sv_kernel_model(10), 3,
                                       svrows, sv_panel,
                                       num_particles=n)[:2])
            for n in (512, 1024)}
    return groups


if __name__ == "__main__":
    main()
