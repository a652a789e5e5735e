#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``ssme_tpu_torch/csrc`` and drives
its paths through the port's own entry points, over the full SPY series
(T=3084): adaptive PMMH on univariate SVOL at the flagship size (C=64
chains x R=4 replicates x N=512 particles) through the SVOL filter
kernel, adaptive PMMH on SVOL with leverage at its tuned size (C=64 x
R=2 x N=512) through the generic filter kernel, the kernel swarm
forecast (32 parameter draws x N=1024) from that posterior, Liu-West
joint state + parameter filtering of SVOL with leverage (F=64 filters x
N=512) through the Liu-West kernel, and adaptive PMMH on Student-t SVOL
at the flagship size through the generic filter kernel, whose other
model families (Poisson AR, factor SVOL) and APF mode are held to the
JAX package's filters.  Phases, one line each:

1. device   the card's name and power limit (no card: exit non-zero);
2. build    nvcc build of the kernels, with ptxas' register counts;
3. philox   the Philox kernel against the plain Philox on 2^20 pairs;
4. select   the selection kernel against the plain selection law;
5. filter   the filter kernel against the plain filter with a gate that
            never fires (identical random bits, no resampling);
6. filter   full size, both schedules, two parameter points: kernel and
            plain means within 4 combined standard errors; times;
7. pmmh     ``AdaptivePMMH`` + ``svol_batched_log_like``, 30 iterations
            per schedule; the kernel's launch count must rise by exactly
            iterations + 1 per run, and the iterations never synchronise
            with the host;
8. cli      ``ssme_tpu_torch.examples.estimate_univ_svol`` on the card;
9. megakernel-sis   the generic kernel against its plain version for
            both instances with a gate that never fires (totals, zero
            patterns, functional means, the final cloud), and its svol
            instance against the SVOL kernel on the same seed;
10. megakernel-full B=128 N=512, both instances, three schedules, two
            parameter points: kernel and plain means within 4 combined
            standard errors; times;
11. pmmh-leverage   ``AdaptivePMMH`` + ``megakernel_log_like`` on the
            leverage model, 30 iterations per gate stride, launches =
            iterations + 1, no host synchronisation;
12. posterior-leverage  ``ssme_tpu_torch.examples.estimate_svol_leverage
            --tuned`` for 2000 iterations at gate strides 1 and 8: the
            posterior means within 4 combined Monte-Carlo standard errors
            of the committed JAX posteriors;
13. swarm   ``ssme_tpu_torch.examples.swarm_forecast`` on the posterior
            samples of phase 12, and the swarm evidence against the plain
            version at N=1024;
14. lw-sis  the Liu-West kernel against its plain version for both
            instances (SISR, a gate that never fires: identical bits),
            and the leverage wrapper (K4) equal to the K3 instance;
15. lw-full F=64 N=512 over SPY, four schedules: kernel and plain means
            within 4 combined standard errors; times; a forecast from the
            kernel's cloud;
16. lw-cli  ``ssme_tpu_torch.examples.liu_west_leverage`` on the card,
            both engines, against the JAX package's float32 results in
            ``data/spy_liu_west_jax.json``; exactly one kernel launch;
17. megakernel-families-sis  the generic kernel's svol_t, poisson_ar and
            factor_svol (4 and 5 assets) instances against the plain
            version with a gate that never fires (identical bits), and
            its APF mode for svol, svol_leverage, svol_t and poisson_ar
            (B=32, T=64: step 0 equal, most per-step lcls equal, the
            totals' errors printed);
18. families-full  svol_t and svol APF over SPY (B=256), poisson_ar
            bootstrap and APF (B=128, T=3084) and factor_svol with 4 assets
            (B=32, T=500), N=512: kernel and plain means within 4 combined
            standard errors, and the kernel within 4 of the JAX package's
            float32 filters in ``data/k2_families_jax.json`` (factor_svol
            also of its float64 filter); times;
19. pmmh-svol_t  ``AdaptivePMMH`` on Student-t SVOL through
            ``megakernel_log_like`` (C=64 x R=4 x N=512, SPY), 30 iterations
            per gate stride, launches = iterations + 1, no host
            synchronisation;
20. large-n ``megakernel_log_like`` above the kernel's 1024 particles: the
            generic bank with ``model=``, no kernel launch; without it, an
            error.

Any failure exits non-zero.  The line before the last is a JSON object
describing the kernels; the last is the ``{"ok": true, ...}`` contract.
Imports nothing of JAX.
"""

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from ssme_tpu_torch.bench import gpu_identity  # noqa: E402
from ssme_tpu_torch.examples import estimate_svol_leverage as lev_cli  # noqa: E402,E501
from ssme_tpu_torch.examples import liu_west_leverage as lw_cli  # noqa: E402
from ssme_tpu_torch.inference import (AdaptivePMMH,  # noqa: E402
                                      forecast_from_cloud)
from ssme_tpu_torch.io import ParamSampler, read_data  # noqa: E402
from ssme_tpu_torch.models import (factor_svol, svol,  # noqa: E402
                                   svol_leverage, svol_t)
from ssme_tpu_torch.ops import _cuda, _prng, _select  # noqa: E402
from ssme_tpu_torch.ops import filter_megakernel as fmk  # noqa: E402
from ssme_tpu_torch.ops import liu_west_megakernel as lwm  # noqa: E402
from ssme_tpu_torch.ops import svol_filter_kernel as sfk  # noqa: E402
from ssme_tpu_torch.ops import svol_leverage_lw_kernel as k4  # noqa: E402
from ssme_tpu_torch.utils import logmeanexp  # noqa: E402

C, R, N = 64, 4, 512
B = C * R
ITERS = 30
SCHEDULES = {"parity": (1.0, 1), "adaptive": (0.5, 8)}
START = torch.tensor(svol.START_TRANS_THETA)

# the leverage path (estimate_svol_leverage --tuned) and its swarm
LC, LR = 64, 2
LB = LC * LR
K2_SCHEDULES = {"parity": (1.0, 1), "tuned": (0.5, 1), "adaptive": (0.5, 8)}
LEV_POINTS = {"start": lev_cli.START,
              "posterior": (0.958, -0.080, 0.311, -0.751)}
POSTERIORS = {1: "spy_leverage_pmmh_tuned.json",
              8: "spy_leverage_pmmh_tuned_stride8.json"}
SWARM_N, SWARM_M = 1024, 32

# the Liu-West path (liu_west_leverage --engine kernel)
LW_F, LW_N = 64, 512
LW_RUNS = {"apf": ("svol_leverage_lw", dict(variant="apf")),
           "apf-ess": ("svol_leverage_lw",
                       dict(variant="apf", ess_threshold=0.5)),
           "sisr": ("svol_leverage_lw", dict(variant="sisr")),
           "svol_t-apf": ("svol_t_lw", dict(variant="apf"))}

# the generic kernel's other families (phases 17-20): the JAX package's
# float32 yardsticks (scripts/k2_families_jax.py) and the points they are at
FAMILIES_JSON = os.path.join(ROOT, "data", "k2_families_jax.json")
SVOL_T_POINT = (0.868, 0.975, 0.064, 10.0)
POISSON_POINT = (0.9, 1.0, 0.3)
# svol's chain start with log nu = log 10 appended
SVOL_T_START = tuple(svol.START_TRANS_THETA) + (math.log(10.0),)
APF_B, APF_T = 32, 64
FACTOR_B = 32

# the least time of a kernel's work: the larger of its bytes over the HBM
# rate and its operations over the float32 rate outside the tensor cores
# (H100 SXM data sheet; integer and special-
# function operations run no faster, so the bound stays a lower bound)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# operations per particle and step, counted from the sources; a normal is
# half a Philox4x32-10 call (10 rounds x 2 mul-hi, 2 mul, 4 xor, 2 key
# adds = 100) plus its half of Box-Muller (~12): 56.  Resampling inside a
# gated schedule depends on the data and is left out (a lower bound).
NORMAL_OPS = 56
STEP_OPS = {
    # normal, phi x + sigma e, the weight (exp, 2 mul, fma), max/exp/3 sums
    "svol_filter": NORMAL_OPS + 2 + 6 + 8,
    # the leverage transition mean (exp, 3 mul, fma, clamp) adds 10
    "filter_megakernel": NORMAL_OPS + 12 + 6 + 8,
    # P + 1 = 5 normals; moments (exp, 5 sums, 10 Gram terms x 3); shrink
    # 8; four constrains (7 each); lookahead 12; three weights (6 each);
    # first-stage max/exp and selection (scan, 9-step search, 6 gathers)
    # 20; kernel draw 10 fma = 20; transition 14; weigh 8; the every-step
    # resample (scan, search, 5 gathers) 15
    "lw_megakernel": 5 * NORMAL_OPS + 36 + 8 + 28 + 12 + 18 + 20 + 20 + 14
                     + 8 + 15,
    # the generic kernel's other instances (bootstrap): svol_t's weight
    # adds a divide, a log1p and two multiplies to svol's (10)
    "filter_megakernel/svol_t": NORMAL_OPS + 2 + 10 + 8,
    # transition mean (sub, fma) + fma 3; weight (mul, exp, 2 sub) 4
    "filter_megakernel/poisson_ar": NORMAL_OPS + 3 + 4 + 8,
    # two normals, two transitions (3 each); weight: v1, v2, yy over 4
    # assets (3 x 4 fma + 4 mul), 2 exp + 2 add, det 2, the quadratic form
    # 8 + a divide, log + 3 adds, 3 for the result: 36
    "filter_megakernel/factor_svol_4": 2 * NORMAL_OPS + 6 + 36 + 8,
    # APF adds per step: the lookahead twice (svol: 1 each), two more
    # weights (6 each), the first-stage add and exp/max 2, and the
    # selection (scan, 9-step search, gather) 20
    "filter_megakernel/svol/apf": NORMAL_OPS + 2 + 6 + 8 + 2 * 1 + 2 * 6
                                  + 2 + 20,
    # poisson_ar: lookahead 2 each, weights 4 each
    "filter_megakernel/poisson_ar/apf": NORMAL_OPS + 3 + 4 + 8 + 2 * 2
                                        + 2 * 4 + 2 + 20,
}


def phase(num, name, msg):
    print(f"phase {num} {name}: ok {msg}", flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` by CUDA events (after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(name, num_rows, num_particles, num_steps, in_bytes, out_bytes):
    """(bound_ms, bound_by) of one launch of kernel ``name``."""
    ops = STEP_OPS[name] * num_rows * num_particles * num_steps
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else
            "operations")


def event_ms(fn):
    """(result, milliseconds) of one call of ``fn`` by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke runs on the card only")
    ident = gpu_identity()
    phase(1, "device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: "
          f"{ident} | count {torch.cuda.device_count()}")
    print(ident, flush=True)
    return ident


def phase_build():
    t0 = time.perf_counter()
    _cuda.library()
    info = _cuda.build_info
    phase(2, "build", f"{time.perf_counter() - t0:.3f} s (nvcc "
          f"{info.get('seconds', 0.0):.3f} s) "
          + " | ".join(info.get("ptxas", [])))


def phase_philox(dev):
    seed = _prng.seed_words(0x243F6A8885A308D3, device=dev)
    rows, n, step = 256, 8192, 3084        # 2^20 Box-Muller pairs
    got = _prng.philox_fill(seed, rows, n, step)
    want = _prng.philox_fill_reference(seed, rows, n, step)
    for key in ("bits", "u1", "u2", "offsets"):
        require(torch.equal(got[key], want[key]), f"philox {key} differ")
    require(bool((got["u1"] > 0).all()) and bool((got["offsets"] > 0).all())
            and bool((got["offsets"] < 1).all()), "uniform edge rule broken")
    # the kernel's logf/sqrtf/sincosf and torch's may differ in the last
    # bit or two of float32: 1e-6 relative, 1e-7 absolute near zero
    torch.testing.assert_close(got["normals"], want["normals"], rtol=1e-6,
                               atol=1e-7)
    err = float((got["normals"] - want["normals"]).abs().max())
    phase(3, "philox", f"{rows * n // 2} pairs: bits, uniforms, offsets "
          f"bitwise equal; normals max abs err {err:.3e}")


def phase_select(dev):
    rng = np.random.default_rng(4)
    w = torch.as_tensor(rng.gamma(1.0, 1.0, (B, N)).astype(np.float32),
                        device=dev)
    ids = torch.arange(N, dtype=torch.float32, device=dev).expand(B, N)
    vals = torch.as_tensor(rng.normal(size=(B, N)).astype(np.float32),
                           device=dev)
    leaves = torch.stack([ids, vals]).contiguous()
    u0 = _prng.offsets(_prng.seed_words(5, device=dev),
                       torch.arange(B, device=dev), 1)
    picked, anc = _select.systematic_select(w, leaves, u0)
    _, anc_plain = _select.systematic_select_reference(w, leaves, u0)
    anc, anc_plain = anc.long(), anc_plain.long()
    require(torch.equal(picked[0].long(), anc), "ids leaf != ancestors")
    require(torch.equal(picked[1], torch.gather(vals, 1, anc)),
            "values leaf not moved by the same ancestors")
    diff = anc != anc_plain
    frac = float(diff.float().mean())
    require(frac < 0.01, f"{frac:.4%} of ancestor slots disagree")
    # every disagreement must sit within 1e-5 * total of a CDF boundary
    # between the two ancestors chosen (float64 CDF and points)
    w64 = w.double()
    cdf = torch.cumsum(w64, dim=1)
    total = cdf[:, -1:]
    u = (torch.arange(N, device=dev, dtype=torch.float64)[None]
         + u0.double()[:, None]) * total / N
    worst = 0.0
    for b_, j in diff.nonzero().tolist():
        lo, hi = sorted((int(anc[b_, j]), int(anc_plain[b_, j])))
        gap = float((cdf[b_, lo:hi] - u[b_, j]).abs().min() / total[b_, 0])
        worst = max(worst, gap)
        require(gap <= 1e-5, f"row {b_} slot {j}: disagreement {gap:.2e} "
                "of the total away from a boundary")
    phase(4, "select", f"B={B} N={N}: {int(diff.sum())} of {B * N} slots "
          f"differ ({frac:.5%}), worst boundary distance {worst:.2e} total;"
          " leaves move jointly")


def phase_filter_sis(dev, ys_all):
    """No resampling: identical bits through identical recursions."""
    ys = ys_all[:512].reshape(-1).contiguous()
    params = torch.tensor([[1.0, 0.5, math.sqrt(2e-4)]] * (B // 2)
                          + [[0.9, 0.98, math.sqrt(0.02)]] * (B // 2),
                          device=dev)
    errs = []
    for g in (1, 8):
        kw = dict(num_particles=N, ess_threshold=1e-6, gate_stride=g)
        tot, lcl, xm = sfk.svol_filter(7, params, ys, **kw)
        tot_p, lcl_p, xm_p = sfk.svol_filter_reference(7, params, ys, **kw)
        # float32 throughout; the kernel fuses multiply-adds and reduces
        # in another order than torch, so each step differs by a few ulp
        # and the totals by far less than 1e-4 relative
        torch.testing.assert_close(tot, tot_p, rtol=1e-4, atol=1e-3)
        require(torch.equal(lcl != 0, lcl_p != 0), f"g={g}: zero pattern")
        torch.testing.assert_close(xm, xm_p, rtol=1e-3, atol=1e-3)
        errs.append(float((tot - tot_p).abs().max()))
    phase(5, "filter-sis", f"B={B} N={N} T=512 strides 1, 8: totals max abs"
          f" err {errs[0]:.3e}, {errs[1]:.3e}; lcl zero patterns identical")
    return max(errs)


def phase_filter_full(dev, ys):
    points = {"start": svol.make_model().transform.constrain(START),
              "posterior": torch.tensor([0.9, 0.98, 0.02])}
    times = {}
    plain_start = {}
    for sched, (ess, g) in SCHEDULES.items():
        for pname, theta in points.items():
            row = torch.stack([theta[0], theta[1], torch.sqrt(theta[2])])
            params = row.to(dev).expand(B, 3).contiguous()
            kw = dict(num_particles=N, ess_threshold=ess, gate_stride=g)
            tot = sfk.svol_filter(11, params, ys, **kw)[0]
            tot_p = sfk.svol_filter_reference(12, params, ys, **kw)[0]
            require(bool(torch.isfinite(tot).all())
                    and bool(torch.isfinite(tot_p).all()), "NaN totals")
            se = math.sqrt(float(tot.var()) / B + float(tot_p.var()) / B)
            d = abs(float(tot.mean()) - float(tot_p.mean()))
            require(d <= 4 * se, f"{sched}/{pname}: means differ by {d:.3f}"
                    f" > 4 SE {4 * se:.3f}")
            if pname == "start":
                plain_start[sched] = tot_p
                times[sched] = (
                    cuda_ms(lambda: sfk.svol_filter(11, params, ys, **kw), 5),
                    cuda_ms(lambda: sfk.svol_filter_reference(
                        12, params, ys, **kw), 1))
            print(f"  {sched}/{pname}: kernel mean {float(tot.mean()):.4f} "
                  f"plain mean {float(tot_p.mean()):.4f} (4 SE "
                  f"{4 * se:.4f})", flush=True)
    phase(6, "filter-full", f"B={B} N={N} T={ys.shape[0]}: " + "; ".join(
        f"{s} kernel {k:.4f} ms, plain {p:.4f} ms"
        for s, (k, p) in times.items()))
    return times, plain_start


def phase_pmmh(dev, ys, ident, plain_start):
    props_per_run = ITERS * C * R * N * ys.shape[0]   # init not timed
    sfk.svol_filter.launches = 0
    rates, counts = {}, {}
    for sched, (ess, g) in SCHEDULES.items():
        before = sfk.svol_filter.launches
        pmmh = AdaptivePMMH(svol.make_model(), num_particles=N,
                            num_replicates=R, t0=150, t1=1000,
                            batched_log_like=sfk.svol_batched_log_like(
                                N, R, ess_threshold=ess, gate_stride=g))
        state = pmmh.init(0, svol.START_TRANS_THETA, ys, num_chains=C)
        torch.cuda.synchronize()
        # the loop must never wait for the device: any synchronising call
        # (a device-to-host read, a pageable host-to-device copy) raises
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            res = pmmh.run_from(state, ITERS, ys)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts[sched] = sfk.svol_filter.launches - before
        require(counts[sched] == ITERS + 1,
                f"{sched}: {counts[sched]} kernel launches, want {ITERS + 1}")
        require(bool(torch.isfinite(state.log_like).all())
                and bool(torch.isfinite(res.log_likes).all()),
                f"{sched}: non-finite log-likelihoods")
        n_acc = int(res.accepted.sum())
        require(n_acc >= 1, f"{sched}: no proposal accepted")
        # the chains' starting log-likelihoods against the plain filter's
        # replicate-averaged ones at the same point and schedule
        ref = logmeanexp(plain_start[sched].reshape(C, R), dim=-1)
        se = math.sqrt(float(state.log_like.var()) / C
                       + float(ref.var()) / C)
        d = abs(float(state.log_like.mean()) - float(ref.mean()))
        require(d <= 4 * se, f"{sched}: init log-likelihood off by {d:.3f}")
        rates[sched] = props_per_run / secs
        print(f"  {sched}: {counts[sched]} launches, {n_acc} accepts, "
              f"{secs:.4f} s, {rates[sched]:.6e} props/s on {ident}",
              flush=True)
    total = sfk.svol_filter.launches
    phase(7, "pmmh", f"C={C} R={R} N={N} T={ys.shape[0]} {ITERS} iters: "
          + "; ".join(f"{s} {r:.6e} props/s" for s, r in rates.items())
          + f" ({ident})")
    return total, rates


def phase_cli():
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "ssme_tpu_torch.examples.estimate_univ_svol",
               os.path.join(ROOT, "data", "spy_returns.csv"),
               os.path.join(tmp, "samples"), os.path.join(tmp, "messages"),
               "10", "4", "--chains", "8", "--particles", "512",
               "--device", "cuda", "--no-timestamp"]
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        require(out.returncode == 0, f"CLI exited {out.returncode}:\n"
                f"{out.stderr[-4000:]}")
        for c in range(8):
            with open(os.path.join(tmp, f"samples_chain{c}")) as f:
                rows = [ln.split(",") for ln in f.read().splitlines()]
            require(len(rows) == 10 and all(len(r) == 3 for r in rows),
                    f"chain {c}: bad samples file")
            require(all(math.isfinite(float(v)) for r in rows for v in r),
                    f"chain {c}: non-finite sample")
            with open(os.path.join(tmp, f"messages_chain{c}")) as f:
                lines = f.read().splitlines()
            require(len(lines) == 11 and lines[0].startswith("iter number"),
                    f"chain {c}: bad messages file")
    phase(8, "cli", "10 iterations x 8 chains on cuda: sample and message "
          "files well formed")


def _svol_rows(theta, rows):
    """Constrained (beta, phi, ss) -> (rows, 3) kernel rows."""
    row = torch.tensor([float(theta[0]), float(theta[1]),
                        math.sqrt(float(theta[2]))])
    return row.expand(rows, 3).contiguous()


def _instances(zs):
    """(name, kernel model, covariates) of both generic-kernel instances."""
    return [("svol", fmk.svol_kernel_model(), None),
            ("svol_leverage", fmk.svol_leverage_kernel_model(), zs)]


def _compare_sis(name, km, rows, ys, zs, g, errs):
    """Kernel against plain on identical bits, a gate that never fires:
    totals, zero patterns, functional means, the cloud and its weights;
    records the totals' max abs error in ``errs`` and returns the
    kernel's totals."""
    kw = dict(num_particles=N, ess_threshold=1e-6, gate_stride=g,
              return_cloud=True)
    tot, lcl, fm, cloud, clw = fmk.filter_megakernel(km, 7, rows, ys, zs,
                                                     **kw)
    tot_p, lcl_p, fm_p, cloud_p, clw_p = fmk.filter_megakernel_reference(
        km, 7, rows, ys, zs, **kw)
    # float32 throughout; fused multiply-adds and another reduction order
    # put a few ulp into each step (see phase 5)
    torch.testing.assert_close(tot, tot_p, rtol=1e-4, atol=1e-3,
                               msg=f"{name} g={g}: totals")
    require(torch.equal(lcl != 0, lcl_p != 0), f"{name} g={g}: zero pattern")
    torch.testing.assert_close(fm, fm_p, rtol=1e-3, atol=1e-3,
                               msg=f"{name} g={g}: functional means")
    for leaf, (a, b) in enumerate(zip(cloud, cloud_p)):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3,
                                   msg=f"{name} g={g}: cloud leaf {leaf}")
    torch.testing.assert_close(torch.exp(clw), torch.exp(clw_p), rtol=1e-3,
                               atol=1e-3, msg=f"{name} g={g}: weights")
    errs[f"{name}/g{g}"] = float((tot - tot_p).abs().max())
    return tot


def phase_megakernel_sis(dev, ys_all):
    """No resampling: identical bits through identical recursions."""
    ys = ys_all[:512, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)
    half = LB // 2
    params = {
        "svol": torch.cat([_svol_rows((1.0, 0.5, 2e-4), half),
                           _svol_rows((0.9, 0.98, 0.02), half)]).to(dev),
        "svol_leverage": torch.tensor(
            [LEV_POINTS["start"]] * half + [LEV_POINTS["posterior"]] * half,
            device=dev)}
    errs, k1_errs = {}, []
    for name, km, z in _instances(zs):
        for g in (1, 8):
            tot = _compare_sis(name, km, params[name], ys, z, g, errs)
            if name == "svol":
                tot_k1 = sfk.svol_filter(7, params[name], ys,
                                         num_particles=N, ess_threshold=1e-6,
                                         gate_stride=g)[0]
                k1_errs.append(float((tot - tot_k1).abs().max()))
                require(k1_errs[-1] <= 1e-3,
                        f"g={g}: svol instance vs svol_filter differ by "
                        f"{k1_errs[-1]:.3e}")
    phase(9, "megakernel-sis", f"B={LB} N={N} T=512 strides 1, 8: totals max"
          f" abs err {', '.join(f'{e:.3e}' for e in errs.values())} (svol "
          f"g1, g8, leverage g1, g8); cloud and weights within 1e-3; svol "
          f"instance vs svol_filter {k1_errs[0]:.3e}, {k1_errs[1]:.3e}")
    return max(errs.values())


def phase_megakernel_full(dev, ys_all, ident):
    ys = ys_all[:, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)
    points = {
        "svol": {"start": svol.make_model().transform.constrain(START),
                 "posterior": (0.9, 0.98, 0.02)},
        "svol_leverage": LEV_POINTS}
    times = {}
    for name, km, z in _instances(zs):
        for sched, (ess, g) in K2_SCHEDULES.items():
            kw = dict(num_particles=N, ess_threshold=ess, gate_stride=g)
            for pname, theta in points[name].items():
                params = (_svol_rows(theta, LB) if name == "svol"
                          else torch.tensor([theta] * LB)).to(dev)
                tot = fmk.filter_megakernel(km, 11, params, ys, z, **kw)[0]
                tot_p = fmk.filter_megakernel_reference(km, 12, params, ys, z,
                                                        **kw)[0]
                require(bool(torch.isfinite(tot).all())
                        and bool(torch.isfinite(tot_p).all()),
                        f"{name}/{sched}/{pname}: NaN totals")
                se = math.sqrt(float(tot.var()) / LB + float(tot_p.var()) / LB)
                d = abs(float(tot.mean()) - float(tot_p.mean()))
                require(d <= 4 * se, f"{name}/{sched}/{pname}: means differ "
                        f"by {d:.3f} > 4 SE {4 * se:.3f}")
                print(f"  {name}/{sched}/{pname}: kernel mean "
                      f"{float(tot.mean()):.4f} plain mean "
                      f"{float(tot_p.mean()):.4f} (4 SE {4 * se:.4f})",
                      flush=True)
                if pname == "start":
                    times[f"{name}/{sched}"] = (
                        cuda_ms(lambda: fmk.filter_megakernel(
                            km, 11, params, ys, z, **kw), 5),
                        cuda_ms(lambda: fmk.filter_megakernel_reference(
                            km, 12, params, ys, z, **kw), 1))
    phase(10, "megakernel-full", f"B={LB} N={N} T={ys.shape[0]}: " + "; ".join(
        f"{s} kernel {k:.4f} ms, plain {p:.4f} ms"
        for s, (k, p) in times.items()) + f" ({ident})")
    return times


def phase_pmmh_leverage(dev, ys_all, ident):
    ys = ys_all
    zs = svol_leverage.lagged_covariates(ys)
    model = svol_leverage.make_model(prior_bounds=lev_cli.PRIOR_BOUNDS)
    start = model.transform.unconstrain(torch.tensor(lev_cli.START))
    props_per_run = ITERS * LC * LR * N * ys.shape[0]   # init not timed
    # the counts start at 0 just before this path and are read just after
    sfk.svol_filter.launches = fmk.filter_megakernel.launches = 0
    rates = {}
    for g in (1, 8):
        before = fmk.filter_megakernel.launches
        pmmh = AdaptivePMMH(model, num_particles=N, num_replicates=LR,
                            t0=150, t1=10 ** 9,
                            batched_log_like=fmk.megakernel_log_like(
                                fmk.svol_leverage_kernel_model(), N, LR,
                                ess_threshold=0.5, gate_stride=g))
        state = pmmh.init(0, start, ys, zs=zs, num_chains=LC)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            res = pmmh.run_from(state, ITERS, ys, zs=zs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        count = fmk.filter_megakernel.launches - before
        require(count == ITERS + 1,
                f"g={g}: {count} kernel launches, want {ITERS + 1}")
        require(bool(torch.isfinite(state.log_like).all())
                and bool(torch.isfinite(res.log_likes).all()),
                f"g={g}: non-finite log-likelihoods")
        n_acc = int(res.accepted.sum())
        require(n_acc >= 1, f"g={g}: no proposal accepted")
        rates[g] = props_per_run / secs
        print(f"  g={g}: {count} launches, {n_acc} accepts, {secs:.4f} s, "
              f"{rates[g]:.6e} props/s on {ident}", flush=True)
    require(sfk.svol_filter.launches == 0, "the SVOL kernel ran on this path")
    launches = fmk.filter_megakernel.launches
    phase(11, "pmmh-leverage", f"C={LC} R={LR} N={N} T={ys.shape[0]} {ITERS} "
          f"iters: " + "; ".join(f"g{g} {r:.6e} props/s"
                                 for g, r in rates.items()) + f" ({ident})")
    return launches


def _run_cli(module, args, timeout):
    cmd = [sys.executable, "-m", module, *args]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    require(out.returncode == 0, f"{module} exited {out.returncode}:\n"
            f"{out.stderr[-4000:]}")
    return out


def _cli_launches(stderr):
    lines = [ln for ln in stderr.splitlines()
             if ln.startswith("filter_megakernel launches:")]
    require(len(lines) == 1, "the CLI did not report its kernel launches")
    return int(lines[0].split(":")[1])


def phase_posterior_leverage(tmp, ident):
    samples_csv = os.path.join(tmp, "leverage_samples.csv")
    lines = []
    for g, ref_name in POSTERIORS.items():
        out_json = os.path.join(tmp, f"leverage_g{g}.json")
        extra = ["--samples-out", samples_csv] if g == 1 else []
        res = _run_cli("ssme_tpu_torch.examples.estimate_svol_leverage",
                       ["--tuned", "--engine", "kernel", "--device", "cuda",
                        "--iters", "2000", "--burn", "500", "--gate-stride",
                        str(g), "--out", out_json, *extra], 900)
        launches = _cli_launches(res.stderr)
        require(launches == 2001, f"g={g}: {launches} kernel launches, "
                "want 2001 (init + 2000 iterations)")
        with open(out_json) as f:
            got = json.load(f)
        with open(os.path.join(ROOT, "data", ref_name)) as f:
            ref = json.load(f)
        parts = []
        for name in lev_cli.NAMES:
            a, b = got["posterior"][name], ref["posterior"][name]
            se = math.hypot(a["sd"] / math.sqrt(a["ess"]),
                            b["sd"] / math.sqrt(b["ess"]))
            d = abs(a["mean"] - b["mean"])
            require(d <= 4 * se, f"g={g} {name}: port mean {a['mean']:.5f} "
                    f"vs JAX {b['mean']:.5f}, diff {d:.5f} > 4 SE "
                    f"{4 * se:.5f}")
            parts.append(f"{name} {a['mean']:.5f} (JAX {b['mean']:.5f}, "
                         f"4 SE {4 * se:.5f}, ESS/s "
                         f"{a['ess'] / got['secs']:.3f})")
        line = (f"g{g}: accept {got['accept']:.4f}, {got['secs']:.3f} s, "
                + "; ".join(parts))
        print(f"  {line} on {ident}", flush=True)
        lines.append(line)
    phase(12, "posterior-leverage", "C=64 R=2 N=512 T=3084 2000 iters "
          "(500 burn-in), within 4 combined MC-SE of both JAX posteriors | "
          + " | ".join(lines))
    return samples_csv


def phase_swarm(dev, ys_all, samples_csv, ident):
    data = os.path.join(ROOT, "data", "spy_returns.csv")
    t0 = time.perf_counter()
    res = _run_cli("ssme_tpu_torch.examples.swarm_forecast",
                   [data, samples_csv, "--model", "svol_leverage", "--engine",
                    "kernel", "--device", "cuda"], 600)
    cli_secs = time.perf_counter() - t0
    ev_line = [ln for ln in res.stdout.splitlines()
               if ln.startswith("total conditional evidence:")]
    require(len(ev_line) == 1, "swarm CLI printed no evidence line")
    evidence = float(ev_line[0].split(":")[1].split()[0])
    require(math.isfinite(evidence), "non-finite swarm evidence")
    quants = [ln.split(":")[1].split() for ln in res.stderr.splitlines()
              if ln.strip().startswith("t+")]
    require(len(quants) == 10 and all(
        math.isfinite(float(v)) for q in quants for v in q),
        "swarm forecast quantiles missing or not finite")
    require(_cli_launches(res.stderr) >= 1, "the swarm CLI ran no kernel")

    ys = ys_all[:, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)
    km = fmk.svol_leverage_kernel_model()
    draws = ParamSampler(samples_csv, dim_param=4).samp(
        torch.Generator(device=dev).manual_seed(3), SWARM_M).contiguous()
    # the counts start at 0 just before this path and are read just after
    fmk.filter_megakernel.launches = 0
    ev = fmk.megakernel_swarm_evidence(km, 21, draws, ys, zs,
                                       num_particles=SWARM_N,
                                       return_cloud=True)
    launches = fmk.filter_megakernel.launches
    require(launches == 1, f"{launches} kernel launches for the swarm")
    obs = forecast_from_cloud(svol_leverage.make_model(), draws,
                              ev["final_cloud"], ev["final_log_weights"],
                              torch.Generator(device=dev).manual_seed(4), 10,
                              last_obs=ys[-1:])
    require(obs.shape == (SWARM_M, 10, SWARM_N, 1)
            and bool(torch.isfinite(obs).all()), "bad forecast paths")
    tot_k = ev["per_model_log_cond_likes"].sum(-1)
    tot_p = fmk.filter_megakernel_reference(km, 22, draws, ys, zs,
                                            num_particles=SWARM_N)[0]
    require(bool(torch.isfinite(tot_k).all())
            and bool(torch.isfinite(tot_p).all()), "NaN swarm totals")
    diff = (tot_k - tot_p).double()
    se = float(diff.std()) / math.sqrt(SWARM_M)
    require(abs(float(diff.mean())) <= 4 * se,
            f"swarm: kernel minus plain {float(diff.mean()):.4f} > 4 SE "
            f"{4 * se:.4f}")
    times = (cuda_ms(lambda: fmk.megakernel_swarm_evidence(
                 km, 21, draws, ys, zs, num_particles=SWARM_N,
                 return_cloud=True), 5),
             cuda_ms(lambda: fmk.filter_megakernel_reference(
                 km, 22, draws, ys, zs, num_particles=SWARM_N,
                 return_cloud=True), 1))
    phase(13, "swarm", f"CLI evidence {evidence:.2f}, 10 forecast steps "
          f"finite, {cli_secs:.3f} s wall; M={SWARM_M} N={SWARM_N}: kernel minus plain totals "
          f"{float(diff.mean()):.4f} (4 SE {4 * se:.4f}); kernel "
          f"{times[0]:.4f} ms, plain {times[1]:.4f} ms ({ident})")
    return launches, times


def _lw_instances(zs):
    return {"svol_leverage_lw": (lwm.svol_leverage_lw_kernel_model(), zs),
            "svol_t_lw": (lwm.svol_t_lw_kernel_model(), None)}


def phase_lw_sis(dev, ys_all):
    """SISR with a gate that never fires: identical bits, no selection."""
    ys = ys_all[:512, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)[:, 0].contiguous()
    kw = dict(num_filters=32, num_particles=LW_N, variant="sisr",
              ess_threshold=0.5 / LW_N)
    errs = {}
    for name, (km, z) in _lw_instances(zs).items():
        got = (k4.svol_leverage_lw(7, ys, **kw) if name == "svol_leverage_lw"
               else lwm.lw_megakernel(km, 7, ys, z, **kw))
        want = lwm.lw_megakernel_reference(km, 7, ys, z, **kw)
        err = float((got["log_likelihood"] - want["log_likelihood"])
                    .abs().max())
        # float32 throughout; fused multiply-adds and another reduction
        # order put a few ulp into each step, as in phases 5 and 9
        require(err <= 2e-3, f"{name}: totals differ by {err:.3e}")
        s_rows = km.num_state
        for rows, what in ((slice(0, s_rows), "state"),
                           (slice(s_rows + 1, None), "theta")):
            torch.testing.assert_close(got["cloud"][:, rows],
                                       want["cloud"][:, rows], rtol=0,
                                       atol=1e-3, msg=f"{name} {what} rows")
        # negligible particles carry log-weights far below -100: compare
        # the normalised weights
        torch.testing.assert_close(lwm.lw_cloud_weights(km, got["cloud"]),
                                   lwm.lw_cloud_weights(km, want["cloud"]),
                                   rtol=0, atol=1e-3)
        if km.functionals:
            torch.testing.assert_close(got["functional_paths"][0],
                                       want["functional_paths"][0], rtol=0,
                                       atol=1e-3)
        errs[name] = err
    # K4 is the K3 instance: the same launch, bit for bit, APF every step
    km, z = _lw_instances(zs)["svol_leverage_lw"]
    a = k4.svol_leverage_lw(9, ys, num_filters=32, num_particles=LW_N)
    b = lwm.lw_megakernel(km, 9, ys, z, num_filters=32, num_particles=LW_N)
    for key in ("log_cond_likes", "cloud"):
        require(torch.equal(a[key], b[key]), f"K4 != K3 instance: {key}")
    phase(14, "lw-sis", f"F=32 N={LW_N} T=512 SISR, gate never fires: totals"
          f" max abs err {errs['svol_leverage_lw']:.3e} (leverage, through "
          f"svol_leverage_lw), {errs['svol_t_lw']:.3e} (svol_t); state, "
          "theta, weights and the svol_t path within 1e-3; svol_leverage_lw "
          "== K3 instance bit for bit (APF, every step)")
    return errs


def phase_lw_full(dev, ys_all, ident):
    ys = ys_all[:, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)[:, 0].contiguous()
    inst = _lw_instances(zs)
    times, clouds = {}, {}
    for run, (name, kw) in LW_RUNS.items():
        km, z = inst[name]
        kw = dict(num_filters=LW_F, num_particles=LW_N, **kw)
        out = lwm.lw_megakernel(km, 11, ys, z, **kw)
        ref, plain_ms = event_ms(
            lambda: lwm.lw_megakernel_reference(km, 12, ys, z, **kw))
        tot, tot_p = out["log_likelihood"], ref["log_likelihood"]
        require(bool(torch.isfinite(tot).all())
                and bool(torch.isfinite(tot_p).all()), f"{run}: NaN totals")
        se = math.sqrt(float(tot.var()) / LW_F + float(tot_p.var()) / LW_F)
        d = abs(float(tot.mean()) - float(tot_p.mean()))
        require(d <= 4 * se, f"{run}: means differ by {d:.3f} > 4 SE "
                f"{4 * se:.3f}")
        print(f"  {run}: kernel mean {float(tot.mean()):.4f} sd "
              f"{float(tot.std()):.4f}, plain mean {float(tot_p.mean()):.4f}"
              f" sd {float(tot_p.std()):.4f} (4 SE {4 * se:.4f})",
              flush=True)
        times[run] = (cuda_ms(lambda: lwm.lw_megakernel(km, 11, ys, z, **kw),
                              5), plain_ms)
        clouds[run] = out["cloud"]
    k4_ms = cuda_ms(lambda: k4.svol_leverage_lw(11, ys, num_filters=LW_F,
                                                num_particles=LW_N), 5)
    fut = lwm.lw_kernel_sim_future_obs(
        inst["svol_leverage_lw"][0], svol_leverage.make_model(),
        clouds["apf"], torch.Generator(device=dev).manual_seed(5), 10,
        last_obs=ys[-1:])
    require(fut.shape == (LW_F, 10, LW_N, 1)
            and bool(torch.isfinite(fut).all()), "bad Liu-West forecast")
    phase(15, "lw-full", f"F={LW_F} N={LW_N} T={ys.shape[0]}: " + "; ".join(
        f"{r} kernel {k:.4f} ms, plain {p:.4f} ms"
        for r, (k, p) in times.items())
        + f"; svol_leverage_lw {k4_ms:.4f} ms; 10-step forecast finite "
        f"({ident})")
    return times, k4_ms


def _run_in_process(main, argv):
    """(stdout, stderr) of an entry point's ``main(argv)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


def _cli_params(stderr):
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^\s+(\w+)\s+= ([-+]?\d+\.\d+) \+-", stderr, re.M)}


def phase_lw_cli(ident):
    data = os.path.join(ROOT, "data", "spy_returns.csv")
    with open(os.path.join(ROOT, "data", "spy_liu_west_jax.json")) as f:
        ref = json.load(f)
    # the kernel engine: the counts start at 0 just before and are read
    # just after
    lwm.lw_megakernel.launches = k4.svol_leverage_lw.launches = 0
    t0 = time.perf_counter()
    out, err = _run_in_process(lw_cli.main, [
        data, "--engine", "kernel", "--filters", str(LW_F), "--particles",
        str(LW_N), "--device", "cuda"])
    secs = time.perf_counter() - t0
    launches = (lwm.lw_megakernel.launches, k4.svol_leverage_lw.launches)
    require(launches == (1, 1), f"{launches} kernel launches, want 1")
    m = re.search(r"log-likelihood: ([-\d.]+) \+- ([\d.]+) \((\d+) "
                  r"filters\)", out)
    require(m is not None, f"no log-likelihood line in {out!r}")
    mean, sd, f = float(m.group(1)), float(m.group(2)), int(m.group(3))
    # the kernel selects its first stage systematically: its yardstick is
    # the JAX filter with that selection
    jax_k = ref["systematic_first_stage"]
    se = math.hypot(sd / math.sqrt(f), jax_k["log_likelihood"]["sd"]
                    / math.sqrt(ref["filters"]))
    d = abs(mean - jax_k["log_likelihood"]["mean"])
    require(d <= 4 * se, f"kernel CLI mean {mean:.2f} vs JAX "
            f"{jax_k['log_likelihood']['mean']:.2f}: {d:.2f} > 4 SE "
            f"{4 * se:.2f}")
    params = _cli_params(err)
    for name in ("phi", "sigma", "rho"):
        want = jax_k["params"][name]
        require(abs(params[name] - want["mean"]) <= 2 * want["sd"],
                f"kernel CLI {name} {params[name]:.4f} outside JAX "
                f"{want['mean']:.4f} +- 2 x {want['sd']:.4f}")
    # the generic engine (multinomial first stage, as the JAX filter)
    t1 = time.perf_counter()
    gout, _ = _run_in_process(lw_cli.main, [
        data, "--engine", "generic", "--particles", str(LW_N), "--forecast",
        "10", "--device", "cuda"])
    gsecs = time.perf_counter() - t1
    g_ll = float(re.search(r"log-likelihood: ([-\d.]+)", gout).group(1))
    jax_g = ref["generic"]["log_likelihood"]
    require(math.isfinite(g_ll) and abs(g_ll - jax_g["mean"])
            <= 4 * jax_g["sd"], f"generic CLI log-likelihood {g_ll:.2f} vs "
            f"JAX {jax_g['mean']:.2f} +- 4 x {jax_g['sd']:.2f}")
    quants = [ln.split(":")[1].split() for ln in gout.splitlines()
              if ln.strip().startswith("t+")]
    require(len(quants) == 10 and all(math.isfinite(float(v))
                                      for q in quants for v in q),
            "generic CLI forecast quantiles missing or not finite")
    phase(16, "lw-cli", f"kernel engine F={f} N={LW_N}: {mean:.2f} +- "
          f"{sd:.2f} (JAX systematic first stage "
          f"{jax_k['log_likelihood']['mean']:.2f}, 4 SE {4 * se:.2f}), phi "
          f"{params['phi']:.4f} sigma {params['sigma']:.4f} rho "
          f"{params['rho']:.4f}, 1 launch, {secs:.3f} s; generic engine "
          f"{g_ll:.2f} (JAX {jax_g['mean']:.2f} +- {jax_g['sd']:.2f}), "
          f"10 forecast steps finite, {gsecs:.3f} s ({ident})")
    return launches[0]


def _families(dev):
    """The JAX yardsticks and the series of phases 17-18."""
    with open(FAMILIES_JSON) as f:
        ref = json.load(f)
    counts = fmk.poisson_obs_rows(torch.tensor(ref["poisson_ar_counts"]))
    fys = torch.tensor(ref["factor_svol_ys"], dtype=torch.float32)
    fparams = torch.tensor(ref["factor_svol_params"], dtype=torch.float32)
    return (ref, counts.to(dev).contiguous(), fys.to(dev).contiguous(),
            fparams)


def _factor5(dev):
    """Parameters and a T=500 series of the port's 5-asset factor SVOL,
    both from a seeded generator."""
    gen = torch.Generator().manual_seed(17)
    params = factor_svol.make_model(5, 2).sample_prior(gen)
    _, ys = factor_svol.simulate(gen, params, 500, 5, 2)
    return params, ys.to(dev).contiguous()


def phase_families_sis(dev, ys_all):
    ref, counts, fys, fparams = _families(dev)
    ys = ys_all[:512, 0].contiguous()
    half = LB // 2
    f5_params, f5_ys = _factor5(dev)
    cases = [
        ("svol_t", fmk.svol_t_kernel_model(), fmk.svol_t_param_rows(
            torch.tensor([SVOL_T_POINT] * half
                         + [(1.0, 0.9, 0.05, 4.0)] * half)).to(dev), ys),
        ("poisson_ar", fmk.poisson_ar_kernel_model(), torch.tensor(
            [POISSON_POINT] * half + [(0.8, 0.5, 0.4)] * half, device=dev),
         counts[:512].contiguous()),
        ("factor_svol_4", fmk.factor_svol_kernel_model(4),
         fparams.expand(LB, -1).contiguous().to(dev), fys),
        ("factor_svol_5", fmk.factor_svol_kernel_model(5),
         f5_params.expand(LB, -1).contiguous().to(dev), f5_ys)]
    errs = {}
    for name, km, rows, y in cases:
        for g in (1, 8):
            _compare_sis(name, km, rows, y, None, g, errs)
    # APF: identical bits; after the first selection the block scan and
    # torch.cumsum may pick different neighbours at a CDF boundary, so
    # only step 0 must agree to float tolerance, and most (row, step)
    # cells: a flip is rare (phase 4), and a row agrees until its first
    # flip
    ys_apf = ys_all[:APF_T, 0].contiguous()
    apf_cases = [
        ("svol", fmk.svol_kernel_model(),
         _svol_rows(SVOL_T_POINT[:3], APF_B).to(dev), ys_apf, None),
        ("svol_leverage", fmk.svol_leverage_kernel_model(),
         torch.tensor([LEV_POINTS["posterior"]] * APF_B, device=dev), ys_apf,
         svol_leverage.lagged_covariates(ys_apf)),
        ("svol_t", fmk.svol_t_kernel_model(), fmk.svol_t_param_rows(
            torch.tensor([SVOL_T_POINT] * APF_B)).to(dev), ys_apf, None),
        ("poisson_ar", fmk.poisson_ar_kernel_model(),
         torch.tensor([POISSON_POINT] * APF_B, device=dev),
         counts[:APF_T].contiguous(), None)]
    apf_errs = {}
    for name, km, rows, y, z in apf_cases:
        kw = dict(num_particles=N, mode="apf")
        tot, lcl, _ = fmk.filter_megakernel(km, 9, rows, y, z, **kw)
        tot_p, lcl_p, _ = fmk.filter_megakernel_reference(km, 9, rows, y, z,
                                                          **kw)
        torch.testing.assert_close(lcl[:, 0], lcl_p[:, 0], rtol=1e-5,
                                   atol=1e-4, msg=f"apf {name}: step 0")
        require(bool(torch.isfinite(tot).all())
                and bool(torch.isfinite(tot_p).all()),
                f"apf {name}: non-finite totals")
        agree = float(((lcl - lcl_p).abs() <= 1e-3).float().mean())
        require(agree >= 0.5, f"apf {name}: only {agree:.3f} of the lcl "
                "cells agree within 1e-3")
        apf_errs[name] = (float((lcl[:, 0] - lcl_p[:, 0]).abs().max()),
                          float((tot - tot_p).abs().max()), agree)
    phase(17, "megakernel-families-sis", f"B={LB} N={N} T=512 (factor T=500)"
          " strides 1, 8, gate never fires: totals max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; cloud and weights within 1e-3 | APF B={APF_B} T={APF_T}: "
          + ", ".join(f"{k} step 0 {a:.3e} totals {b:.3e} cells within "
                      f"1e-3 {c:.4f}" for k, (a, b, c) in apf_errs.items()))
    return max(errs.values())


def phase_families_full(dev, ys_all, ident):
    ref, counts, fys, fparams = _families(dev)
    ys = ys_all[:, 0].contiguous()
    f = ref["filters"]
    runs = {
        "svol_t": (fmk.svol_t_kernel_model(), fmk.svol_t_param_rows(
            torch.tensor([SVOL_T_POINT] * B)), ys, "bootstrap",
            [("JAX", ref["svol_t_bootstrap"])]),
        "svol/apf": (fmk.svol_kernel_model(), _svol_rows(SVOL_T_POINT[:3], B),
                     ys, "apf",
                     [("JAX systematic first stage",
                       ref["svol_apf"]["first_stage"]["systematic"])]),
        "poisson_ar": (fmk.poisson_ar_kernel_model(),
                       torch.tensor([POISSON_POINT] * LB), counts,
                       "bootstrap", [("JAX", ref["poisson_ar_bootstrap"])]),
        "poisson_ar/apf": (fmk.poisson_ar_kernel_model(),
                           torch.tensor([POISSON_POINT] * LB), counts, "apf",
                           [("JAX systematic first stage",
                             ref["poisson_ar_apf"]["first_stage"]
                             ["systematic"])]),
        # F2: the float32 kernel against the float64 ground truth
        "factor_svol_4": (fmk.factor_svol_kernel_model(4),
                          fparams.expand(FACTOR_B, -1), fys, "bootstrap",
                          [("JAX f32", ref["factor_svol_f32"]),
                           ("JAX f64 (F2)", ref["factor_svol_f64"])]),
    }
    results = {}
    for name, (km, rows, y, mode, yardsticks) in runs.items():
        rows = rows.contiguous().to(dev)
        b = rows.shape[0]
        kw = dict(num_particles=N, ess_threshold=1.0, mode=mode)
        before = fmk.filter_megakernel.launches
        tot = fmk.filter_megakernel(km, 11, rows, y, **kw)[0]
        launches = fmk.filter_megakernel.launches - before
        out_p, plain_ms = event_ms(lambda: fmk.filter_megakernel_reference(
            km, 12, rows, y, **kw))
        tot_p = out_p[0]
        require(bool(torch.isfinite(tot).all())
                and bool(torch.isfinite(tot_p).all()), f"{name}: NaN totals")
        mean, sd = float(tot.mean()), float(tot.std())
        se = math.sqrt(float(tot.var()) / b + float(tot_p.var()) / b)
        d = abs(mean - float(tot_p.mean()))
        require(d <= 4 * se, f"{name}: kernel {mean:.3f} vs plain "
                f"{float(tot_p.mean()):.3f}, {d:.3f} > 4 SE {4 * se:.3f}")
        line = (f"  {name}: kernel {mean:.4f} sd {sd:.4f}, plain "
                f"{float(tot_p.mean()):.4f} (4 SE {4 * se:.4f})")
        for label, jx in yardsticks:
            se_j = math.hypot(sd / math.sqrt(b), jx["sd"] / math.sqrt(f))
            d_j = abs(mean - jx["mean"])
            require(d_j <= 4 * se_j, f"{name}: kernel {mean:.3f} vs {label} "
                    f"{jx['mean']:.3f}, {d_j:.3f} > 4 SE {4 * se_j:.3f}")
            line += f"; {label} {jx['mean']:.4f} (4 SE {4 * se_j:.4f})"
        print(line, flush=True)
        ms = cuda_ms(lambda: fmk.filter_megakernel(km, 11, rows, y, **kw), 5)
        t_len, d_obs = y.shape[0], km.dim_obs
        bnd = bound(f"filter_megakernel/{name}", b, N, t_len, 4 * (t_len * d_obs + b * km.num_params)
                    + 16, 4 * b * (2 * t_len + 1))
        results[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                         "bound_by": bnd[1], "rows": b, "T": t_len,
                         "check_launches": launches, "mean": mean,
                         "sd": sd}
    phase(18, "families-full", f"N={N}: " + "; ".join(
        f"{k} B={v['rows']} T={v['T']} kernel {v['ms']:.4f} ms, plain "
        f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms"
        for k, v in results.items()) + f" ({ident})")
    return results


def phase_pmmh_svol_t(dev, ys_all, ident):
    ys = ys_all
    model = svol_t.make_model()
    props_per_run = ITERS * C * R * N * ys.shape[0]   # init not timed
    # the counts start at 0 just before this path and are read just after
    sfk.svol_filter.launches = fmk.filter_megakernel.launches = 0
    rates = {}
    for g in (1, 8):
        before = fmk.filter_megakernel.launches
        pmmh = AdaptivePMMH(model, num_particles=N, num_replicates=R,
                            t0=150, t1=1000,
                            batched_log_like=fmk.megakernel_log_like(
                                fmk.svol_t_kernel_model(), N, R,
                                constrain=fmk.svol_t_param_rows,
                                ess_threshold=0.5, gate_stride=g))
        state = pmmh.init(0, SVOL_T_START, ys, num_chains=C)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            res = pmmh.run_from(state, ITERS, ys)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        count = fmk.filter_megakernel.launches - before
        require(count == ITERS + 1,
                f"g={g}: {count} kernel launches, want {ITERS + 1}")
        require(bool(torch.isfinite(state.log_like).all())
                and bool(torch.isfinite(res.log_likes).all()),
                f"g={g}: non-finite log-likelihoods")
        n_acc = int(res.accepted.sum())
        require(n_acc >= 1, f"g={g}: no proposal accepted")
        rates[g] = props_per_run / secs
        print(f"  g={g}: {count} launches, {n_acc} accepts, init mean "
              f"log-likelihood {float(state.log_like.mean()):.4f}, "
              f"{secs:.4f} s, {rates[g]:.6e} props/s on {ident}", flush=True)
    require(sfk.svol_filter.launches == 0, "the SVOL kernel ran on this path")
    launches = fmk.filter_megakernel.launches
    phase(19, "pmmh-svol_t", f"C={C} R={R} N={N} T={ys.shape[0]} {ITERS} "
          f"iters: " + "; ".join(f"g{g} {r:.6e} props/s"
                                 for g, r in rates.items()) + f" ({ident})")
    return launches


def phase_large_n(dev, ys_all, ident):
    model = svol_t.make_model()
    km = fmk.svol_t_kernel_model()
    params = model.transform.constrain(torch.tensor(SVOL_T_START)).expand(
        2, 4).contiguous().to(dev)
    before = fmk.filter_megakernel.launches
    ll = fmk.megakernel_log_like(km, 2048, 2, constrain=fmk.svol_t_param_rows,
                                 model=model)
    out, ms = event_ms(lambda: ll(torch.Generator(device=dev).manual_seed(6),
                                  params, ys_all))
    require(out.shape == (2,) and bool(torch.isfinite(out).all()),
            f"large-N bridge: {out}")
    require(fmk.filter_megakernel.launches == before,
            "the large-N bridge launched the kernel")
    refused = False
    try:
        fmk.megakernel_log_like(km, 2048, 2)
    except ValueError:
        refused = True
    require(refused, "N=2048 without model= did not raise")
    phase(20, "large-n", f"N=2048 R=2 C=2 T={ys_all.shape[0]} through the "
          f"generic bank: {', '.join(f'{v:.4f}' for v in out.tolist())}, "
          f"{ms:.3f} ms, no kernel launch; without model= it raises "
          f"({ident})")


def main():
    ident = phase_device()
    dev = torch.device("cuda")
    phase_build()
    phase_philox(dev)
    phase_select(dev)
    ys = torch.as_tensor(read_data(os.path.join(ROOT, "data",
                                                "spy_returns.csv"),
                                   num_cols=1), device=dev)
    sis_err = phase_filter_sis(dev, ys)
    times, plain_start = phase_filter_full(dev, ys)
    launches, _ = phase_pmmh(dev, ys, ident, plain_start)
    phase_cli()
    k2_err = phase_megakernel_sis(dev, ys)
    k2_times = phase_megakernel_full(dev, ys, ident)
    k2_launches = phase_pmmh_leverage(dev, ys, ident)
    with tempfile.TemporaryDirectory() as tmp:
        samples_csv = phase_posterior_leverage(tmp, ident)
        swarm_launches, swarm_times = phase_swarm(dev, ys, samples_csv,
                                                  ident)
    lw_errs = phase_lw_sis(dev, ys)
    lw_times, k4_ms = phase_lw_full(dev, ys, ident)
    lw_launches = phase_lw_cli(ident)
    fam_err = phase_families_sis(dev, ys)
    fam = phase_families_full(dev, ys, ident)
    svol_t_launches = phase_pmmh_svol_t(dev, ys, ident)
    phase_large_n(dev, ys, ident)

    t_len = ys.shape[0]
    k_ms, p_ms = times["adaptive"]
    k2_ms, k2_plain = k2_times["svol_leverage/tuned"]
    lw_ms, lw_plain = lw_times["apf"]
    # bytes: inputs read once (series, covariates, parameter rows, seed),
    # outputs written once (lcl, means or paths, totals, cloud)
    k1_bound = bound("svol_filter", B, N, t_len, 4 * t_len + 12 * B + 16,
                     4 * B * (2 * t_len + 1))
    k2_bound = bound("filter_megakernel", LB, N, t_len,
                     8 * t_len + 16 * LB + 16, 4 * LB * (2 * t_len + 1))
    lw_bound = bound("lw_megakernel", LW_F, LW_N, t_len, 8 * t_len + 16,
                     4 * LW_F * (t_len + 6 * LW_N))
    print(json.dumps({"kernels": [{
        "name": "svol_filter",
        "route": "cuda",
        "source": "ssme_tpu_torch/csrc/svol_filter.cu",
        "replaces": "ssme_tpu/ops/svol_filter_kernel.py:317",
        "launches": launches,
        "max_abs_err": sis_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
        "ms_parity": times["parity"][0],
        "plain_ms_parity": times["parity"][1],
    }, {
        "name": "filter_megakernel",
        "route": "cuda",
        "source": "ssme_tpu_torch/csrc/filter_megakernel.cu",
        "replaces": "ssme_tpu/ops/filter_megakernel.py:466",
        "launches": k2_launches + swarm_launches + svol_t_launches,
        "max_abs_err": max(k2_err, fam_err),
        "ms": k2_ms,
        "plain_ms": k2_plain,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None,
        "per_schedule": {s: {"ms": k, "plain_ms": p}
                         for s, (k, p) in k2_times.items()},
        "swarm_ms": swarm_times[0],
        "swarm_plain_ms": swarm_times[1],
        "per_instance": {k: v for k, v in fam.items() if "/apf" not in k},
        "apf": {k: v for k, v in fam.items() if "/apf" in k},
        "main_path_launches": {"svol_leverage": k2_launches + swarm_launches,
                               "svol_t": svol_t_launches},
    }, {
        "name": "lw_megakernel",
        "route": "cuda",
        "source": "ssme_tpu_torch/csrc/lw_megakernel.cu",
        "replaces": "ssme_tpu/ops/liu_west_megakernel.py:500",
        "launches": lw_launches,
        "max_abs_err": max(lw_errs.values()),
        "ms": lw_ms,
        "plain_ms": lw_plain,
        "bound_ms": lw_bound[0],
        "bound_by": lw_bound[1],
        "library_ms": None,
        "per_schedule": {r: {"ms": k, "plain_ms": p}
                         for r, (k, p) in lw_times.items()},
    }, {
        "name": "svol_leverage_lw",
        "route": "cuda",
        "instance_of": "lw_megakernel (its svol_leverage_lw instance)",
        "source": "ssme_tpu_torch/csrc/lw_megakernel.cu",
        "replaces": "ssme_tpu/ops/svol_leverage_lw_kernel.py:331",
        "launches": lw_launches,
        "max_abs_err": lw_errs["svol_leverage_lw"],
        "ms": k4_ms,
        "plain_ms": lw_plain,
        "bound_ms": lw_bound[0],
        "bound_by": lw_bound[1],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
