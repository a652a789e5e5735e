#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``ssme_tpu_torch/csrc`` and drives its
main path, adaptive PMMH on univariate SVOL over the full SPY series at
the flagship size (C=64 chains x R=4 replicates x N=512 particles,
T=3084), through the port's own entry points.  Phases, one line each:

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
8. cli      ``ssme_tpu_torch.examples.estimate_univ_svol`` on the card.

Any failure exits non-zero.  The line before the last is a JSON object
describing the kernel; the last is the ``{"ok": true, ...}`` contract.
Imports nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from ssme_tpu_torch.bench import gpu_identity  # noqa: E402
from ssme_tpu_torch.inference import AdaptivePMMH  # noqa: E402
from ssme_tpu_torch.io import read_data  # noqa: E402
from ssme_tpu_torch.models import svol  # noqa: E402
from ssme_tpu_torch.ops import _cuda, _prng, _select  # noqa: E402
from ssme_tpu_torch.ops import svol_filter_kernel as sfk  # noqa: E402
from ssme_tpu_torch.utils import logmeanexp  # noqa: E402

C, R, N = 64, 4, 512
B = C * R
ITERS = 30
SCHEDULES = {"parity": (1.0, 1), "adaptive": (0.5, 8)}
START = torch.tensor(svol.START_TRANS_THETA)


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
    k_ms, p_ms = times["adaptive"]
    print(json.dumps({"kernels": [{
        "name": "svol_filter",
        "route": "cuda",
        "source": "ssme_tpu_torch/csrc/svol_filter.cu",
        "replaces": "ssme_tpu/ops/svol_filter_kernel.py:317",
        "launches": launches,
        "max_abs_err": sis_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "ms_parity": times["parity"][0],
        "plain_ms_parity": times["parity"][1],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
