#!/usr/bin/env python
"""The Liu-West kernel (K3) under the roll resamplers against its plain
version at full length: F=64 filters x N=512 particles of SVOL with
leverage over all of ``data/spy_returns.csv`` (T=3084), APF with a
resample every step, as ``chip_smoke.py`` phase 22 runs it.

For each of ``rejection`` and ``metropolis`` (``metropolis_sweeps_for(0.5,
T, 0.5)`` sweeps) it runs the kernel once (seed 11) and the plain PyTorch
version once (seed 12) on the card, and holds the two mean
log-likelihoods within 4 combined standard errors (the filters are
independent, so SE = sqrt(var_k / F + var_p / F)).  Phase 22 holds the two
only at T=256: the plain version takes minutes at full length.

    python scripts/k3_roll_fullsize.py [--device cuda|cpu] [--t-len T]
        [--filters F] [--particles N]

Imports only the port.  Prints one line per resampler and, last, one JSON
object with both results, their times, and the card's name and power
limit; exits 1 when a check fails.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ssme_tpu_torch.io import read_data  # noqa: E402
from ssme_tpu_torch.models.svol_leverage import lagged_covariates  # noqa
from ssme_tpu_torch.ops import _select  # noqa: E402
from ssme_tpu_torch.ops import liu_west_megakernel as lwm  # noqa: E402


def timed(fn, dev):
    """(result, seconds) of one call, synchronised on a card."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--t-len", type=int, default=0, help="0: all of SPY")
    ap.add_argument("--filters", type=int, default=64)
    ap.add_argument("--particles", type=int, default=512)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    dev = torch.device(args.device)
    ys = torch.as_tensor(read_data(os.path.join(ROOT, "data",
                                                "spy_returns.csv"),
                                   num_cols=1))[:, 0]
    if args.t_len:
        ys = ys[:args.t_len]
    ys = ys.contiguous().to(dev)
    zs = lagged_covariates(ys)[:, 0].contiguous()
    t_len, f = int(ys.shape[0]), args.filters
    sweeps = _select.metropolis_sweeps_for(0.5, t_len, 0.5)
    km = lwm.svol_leverage_lw_kernel_model()
    out = {"T": t_len, "filters": f, "particles": args.particles,
           "variant": "apf", "resample_every": 1, "metropolis_sweeps": sweeps,
           "device": args.device, "runs": {}}
    if dev.type == "cuda":
        from ssme_tpu_torch.bench import gpu_identity
        out["card"] = gpu_identity()
    ok = True
    for r in ("rejection", "metropolis"):
        kw = dict(num_filters=f, num_particles=args.particles, resampler=r,
                  metropolis_iters=sweeps)
        kern, k_s = timed(lambda: lwm.lw_megakernel(km, 11, ys, zs, **kw)[
            "log_likelihood"], dev)
        plain, p_s = timed(lambda: lwm.lw_megakernel_reference(
            km, 12, ys, zs, **kw)["log_likelihood"], dev)
        finite = bool(torch.isfinite(kern).all() and
                      torch.isfinite(plain).all())
        mk, mp = float(kern.mean()), float(plain.mean())
        se = math.sqrt(float(kern.var()) / f + float(plain.var()) / f)
        passed = finite and abs(mk - mp) <= 4 * se
        ok &= passed
        out["runs"][r] = {"kernel_mean": mk, "kernel_sd": float(kern.std()),
                          "plain_mean": mp, "plain_sd": float(plain.std()),
                          "diff": mk - mp, "four_se": 4 * se,
                          "kernel_s": k_s, "plain_s": p_s, "pass": passed}
        print(f"{r}: kernel {mk:.4f} sd {float(kern.std()):.4f} "
              f"({k_s:.3f} s), plain {mp:.4f} sd {float(plain.std()):.4f} "
              f"({p_s:.3f} s), diff {mk - mp:.4f}, 4 SE {4 * se:.4f}: "
              f"{'ok' if passed else 'FAIL'}", flush=True)
    out["pass"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
