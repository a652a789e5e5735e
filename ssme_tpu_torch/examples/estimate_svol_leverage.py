#!/usr/bin/env python
"""PMMH parameter estimation for SVOL with leverage on SPY returns
(PyTorch port of ``examples/estimate_svol_leverage.py``).

Model (``models/svol_leverage.py``): x' = mu + phi (x - mu) + z rho sigma
e^{-x/2} + sigma sqrt(1-rho^2) eps, y ~ N(0, e^x), covariate z = the
lagged observation.  Parameters (phi, mu, sigma, rho) with uniform
priors over a wide box; the chains start at (0.9, 0.0, 0.3, -0.3).

    python -m ssme_tpu_torch.examples.estimate_svol_leverage \\
        [--tuned] [--iters 2000] [--burn 500] [--gate-stride 1|8] \\
        [--device cuda|cpu] [--engine kernel|generic] [--out JSON] \\
        [--samples-out CSV]

``--engine kernel`` evaluates all chains x replicates of an MH iteration
in one launch of the generic filter kernel's leverage instance
(``ops/filter_megakernel.py``), with ESS-adaptive resampling (ESS < N/2)
and the check stride ``--gate-stride``; it is the default on ``cuda``.
``--engine generic`` runs the PyTorch filter bank (every-step
resampling).  ``--device`` defaults to ``cuda`` and raises without a
card; the CPU runs only on ``--device cpu``.  ``--tuned`` is
the measured preset: C >= 64 chains, R = 2 replicates, adaptation that
never freezes and a warm restart of it after burn-in.

Prints one JSON object (the JAX CLI's keys) and writes it to ``--out``;
``--samples-out`` writes the post-burn-in constrained samples, one
``phi,mu,sigma,rho`` row per draw, for ``swarm_forecast``.
"""

import argparse
import json
import os
import sys
import time

# allow running by path without installation: put the repo root first
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

START = (0.9, 0.0, 0.3, -0.3)       # (phi, mu, sigma, rho)
# the model's default box is the reference fixture's tiny one; estimation
# on real returns needs honest support (SPY daily log-returns x100)
PRIOR_BOUNDS = (
    (0.5, 0.999),    # phi: persistent vol
    (-2.0, 2.0),     # mu: mean log-variance
    (0.05, 1.0),     # sigma: vol-of-vol
    (-0.95, 0.0),    # rho: leverage
)
NAMES = ["phi", "mu", "sigma", "rho"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--datafile", default=None)
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--chains", type=int, default=16)
    p.add_argument("--particles", type=int, default=512)
    p.add_argument("--replicates", type=int, default=2)
    p.add_argument("--t-len", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--engine", choices=["kernel", "generic"], default=None,
                   help="kernel: all chains x replicates per MH iteration "
                        "in one filter-kernel launch (default on cuda); "
                        "generic: the PyTorch filter bank")
    p.add_argument("--out", default=None)
    p.add_argument("--samples-out", default=None,
                   help="CSV of the post-burn-in constrained samples")
    p.add_argument("--burn", type=int, default=500)
    p.add_argument("--gate-stride", type=int, default=1,
                   help="kernel engine: LSE/ESS check stride")
    p.add_argument("--tuned", action="store_true",
                   help="C >= 64 chains, R = 2 replicates, and a warm "
                        "restart of the adaptation after burn-in")
    args = p.parse_args(argv)

    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    engine = args.engine or ("kernel" if device == "cuda" else "generic")
    if engine == "generic" and args.gate_stride != 1:
        p.error("--gate-stride applies to the kernel engine only")
    if args.tuned:
        args.chains = max(args.chains, 64)
        args.replicates = 2

    from ssme_tpu_torch.diagnostics import summarize
    from ssme_tpu_torch.inference import AdaptivePMMH
    from ssme_tpu_torch.io import read_data
    from ssme_tpu_torch.models import svol_leverage

    data = args.datafile or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "data", "spy_returns.csv")
    ys = torch.as_tensor(read_data(data, num_cols=1), device=device)
    if args.t_len:
        ys = ys[: args.t_len]
    zs = svol_leverage.lagged_covariates(ys)

    model = svol_leverage.make_model(prior_bounds=PRIOR_BOUNDS)
    batched = None
    if engine == "kernel":
        from ssme_tpu_torch.ops.filter_megakernel import (
            megakernel_log_like, svol_leverage_kernel_model)
        batched = megakernel_log_like(
            svol_leverage_kernel_model(), args.particles, args.replicates,
            ess_threshold=0.5, gate_stride=args.gate_stride)

    pmmh = AdaptivePMMH(model, num_particles=args.particles,
                        num_replicates=args.replicates, t0=150, t1=10**9,
                        batched_log_like=batched)
    start = model.transform.unconstrain(torch.tensor(START))

    state = pmmh.init(args.seed, start, ys, zs=zs, num_chains=args.chains)
    burn = min(args.burn, args.iters)
    t0 = time.perf_counter()
    res_burn = pmmh.run_from(state, burn, ys, zs=zs)
    state = res_burn.final_state
    print(f"burn-in {burn} accept={float(state.accept_ma.mean()):.3f}",
          file=sys.stderr, flush=True)
    if args.tuned:
        # warm restart: drop the cold-start trajectory from the Haario
        # moments; keeps positions and the proposal covariance
        state = AdaptivePMMH.reset_adaptation(state)
    chunks = [res_burn.samples.cpu().numpy()]
    if args.iters > burn:
        res = pmmh.run_from(state, args.iters - burn, ys, zs=zs)
        state = res.final_state
        chunks.append(res.samples.cpu().numpy())
    secs = time.perf_counter() - t0
    print(f"iter {args.iters}/{args.iters} accept="
          f"{float(state.accept_ma.mean()):.3f}",
          file=sys.stderr, flush=True)
    if engine == "kernel":
        from ssme_tpu_torch.ops import _cuda
        print("filter_megakernel launches: "
              f"{_cuda.launches('ssme_filter_megakernel')}",
              file=sys.stderr, flush=True)
    samples = np.concatenate(chunks)[: args.iters]

    kept = samples[max(burn, args.iters // 4):]
    out = {
        "engine": engine, "iters": args.iters,
        "chains": args.chains, "N": args.particles,
        "R": args.replicates, "T": int(ys.shape[0]), "secs": secs,
        "tuned": bool(args.tuned),
        "gate_stride": args.gate_stride,
        "accept": float(state.accept_ma.mean()),
        "posterior": summarize(kept, names=NAMES),
    }
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if args.samples_out:
        np.savetxt(args.samples_out, kept.reshape(-1, len(NAMES)),
                   delimiter=",", fmt="%.9g")


if __name__ == "__main__":
    main()
