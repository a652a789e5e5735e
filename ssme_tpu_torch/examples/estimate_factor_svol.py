#!/usr/bin/env python
"""PMMH parameter estimation for two-factor stochastic volatility on a
panel of five return series.

Model (``models/factor_svol.py``; Pitt & Shephard 1999): k = 2 AR(1)
log-volatility factors x_j' = mu_j + phi_j (x_j - mu_j) + sigma_j eps,
y ~ N(0, L diag(e^x) L' + diag(d)) over n = 5 assets; 21 parameters
(phi, mu, sigma, vec L, d) under the model's prior.  Every chain starts
at START, the parameters the committed panel was simulated from
(``benchmark/data/make_factor_svol_5.py``), so that every chain stays
in one of the posterior's modes (L is unrestricted: flipping a column's
sign or swapping the factors gives the same likelihood).

    python -m ssme_tpu_torch.examples.estimate_factor_svol \\
        [--iters 3000] [--burn 1000] [--chains 64] [--particles 1024] \\
        [--replicates 4] [--datafile CSV] [--device cuda|cpu] \\
        [--samples-out CSV]

Each MH iteration evaluates all chains x replicates in one launch of the
generic filter kernel's ``factor_svol_5`` instance
(``ops/filter_megakernel.py``), resampling every step (the reference
estimator's schedule).  ``--device`` defaults to ``cuda`` and raises
without a card; the CPU (the kernel's plain version) runs only on
``--device cpu``.  The Haario recursion (t0 = 150, t1 = 1000) takes
EPS = 1e-4 for its floor eps I, and the first proposal covariance is
that floor, 2.4^2 / d x EPS I: in the transformed space this posterior's
variances are 1e-3 to 1e-5 (loadings, log d, the persistences), so the
univariate examples' eps = 0.01 and C0 = 0.15 I give proposals tens of
nats down and an accept rate near 0.2% at d = 21.

Prints one JSON object (the posterior summary, the accept rate, the
kernel's launches, the seconds of the start's evaluation, which builds
the kernels on a checkout's first run, and of the iterations) and, with ``--samples-out``, writes the post-burn-in
constrained samples, one row of 21 per draw.
"""

import argparse
import json
import os
import sys
import time

# allow running by path without installation: put the repo root first
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

N_ASSETS, K_FACTORS = 5, 2
# phi (2), mu (2), sigma (2), vec L (5 x 2, row-major), d (5)
START = (0.98, 0.95, -0.5, -1.5, 0.15, 0.25,
         0.9, 0.0, 0.8, 0.3, 0.7, 0.5, 0.6, -0.4, 0.5, 0.6,
         0.30, 0.25, 0.35, 0.40, 0.30)
NAMES = (["phi1", "phi2", "mu1", "mu2", "sigma1", "sigma2"]
         + [f"l{i + 1}{j + 1}" for i in range(N_ASSETS)
            for j in range(K_FACTORS)]
         + [f"d{i + 1}" for i in range(N_ASSETS)])
DATA = os.path.join(ROOT, "benchmark", "data", "factor_svol_5_returns.csv")
EPS = 1e-4


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--datafile", default=DATA,
                   help="headerless CSV, one row of 5 returns a step")
    p.add_argument("--iters", type=int, default=3000)
    p.add_argument("--burn", type=int, default=1000)
    p.add_argument("--chains", type=int, default=64)
    p.add_argument("--particles", type=int, default=1024)
    p.add_argument("--replicates", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--samples-out", default=None,
                   help="CSV of the post-burn-in constrained samples")
    args = p.parse_args(argv)

    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    from ssme_tpu_torch.diagnostics import summarize
    from ssme_tpu_torch.inference import AdaptivePMMH
    from ssme_tpu_torch.io import read_data
    from ssme_tpu_torch.models import factor_svol
    from ssme_tpu_torch.ops import _cuda
    from ssme_tpu_torch.ops.filter_megakernel import (
        factor_svol_kernel_model, megakernel_log_like)

    ys = torch.as_tensor(read_data(args.datafile, num_cols=N_ASSETS),
                         device=device).contiguous()
    model = factor_svol.make_model(N_ASSETS, K_FACTORS)
    batched = megakernel_log_like(factor_svol_kernel_model(N_ASSETS),
                                  args.particles, args.replicates,
                                  ess_threshold=1.0, gate_stride=1)
    pmmh = AdaptivePMMH(model, num_particles=args.particles,
                        num_replicates=args.replicates, t0=150, t1=1000,
                        eps=EPS, batched_log_like=batched)
    d = model.dim_param
    c0 = 2.4 * 2.4 / d * EPS * torch.eye(d)
    start = model.transform.unconstrain(torch.tensor(START))

    # the first launch builds or loads the kernels: timed apart from the run
    t0 = time.perf_counter()
    state = pmmh.init(args.seed, start, ys, c0=c0, num_chains=args.chains)
    init_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = pmmh.run_from(state, args.iters, ys)
    samples = res.samples.cpu().numpy()
    secs = time.perf_counter() - t0
    state = res.final_state
    kept = samples[min(args.burn, args.iters):]
    out = {
        "device": (torch.cuda.get_device_name(0) if device == "cuda"
                   else "cpu"),
        "iters": args.iters, "burn": args.burn, "chains": args.chains,
        "N": args.particles, "R": args.replicates, "T": int(ys.shape[0]),
        "init_secs": init_secs, "secs": secs,
        "accept": float(state.accept_ma.mean()),
        "launches": _cuda.launches("ssme_filter_megakernel"),
        "posterior": summarize(kept, names=NAMES),
    }
    print(json.dumps(out, indent=1))
    if args.samples_out:
        np.savetxt(args.samples_out, kept.reshape(-1, d), delimiter=",",
                   fmt="%.9g")


if __name__ == "__main__":
    main()
