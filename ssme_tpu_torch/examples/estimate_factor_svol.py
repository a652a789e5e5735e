#!/usr/bin/env python
"""PMMH parameter estimation for two-factor stochastic volatility on a
panel of five return series, or, with ``--idio-sv``, for the model as
published (stochastic idiosyncratic variances) on a panel of ten.

Model (``models/factor_svol.py``; Pitt & Shephard 1999): k = 2 AR(1)
log-volatility factors x_j' = mu_j + phi_j (x_j - mu_j) + sigma_j eps,
y ~ N(0, L diag(e^x) L' + diag(d)) over n = 5 assets; 21 parameters
(phi, mu, sigma, vec L, d) under the model's prior.  Every chain starts
at START, the parameters the committed panel was simulated from
(``benchmark/data/make_factor_svol_5.py``), so that every chain stays
in one of the posterior's modes (L is unrestricted: flipping a column's
sign or swapping the factors gives the same likelihood).

    python -m ssme_tpu_torch.examples.estimate_factor_svol \\
        [--idio-sv] \\
        [--iters 3000] [--burn 1000] [--chains 64] [--particles 1024] \\
        [--replicates 4] [--datafile CSV] [--device cuda|cpu] \\
        [--samples-out CSV]

``--idio-sv`` (``models/factor_svol.py::make_sv_model``): every asset's
idiosyncratic log-variance u_i is an AR(1) of its own, y ~ N(0, L
diag(e^f) L' + diag(e^u)), so the state has 12 leaves and there are 56
parameters (phi, mu, sigma of the 12 leaves, vec L 10 x 2); its chains
start at START_SV, the parameters the committed 10-asset panel was
simulated from (``benchmark/data/make_factor_svol_sv_10.py``), and each
iteration is one launch of K2's ``factor_svol_sv_10`` instance.

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
constrained samples, one row of 21 (56 with ``--idio-sv``) per draw.
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
# --idio-sv: phi, mu, sigma (f1, f2, u1 .. u10 each), vec L (10 x 2,
# row-major)
N_ASSETS_SV = 10
START_SV = (0.98, 0.95, 0.97, 0.95, 0.96, 0.98, 0.94, 0.97, 0.95, 0.96,
            0.93, 0.97,
            -0.5, -1.5, -1.2, -1.4, -1.05, -0.92, -1.2, -1.27, -1.11,
            -0.97, -1.31, -1.14,
            0.15, 0.25, 0.15, 0.20, 0.12, 0.10, 0.22, 0.18, 0.14, 0.16,
            0.20, 0.12,
            0.9, 0.0, 0.8, 0.3, 0.7, 0.5, 0.6, -0.4, 0.5, 0.6,
            0.85, 0.2, 0.75, -0.3, 0.65, 0.45, 0.55, -0.5, 0.4, 0.7)
LEAVES_SV = ["f1", "f2"] + [f"u{i + 1}" for i in range(N_ASSETS_SV)]
NAMES_SV = ([f"phi_{h}" for h in LEAVES_SV] + [f"mu_{h}" for h in LEAVES_SV]
            + [f"sigma_{h}" for h in LEAVES_SV]
            + [f"l{i + 1}{j + 1}" for i in range(N_ASSETS_SV)
               for j in range(K_FACTORS)])
DATA_SV = os.path.join(ROOT, "benchmark", "data",
                       "factor_svol_sv_10_returns.csv")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--idio-sv", action="store_true",
                   help="the model as published: stochastic idiosyncratic "
                        "variances (K2's factor_svol_sv_10 instance)")
    p.add_argument("--datafile", default=None,
                   help="headerless CSV, one row of returns a step (default: "
                        "the committed panel of the model)")
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
        factor_svol_kernel_model, factor_svol_sv_kernel_model,
        megakernel_log_like)

    n_assets = N_ASSETS_SV if args.idio_sv else N_ASSETS
    if args.idio_sv:
        model = factor_svol.make_sv_model(n_assets, K_FACTORS)
        kmodel = factor_svol_sv_kernel_model(n_assets)
        start_row, names, data = START_SV, NAMES_SV, DATA_SV
    else:
        model = factor_svol.make_model(n_assets, K_FACTORS)
        kmodel = factor_svol_kernel_model(n_assets)
        start_row, names, data = START, NAMES, DATA
    ys = torch.as_tensor(read_data(args.datafile or data, num_cols=n_assets),
                         device=device).contiguous()
    batched = megakernel_log_like(kmodel, args.particles, args.replicates,
                                  ess_threshold=1.0, gate_stride=1)
    pmmh = AdaptivePMMH(model, num_particles=args.particles,
                        num_replicates=args.replicates, t0=150, t1=1000,
                        eps=EPS, batched_log_like=batched)
    d = model.dim_param
    c0 = 2.4 * 2.4 / d * EPS * torch.eye(d)
    start = model.transform.unconstrain(torch.tensor(start_row))

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
        "model": kmodel.cuda_instance,
        "posterior": summarize(kept, names=names),
    }
    print(json.dumps(out, indent=1))
    if args.samples_out:
        np.savetxt(args.samples_out, kept.reshape(-1, d), delimiter=",",
                   fmt="%.9g")


if __name__ == "__main__":
    main()
