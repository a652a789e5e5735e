#!/usr/bin/env python
"""Joint online state and parameter estimation of two-factor SVOL over a
panel of returns: a bank of Liu-West APF filters, each carrying the 21
parameters of every particle.

    python -m ssme_tpu_torch.examples.liu_west_factor_svol [DATAFILE] \\
        [--device cuda|cpu] [--filters F] [--particles N] [--delta D] \\
        [--variant apf|sisr] [--t-len T] [--seed S] [--paths-out CSV]

DATAFILE is a (T, n) CSV of returns, one row a day (default: the 5-asset
panel ``benchmark/data/factor_svol_5_returns.csv``).  The model is
``models/factor_svol.py`` with k = 2 factors as the Liu-West kernel model
``ops/liu_west_megakernel.py::factor_svol_lw_kernel_model`` and its
uniform prior box.  On ``cuda`` at n = 5 the bank is one launch of K3's
``factor_svol_5_lw`` instance (``--particles`` a multiple of 32 up to
1024); on ``cpu`` (any n, given the box for it) the plain version runs
the same steps.

Prints the evidence (the mean and sd of the filters' log-likelihoods),
the filtered factor log-volatilities (the filters' mean path, its last
steps) and the final parameter means (the weighted clouds of all filters
pooled).  ``--paths-out`` writes the mean paths (T rows, x1 and x2).
"""

import argparse
import os
import sys

# allow running by path without installation: put the repo root first
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

DEFAULT_DATA = os.path.join(ROOT, "benchmark", "data",
                            "factor_svol_5_returns.csv")


def param_names(n_assets):
    return (["phi1", "phi2", "mu1", "mu2", "sigma1", "sigma2"]
            + [f"l{i + 1}{j + 1}" for i in range(n_assets) for j in range(2)]
            + [f"d{i + 1}" for i in range(n_assets)])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("datafile", nargs="?", default=DEFAULT_DATA)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--filters", type=int, default=64)
    p.add_argument("--particles", type=int, default=1024)
    p.add_argument("--delta", type=float, default=0.99)
    p.add_argument("--variant", choices=["apf", "sisr"], default="apf")
    p.add_argument("--t-len", type=int, default=None,
                   help="filter the first T rows only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--paths-out", default=None)
    args = p.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    from ssme_tpu_torch.ops import _cuda
    from ssme_tpu_torch.ops import liu_west_megakernel as lwm

    ys = np.loadtxt(args.datafile, delimiter=",", ndmin=2)
    if args.t_len:
        ys = ys[:args.t_len]
    ys = torch.as_tensor(ys, dtype=torch.float32,
                         device=args.device).contiguous()
    n_assets = ys.shape[1]
    km = lwm.factor_svol_lw_kernel_model(n_assets)
    out = lwm.lw_megakernel(km, args.seed, ys, None,
                            num_filters=args.filters,
                            num_particles=args.particles, delta=args.delta,
                            variant=args.variant)
    ll = out["log_likelihood"].double().cpu().numpy()
    print(f"evidence: log-likelihood {ll.mean():.3f} +- {ll.std():.3f} "
          f"over {args.filters} filters of {args.particles} particles, "
          f"T = {ys.shape[0]} x {n_assets}")
    paths = torch.stack([fp.double().mean(0)
                         for fp in out["functional_paths"]], -1).cpu()
    print("filtered factor log-volatilities (mean over filters), last "
          "steps:")
    for t in range(max(0, paths.shape[0] - 5), paths.shape[0]):
        print(f"  t={t}: x1 {float(paths[t, 0]):+.4f} "
              f"x2 {float(paths[t, 1]):+.4f}")
    w = lwm.lw_cloud_weights(km, out["cloud"]).double()
    cp = lwm.lw_cloud_params(km, out["cloud"]).double()
    means = (cp * w[..., None]).sum(1).mean(0).cpu().numpy()
    print("final parameter means (weighted clouds, filters pooled):")
    for name, v in zip(param_names(n_assets), means):
        print(f"  {name:6s} = {v:+.4f}")
    if args.device == "cuda":
        print("lw_megakernel launches: " + str(_cuda.launches(
            "ssme_lw_megakernel", lwm.launch_key(km.cuda_instance,
                                                 "single"))),
              file=sys.stderr)
    if args.paths_out:
        np.savetxt(args.paths_out, paths.numpy(), delimiter=",",
                   header="x1,x2", comments="")


if __name__ == "__main__":
    main()
