#!/usr/bin/env python
"""Joint online state + parameter estimation: Liu-West on SVOL with
leverage (PyTorch port of ``examples/liu_west_leverage.py``).

    python -m ssme_tpu_torch.examples.liu_west_leverage <datafile> \\
        [--engine kernel|generic] [--device cuda|cpu] [--filters F] \\
        [--particles N] [--delta D] [--variant apf|sisr] [--forecast K]

The model is ``models/svol_leverage.py`` with its default prior box; the
covariates are the lagged observations.  Prints the log-likelihood, the
final parameter particles (mean +- sd, on stderr) and, for the generic
engine, optionally simulated future observations.

``--engine kernel`` (the default on ``cuda``) runs ``--filters``
independent filters in one launch of the Liu-West kernel
(``ops/svol_leverage_lw_kernel.py``; ``--particles`` a multiple of 32 up
to 1024, default 512) and prints the kernel's launch count on stderr.
``--engine generic`` runs one PyTorch ``LiuWestFilter`` (default 2048
particles).  ``--device`` defaults to ``cuda`` and raises without a card;
the CPU runs only on ``--device cpu``.
"""

import argparse
import os
import sys

# allow running by path without installation: put the repo root first
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

NAMES = ["phi", "mu", "sigma", "rho"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("datafile")
    p.add_argument("--particles", type=int, default=None,
                   help="default: 512 (kernel), 2048 (generic)")
    p.add_argument("--delta", type=float, default=0.99)
    p.add_argument("--variant", choices=["apf", "sisr"], default="apf")
    p.add_argument("--engine", choices=["kernel", "generic"], default=None,
                   help="kernel: all filters in one Liu-West kernel launch "
                        "(default on cuda); generic: the PyTorch "
                        "LiuWestFilter")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--filters", type=int, default=8,
                   help="independent LW filters (kernel engine)")
    p.add_argument("--forecast", type=int, default=0,
                   help="simulate this many future steps (generic engine)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    engine = args.engine or ("kernel" if args.device == "cuda"
                             else "generic")
    n = args.particles or (512 if engine == "kernel" else 2048)

    from ssme_tpu_torch.io import read_data
    from ssme_tpu_torch.models import svol_leverage

    ys = torch.as_tensor(read_data(args.datafile, num_cols=1),
                         device=args.device)
    zs = svol_leverage.lagged_covariates(ys)
    model = svol_leverage.make_model()

    if engine == "kernel":
        from ssme_tpu_torch.ops.liu_west_megakernel import lw_megakernel
        from ssme_tpu_torch.ops.svol_leverage_lw_kernel import (
            lw_cloud_params, svol_leverage_lw)
        out = svol_leverage_lw(args.seed, ys, num_filters=args.filters,
                               num_particles=n, delta=args.delta,
                               variant=args.variant)
        ll = out["log_likelihood"].cpu().numpy()
        print(f"log-likelihood: {ll.mean():.2f} +- {ll.std():.2f} "
              f"({args.filters} filters)")
        params = lw_cloud_params(out["cloud"]).cpu().numpy().reshape(-1, 4)
        print(f"lw_megakernel launches: {lw_megakernel.launches}",
              file=sys.stderr)
    else:
        from ssme_tpu_torch.filters import LiuWestFilter
        lw = LiuWestFilter(model, num_particles=n, delta=args.delta,
                           variant=args.variant)
        gen = torch.Generator(device=args.device)
        res = lw.run(gen.manual_seed(args.seed), ys, zs)
        print(f"log-likelihood: {float(res.log_likelihood):.2f}")
        print(f"final ESS: {float(res.ess[-1]):.1f} / {n}")
        params = lw.param_samples(res).cpu().numpy()
        if args.forecast:
            obs = lw.sim_future_obs(gen.manual_seed(args.seed + 1),
                                    res.last_particles,
                                    res.last_trans_params,
                                    num_steps=args.forecast,
                                    last_obs=ys[-1])
            q = np.quantile(obs[..., 0].cpu().numpy(), [0.05, 0.5, 0.95],
                            axis=1)
            print(f"forecast ({args.forecast} steps, 5/50/95th "
                  f"percentiles of simulated observations):")
            for t in range(args.forecast):
                print(f"  t+{t+1}: {q[0, t]:+.4f} {q[1, t]:+.4f} "
                      f"{q[2, t]:+.4f}")

    print("parameter particles (mean +- sd):", file=sys.stderr)
    for i, name in enumerate(NAMES):
        print(f"  {name:5s} = {params[:, i].mean():+.4f} "
              f"+- {params[:, i].std():.4f}", file=sys.stderr)


if __name__ == "__main__":
    main()
