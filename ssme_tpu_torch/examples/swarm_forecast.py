#!/usr/bin/env python
"""Particle-swarm filtering and forecasting from posterior samples
(PyTorch port of ``examples/swarm_forecast.py``).

Loads posterior parameter samples (e.g. the ``--samples-out`` CSV of
``ssme_tpu_torch.examples.estimate_svol_leverage``), runs a bank of
bootstrap filters, one per sampled parameter, over the observations,
reports the parameter-marginalised conditional evidence and simulates
future observation paths:

    python -m ssme_tpu_torch.examples.swarm_forecast <datafile> \\
        <param_samples_csv> [--model svol|svol_leverage] [--forecast K] \\
        [--engine kernel|generic] [--device cuda|cpu]

``--engine kernel`` runs the whole filter bank in one launch of the
generic filter kernel (``ops/filter_megakernel.py``; its ``svol`` or
``svol_leverage`` instance) and forecasts from the final clouds it
exports; ``--state-particles`` must then be a multiple of 32 and at most
1024.  It is the default on ``cuda``.  ``--engine generic`` runs the
PyTorch swarm filter (``inference/swarm.py``).  ``--device`` defaults
to ``cuda`` and raises without a card.  Samples of ``--model svol`` are constrained
(beta, phi, ss) rows, of ``svol_leverage`` (phi, mu, sigma, rho) rows.
"""

import argparse
import os
import sys

# allow running by path without installation: put the repo root first
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _print_forecast(obs, num_models, num_steps, where):
    flat = obs[..., 0].cpu().numpy().reshape(num_models, num_steps, -1)
    q = np.quantile(flat, [0.05, 0.5, 0.95], axis=(0, 2))
    print(f"forecast ({num_steps} steps, pooled over {num_models} "
          f"models{where}):", file=sys.stderr)
    for t in range(num_steps):
        print(f"  t+{t+1}: {q[0, t]:+.4f} {q[1, t]:+.4f} {q[2, t]:+.4f}",
              file=sys.stderr)
    return q


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("datafile")
    p.add_argument("param_samples")
    p.add_argument("--model", choices=["svol", "svol_leverage"],
                   default="svol")
    p.add_argument("--state-particles", type=int, default=1024)
    p.add_argument("--param-particles", type=int, default=32)
    p.add_argument("--forecast", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--engine", choices=["kernel", "generic"], default=None,
                   help="kernel: the whole filter bank in ONE launch of "
                        "the generic filter kernel (default on cuda); "
                        "generic: the PyTorch swarm filter")
    p.add_argument("--ess", type=float, default=1.0,
                   help="kernel resampling schedule (1.0 = every step; "
                        "0.5 = ESS-adaptive)")
    p.add_argument("--gate-stride", type=int, default=1,
                   help="kernel LSE/ESS check stride (needs --ess < 1)")
    args = p.parse_args(argv)

    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    engine = args.engine or ("kernel" if device == "cuda" else "generic")
    if engine == "generic" and (args.ess != 1.0 or args.gate_stride != 1):
        p.error("--ess and --gate-stride apply to the kernel engine only")

    from ssme_tpu_torch.io import ParamSampler, read_data
    from ssme_tpu_torch.models import svol, svol_leverage

    ys = torch.as_tensor(read_data(args.datafile, num_cols=1), device=device)
    if args.model == "svol":
        model, zs = svol.make_model(), None
    else:
        model = svol_leverage.make_model()
        zs = svol_leverage.lagged_covariates(ys)
    last_obs = ys[-1] if model.has_covariates else None

    sampler = ParamSampler(args.param_samples, dim_param=model.dim_param)
    draws = sampler.samp(torch.Generator().manual_seed(args.seed),
                         num=args.param_particles).to(device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)

    if engine == "kernel":
        from ssme_tpu_torch.inference import forecast_from_cloud
        from ssme_tpu_torch.ops import filter_megakernel as fm
        if (args.state_particles % 32 != 0
                or not 32 <= args.state_particles <= 1024):
            p.error("--engine kernel requires --state-particles to be a "
                    "multiple of 32 in [32, 1024] (got "
                    f"{args.state_particles}); use the generic engine for "
                    "other sizes")
        if args.model == "svol":
            km, rows = fm.svol_kernel_model(), fm.svol_kernel_rows(draws)
        else:
            km, rows = fm.svol_leverage_kernel_model(), draws
        ev = fm.megakernel_swarm_evidence(
            km, args.seed + 1, rows.contiguous(), ys, zs,
            num_particles=args.state_particles, ess_threshold=args.ess,
            gate_stride=args.gate_stride, return_cloud=bool(args.forecast))
        lcl = ev["log_cond_like"].cpu().numpy()
        print(f"total conditional evidence: {lcl.sum():.2f} "
              f"(reference mean-of-logs aggregation: "
              f"{float(ev['mean_log_cond_like'].sum()):.2f})")
        vol = ev["functional_path"].cpu().numpy()
        print(f"filtered state (last 5): "
              f"{np.array2string(vol[-5:], precision=3)}")
        print(f"filter_megakernel launches: "
              f"{fm.filter_megakernel.launches}", file=sys.stderr)
        if args.gate_stride > 1:
            print(f"note: with --gate-stride {args.gate_stride} the "
                  "filtered-state path is zero off the check columns",
                  file=sys.stderr)
        if args.forecast:
            obs = forecast_from_cloud(
                model, draws, ev["final_cloud"], ev["final_log_weights"],
                gen, num_steps=args.forecast, last_obs=last_obs)
            _print_forecast(obs, args.param_particles, args.forecast,
                            ", kernel cloud")
        return

    from ssme_tpu_torch.inference import SwarmFilter
    sw = SwarmFilter(model, num_state_particles=args.state_particles,
                     num_param_particles=args.param_particles,
                     functionals=((lambda x, z, pp: x)
                                  if model.has_covariates
                                  else (lambda x, pp: x),))
    state, results = sw.run(
        torch.Generator(device=device).manual_seed(args.seed + 1), ys, zs,
        param_draws=draws)
    lcl = results.log_cond_like.cpu().numpy()
    print(f"total conditional evidence: {lcl.sum():.2f} "
          f"(reference mean-of-logs aggregation: "
          f"{float(results.mean_log_cond_like.sum()):.2f})")
    vol = results.expectations[0][:, 0].cpu().numpy()
    print(f"filtered state (last 5): {np.array2string(vol[-5:], precision=3)}")
    if args.forecast:
        obs = sw.sim_future_obs(gen, state, num_steps=args.forecast,
                                last_obs=last_obs)
        _print_forecast(obs, args.param_particles, args.forecast, "")


if __name__ == "__main__":
    main()
