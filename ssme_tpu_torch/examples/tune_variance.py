#!/usr/bin/env python
"""Var[log L-hat] of the pseudo-marginal likelihood estimator at the SPY
posterior mean as a function of (N particles, R replicates), on the
PyTorch port.

The counterpart of ``examples/tune_variance.py``.  For pseudo-marginal
MCMC the acceptance penalty is governed by the variance of the
log-likelihood estimator at a representative theta: the Doucet & Pitt
(2015) / Pitt et al. (2012) optimum sets Var[log L-hat(theta*)] in roughly
1.0-1.7; far above it the chain sticks, far below it wastes particles and
replicates.  This script measures that variance on the card.

Method: the SVOL filter kernel (``ops/svol_filter_kernel.py::svol_filter``)
returns SINGLE-replicate log-likelihoods, one a row, and the R-replicate
estimator of the MH ratio is the log-mean-exp over R of them.  So for each
N it draws ``--singles`` independent singles in launches of
``--launch-rows`` rows (no padding: the port's ESS gate is per row), then
derives Var[log L-hat_R] for EVERY R by random regrouping on the host.

    python -m ssme_tpu_torch.examples.tune_variance [--particles 256 512
        1024] [--replicates 1 2 4 8 16 32 64] [--singles 1024]
        [--launch-rows 512] [--ess 0.5] [--t-len T] [--theta B P SS]
        [--seed 0] [--device cuda|cpu] [--out data/torch_tune_variance.jsonl]

One JSON line per (N, R) on stdout, appended to ``--out``, with the
variance, its bootstrap SE and the seconds per launch row of the warm
launches (the first builds the kernels), timed by ``profiling.PhaseTimer``;
each N's singles go to ``<out>_singles_N<N>.npy`` beside it (never the JAX
run's ``data/tune_variance*`` files).  ``--device`` defaults to ``cuda``
and raises without a card; ``--device cpu`` runs the kernel's plain
version.
"""

import argparse
import json
import os
import sys

# allow running by path without installation: put the repo root first
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

THETA_STAR = (0.849, 0.9744, 0.0659)  # SPY posterior mean (RESULTS.md)


def measure_singles(n_particles, n_singles, ys, theta, ess_threshold,
                    seed0, launch_rows, timer):
    """Draw ``n_singles`` independent single-replicate log L-hat values at
    ``theta`` in ceil(n_singles / launch_rows) kernel launches on the
    device of ``ys``, each timed by ``timer`` (a ``PhaseTimer``).  Returns
    (singles (n_singles,), seconds per launch list)."""
    from ssme_tpu_torch.ops.svol_filter_kernel import svol_filter

    beta, phi, ss = theta
    rows = min(launch_rows, n_singles)
    p = torch.tensor([beta, phi, float(np.sqrt(ss))], dtype=torch.float32,
                     device=ys.device).expand(rows, 3).contiguous()
    name = f"N={n_particles} launch"
    singles, times = [], []
    k = 0
    while sum(s.shape[0] for s in singles) < n_singles:
        before = timer.totals.get(name, 0.0)
        with timer.phase(name) as h:
            h["result"] = svol_filter(seed0 + k, p, ys,
                                      num_particles=n_particles,
                                      ess_threshold=ess_threshold)[0]
        times.append(timer.totals[name] - before)
        vals = h["result"].cpu().numpy()
        if not np.all(np.isfinite(vals)):
            raise RuntimeError(
                f"non-finite log-likelihood at N={n_particles}: "
                f"{vals[~np.isfinite(vals)][:4]}")
        singles.append(vals)
        k += 1
    return np.concatenate(singles)[:n_singles], times


def var_of_r_average(singles, r, n_boot=200, rng=None):
    """Var[logmeanexp of r singles] via random regrouping.

    Singles are iid, so ANY partition into groups of r yields valid
    draws of the R-averaged estimator; averaging the group-variance over
    many random partitions squeezes the most precision out of a fixed
    singles budget.  Returns (var, se) where se is the spread of the
    per-partition variance estimates (conservative: partitions reuse
    the same singles, so they are positively correlated)."""
    if rng is None:
        rng = np.random.default_rng(0)
    m = singles.shape[0] // r
    if m < 2:
        return float("nan"), float("nan")
    ests = np.empty(n_boot)
    for i in range(n_boot):
        idx = rng.permutation(singles.shape[0])[: m * r].reshape(m, r)
        g = singles[idx]
        mx = g.max(axis=1, keepdims=True)
        avg = mx[:, 0] + np.log(np.exp(g - mx).mean(axis=1))
        ests[i] = avg.var(ddof=1)
    # sampling error of a variance from m draws: sd ~ var * sqrt(2/(m-1));
    # the partition spread underestimates it, so report the larger
    se_analytic = ests.mean() * np.sqrt(2.0 / (m - 1))
    return float(ests.mean()), float(max(ests.std(), se_analytic))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--particles", type=int, nargs="+",
                    default=[256, 512, 1024])
    ap.add_argument("--replicates", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32, 64])
    ap.add_argument("--singles", type=int, default=1024,
                    help="independent single-replicate estimates per N")
    ap.add_argument("--launch-rows", type=int, default=512,
                    help="rows per kernel launch")
    ap.add_argument("--ess", type=float, default=0.5)
    ap.add_argument("--t-len", type=int, default=0,
                    help="truncate the series (0 = full T=3084)")
    ap.add_argument("--theta", type=float, nargs=3, default=THETA_STAR,
                    metavar=("BETA", "PHI", "SS"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "data", "torch_tune_variance.jsonl"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    from ssme_tpu_torch.examples.spy_flagship import spy_returns
    from ssme_tpu_torch.profiling import PhaseTimer

    ys = spy_returns(args.device, args.t_len).reshape(-1)
    t_len = int(ys.shape[0])
    card = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    timer = PhaseTimer()
    rng = np.random.default_rng(args.seed)
    with open(args.out, "a") as out_f:
        for n in args.particles:
            print(f"== N={n}: drawing {args.singles} singles "
                  f"(T={t_len}, ess={args.ess}) ==", file=sys.stderr,
                  flush=True)
            singles, times = measure_singles(
                n, args.singles, ys, tuple(args.theta), args.ess,
                seed0=args.seed * 1000 + n, launch_rows=args.launch_rows,
                timer=timer)
            # the first launch builds the kernels: the cost per row comes
            # from the rest
            warm = times[1:] if len(times) > 1 else times
            rows_per_launch = min(args.launch_rows, args.singles)
            sec_per_row = float(np.mean(warm)) / rows_per_launch
            np.save(args.out.replace(".jsonl", f"_singles_N{n}.npy"),
                    singles)
            print(f"   N={n}: mean={singles.mean():.2f} "
                  f"var1={singles.var(ddof=1):.3f} "
                  f"sec/row={sec_per_row * 1e3:.4f}ms "
                  f"(launches: {['%.4fs' % t for t in times]})",
                  file=sys.stderr, flush=True)
            for r in args.replicates:
                v, se = var_of_r_average(singles, r, rng=rng)
                rec = {
                    "N": n, "R": r, "T": t_len, "ess": args.ess,
                    "var_logl": v, "var_se": se,
                    "mean_single": float(singles.mean()),
                    "var_single": float(singles.var(ddof=1)),
                    "sec_per_row": sec_per_row,
                    "cost_nr": n * r,
                    "sec_per_eval": sec_per_row * r,
                    "device": card,
                }
                print(json.dumps(rec), flush=True)
                out_f.write(json.dumps(rec) + "\n")
                out_f.flush()
    print(timer.report(), file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
