#!/usr/bin/env python
"""The SPY flagship posterior run on the PyTorch port.

The counterpart of ``examples/spy_flagship.py``: adaptive PMMH on
univariate SVOL over the full SPY series (T=3084) from the reference cold
start, C=64 chains x R=2 replicates x N=512 particles by default, every
chain x replicate of an MH iteration in one launch of the SVOL filter
kernel (``ops/svol_filter_kernel.py::svol_batched_log_like``), Haario
adaptation that never freezes (t1 = 10^9) and its warm restart
(``AdaptivePMMH.reset_adaptation``) at the end of burn-in:

    python -m ssme_tpu_torch.examples.spy_flagship [--iters 10000]
        [--chains 64] [--particles 512] [--replicates 2] [--burn 2000]
        [--chunk 250] [--seed 42] [--ess 0.5] [--gate-stride 1]
        [--tag tuned] [--device cuda|cpu] [--t-len T] [--out-dir data]

``--particles`` takes up to 4096 (a multiple of 128 above 1024) in one
launch per iteration.  ``--chunk`` is the granularity of the progress
lines on stderr and of the burn-in restart (it fires when the iterations
done reach ``--burn``); the TPU's chunking crash guard has no counterpart.
Writes ``torch_spy_posterior_samples_<tag>.npy`` ((iters, C, 3)
constrained draws) and ``torch_spy_posterior_summary_<tag>.json`` under
``--out-dir`` (never the JAX run's ``spy_posterior_*`` files) and prints
the summary as one JSON line on stdout.  ``--device`` defaults to
``cuda`` and raises without a card; ``--t-len`` cuts the series (for a
run on the CPU).
"""

import argparse
import json
import math
import os
import sys
import time

# allow running by path without installation: put the repo root first
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# transformed (beta, phi, ss) of the reference's cold start: beta = 1,
# twiceFisher(0.5) = 2 atanh(0.5), log 2e-4
REF_START_Z = (1.0, 2.0 * math.atanh(0.5), math.log(2e-4))
NAMES = ("beta", "phi", "ss")


def spy_returns(device, t_len=0):
    """The SPY series (T, 1) on ``device``, cut to ``t_len`` if nonzero."""
    from ssme_tpu_torch.io import read_data
    ys = torch.as_tensor(read_data(os.path.join(ROOT, "data",
                                                "spy_returns.csv"),
                                   num_cols=1), device=device)
    return ys[:t_len] if t_len else ys


def run_flagship(ys, iters, chains=64, particles=512, replicates=2,
                 ess=0.5, gate_stride=1, seed=42, burn=2000, chunk=250,
                 log=None):
    """Adaptive PMMH on SVOL through the SVOL filter kernel from the
    reference cold start; the adaptation restarts when the iterations done
    reach ``burn`` (checked every ``chunk``); progress lines go to ``log``
    (default stderr).  Returns (samples (iters, C, 3) float32 numpy, final
    state, wall seconds)."""
    from ssme_tpu_torch.inference import AdaptivePMMH
    from ssme_tpu_torch.models import svol
    from ssme_tpu_torch.ops.svol_filter_kernel import svol_batched_log_like

    pmmh = AdaptivePMMH(svol.make_model(), num_particles=particles,
                        num_replicates=replicates, t0=150, t1=10 ** 9,
                        batched_log_like=svol_batched_log_like(
                            particles, replicates, ess_threshold=ess,
                            gate_stride=gate_stride))
    t_wall = time.perf_counter()
    state = pmmh.init(seed, torch.tensor(REF_START_Z), ys, num_chains=chains)
    chunks, done = [], 0
    while done < iters:
        res = pmmh.run_from(state, min(chunk, iters - done), ys)
        state = res.final_state
        chunks.append(res.samples.cpu().numpy())
        done += res.samples.shape[0]
        if done == burn:
            # the Haario moments never forget the burn-in's trajectory from
            # the cold start; a warm restart drops it (as the JAX run)
            state = AdaptivePMMH.reset_adaptation(state)
        print(f"iter {done}/{iters} accept="
              f"{float(state.accept_ma.mean()):.3f} "
              f"({time.perf_counter() - t_wall:.0f}s)",
              file=log or sys.stderr, flush=True)
    return np.concatenate(chunks), state, time.perf_counter() - t_wall


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=10000)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--replicates", type=int, default=2)
    ap.add_argument("--burn", type=int, default=2000)
    ap.add_argument("--chunk", type=int, default=250,
                    help="progress and burn-in restart granularity")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ess", type=float, default=0.5,
                    help="kernel resampling schedule (1.0 = every step, "
                         "the reference parity)")
    ap.add_argument("--gate-stride", type=int, default=1,
                    help="kernel LSE/ESS check stride")
    ap.add_argument("--tag", default="tuned")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--t-len", type=int, default=0,
                    help="cut the series to its first T steps (0: all)")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "data"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    if not 0 < args.burn < args.iters:
        ap.error("--burn must lie in (0, --iters)")

    from ssme_tpu_torch.diagnostics import summarize
    from ssme_tpu_torch.ops.svol_filter_kernel import svol_filter

    ys = spy_returns(args.device, args.t_len)
    before = svol_filter.launches
    samples, state, wall = run_flagship(
        ys, args.iters, args.chains, args.particles, args.replicates,
        args.ess, args.gate_stride, args.seed, args.burn, args.chunk)
    stats = summarize(samples[args.burn:], names=list(NAMES))
    min_ess = min(stats[n]["ess"] for n in NAMES)
    out = {
        "config": {"iters": args.iters, "chains": args.chains,
                   "N": args.particles, "R": args.replicates,
                   "ess_threshold": args.ess,
                   "gate_stride": args.gate_stride,
                   "adaptation": "continuous",
                   "start": "reference (estimate_univ_svol.h:152-154)",
                   "burn": args.burn, "seed": args.seed,
                   "T": int(ys.shape[0]), "device": args.device,
                   "card": (torch.cuda.get_device_name(0)
                            if args.device == "cuda" else None)},
        "wall_secs": wall,
        "accept_rate": float(state.accept_ma.mean()),
        "posterior": stats,
        "min_ess": min_ess,
        "ess_per_sec": min_ess / wall,
        "kernel_launches": svol_filter.launches - before,
    }
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir,
                         f"torch_spy_posterior_samples_{args.tag}.npy"),
            samples)
    with open(os.path.join(args.out_dir,
                           f"torch_spy_posterior_summary_{args.tag}.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    for n in NAMES:
        s = stats[n]
        print(f"  {n:>5}: {s['mean']:.4f} +- {s['sd']:.4f} "
              f"rhat={s['rhat']:.3f} ess={s['ess']:.0f}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
