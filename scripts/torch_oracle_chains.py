#!/usr/bin/env python
"""The port's float64 oracle chains over the SPY series, one process a
seed, all started together.

Each chain is ``ssme_tpu_torch.oracle.oracle_pmmh(seed, ...)`` as the
JAX package's committed chains ``data/oracle_chain_{11,13}.npy`` were
made: all of ``data/spy_returns.csv`` (T=3084, read as float32, as the
gate reads it), N=500 particles, R=8 replicates, 2500 iterations from
the posterior mode (``accuracy_gate.MODE_START_Z``), ``t0=150`` and
adaptation throughout.  Writes ``torch_oracle_chain_<seed>.npy``
((iters, 3) constrained float64 draws) under ``--out-dir`` and prints
one JSON object: per seed the wall seconds, seconds per iteration and
acceptance rate; the chains pooled after the gate's burn-in of 500 each
beside the JAX chains' pooled means (``data/accuracy_gate.json``), with
both MC-SEs (the gate's ``moments``) and their combination; and the
card's name and power limit (the H100 run's line is
``data/torch_oracle_chains.json``).  The gate pools the chains with
``--oracle-npy``:

    python scripts/torch_oracle_chains.py [--seeds 11 13] [--iters 2500]
        [--particles 500] [--replicates 8] [--t-len T] [--device cuda|cpu]
        [--out-dir data]
    python -m ssme_tpu_torch.examples.accuracy_gate --oracle-npy
        data/torch_oracle_chain_11.npy data/torch_oracle_chain_13.npy
        --out data/torch_accuracy_gate_oracle.json
"""

import argparse
import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

BURN = 500      # the gate's --oracle-burn


def chain(seed, args):
    """Run and save one chain; (seed, T, wall seconds, acceptance
    rate)."""
    torch.set_num_threads(1)
    from ssme_tpu_torch.examples.accuracy_gate import MODE_START_Z
    from ssme_tpu_torch.examples.spy_flagship import spy_returns
    from ssme_tpu_torch.oracle import oracle_pmmh

    ys = spy_returns(args.device, args.t_len).double()
    t0 = time.perf_counter()
    samples = oracle_pmmh(seed, ys, np.asarray(MODE_START_Z), args.iters,
                          args.particles, args.replicates, t0=150,
                          t1=10 ** 9, progress_every=max(args.iters // 10, 1),
                          device=args.device)
    secs = time.perf_counter() - t0
    np.save(os.path.join(args.out_dir, f"torch_oracle_chain_{seed}.npy"),
            samples)
    moved = np.any(np.diff(samples, axis=0) != 0, axis=1)
    return seed, int(ys.shape[0]), secs, float(moved.mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 13])
    ap.add_argument("--iters", type=int, default=2500)
    ap.add_argument("--particles", type=int, default=500)
    ap.add_argument("--replicates", type=int, default=8)
    ap.add_argument("--t-len", type=int, default=0, help="0: all of SPY")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "data"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(len(args.seeds)) as pool:
        runs = pool.starmap(chain, [(seed, args) for seed in args.seeds])
    from ssme_tpu_torch.examples.accuracy_gate import NAMES, moments
    pooled = np.stack([np.load(os.path.join(
        args.out_dir, f"torch_oracle_chain_{seed}.npy"))[BURN:]
        for seed in args.seeds], axis=1)
    mean, se = moments(pooled, 0)
    with open(os.path.join(ROOT, "data", "accuracy_gate.json")) as f:
        jax = json.load(f)["results"]["oracle"]
    vs_jax = {}
    for i, name in enumerate(NAMES):
        comb = float(np.hypot(se[i], jax["mc_se"][i]))
        vs_jax[name] = {"port": mean[i], "port_se": se[i],
                        "jax": jax["mean"][i], "jax_se": jax["mc_se"][i],
                        "combined_se": comb,
                        "z": (mean[i] - jax["mean"][i]) / comb}
    out = {"T": runs[0][1], "N": args.particles,
           "R": args.replicates, "iters": args.iters,
           "device": args.device, "wall_s": time.perf_counter() - t0,
           "chains": {str(seed): {"secs": secs,
                                  "s_per_iter": secs / args.iters,
                                  "accept_rate": acc}
                      for seed, _, secs, acc in runs},
           "burn": BURN, "vs_jax_oracle": vs_jax}
    if args.device == "cuda":
        from ssme_tpu_torch.bench import gpu_identity
        out["card"] = gpu_identity()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
