#!/usr/bin/env python
"""The SPY accuracy gate on the PyTorch port's own draws.

The counterpart of ``examples/accuracy_gate.py``'s comparison: three runs
of the same posterior on the same data, each pair of posterior means of
(beta, phi, sigma^2) within ``2 * combined MC-SE + 1e-3``:

- **oracle**: the float64 reference-exact MCMC of the JAX package
  (``ssme_tpu/oracle.py``, the judge), read from its committed chains
  ``data/oracle_chain_{11,13}.npy`` (``--oracle-npy``, burn-in
  ``--oracle-burn``);
- **parity**: the port's engine at the reference schedule (resampling
  every step, ``--ess 1.0``);
- **adaptive**: the port's flagship schedule (ESS 0.5).

Without ``--parity-npy`` / ``--adaptive-npy`` the engines run here, in
this process, through ``spy_flagship.run_flagship`` at the flagship's
width (C=64, N=512, R=2; the flagship's adaptation restart at 2000):
parity for 6000 iterations (seed 23), adaptive for 10000 (seed 29).
Either way the first ``--ext-burn`` (2500) draws of each engine are
dropped, as the JAX gate dropped them from the JAX flagship's draws in
``data/accuracy_gate.json``.  Moments as the
JAX gate: float64 before averaging, SE = sd / sqrt(Geyer ESS) through
``ssme_tpu_torch.diagnostics.ess``.

    python -m ssme_tpu_torch.examples.accuracy_gate [--device cuda|cpu]
        [--parity-npy P.npy] [--adaptive-npy A.npy]
        [--out data/torch_accuracy_gate.json]

Prints the gate as one JSON line on stdout and exits 1 when a pair fails.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

NAMES = ("beta", "phi", "ss")
PAIRS = (("oracle", "parity"), ("oracle", "adaptive"), ("parity", "adaptive"))
ENGINES = {"parity": (1.0, 6000, 23), "adaptive": (0.5, 10000, 29)}


def moments(samples, burn):
    """(iters, C, 3) -> per-parameter (mean, MC-SE from the Geyer ESS),
    float64 before averaging (``examples/accuracy_gate.py::moments``)."""
    from ssme_tpu_torch.diagnostics import ess as geyer_ess

    post = samples[burn:]
    flat = post.reshape(-1, post.shape[2]).astype(np.float64)
    esses = np.maximum(geyer_ess(post), 4.0)
    means = [float(m) for m in flat.mean(axis=0)]
    ses = [float(flat[:, i].std(ddof=1) / np.sqrt(esses[i]))
           for i in range(post.shape[2])]
    return means, ses


def gate(results):
    """Every pair of PAIRS, parameter by parameter: |a - b| < 2 SE +
    1e-3 with SE the two MC-SEs combined."""
    out = {"pass": True, "comparisons": []}
    for a, b in PAIRS:
        for i, name in enumerate(NAMES):
            ma, mb = results[a]["mean"][i], results[b]["mean"][i]
            se = float(np.hypot(results[a]["mc_se"][i],
                                results[b]["mc_se"][i]))
            ok = abs(ma - mb) < 2.0 * se + 1e-3
            out["comparisons"].append(
                {"pair": f"{a}-vs-{b}", "param": name, "a": ma, "b": mb,
                 "combined_se": se, "z": (ma - mb) / se if se else None,
                 "ok": bool(ok)})
            out["pass"] = out["pass"] and bool(ok)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--oracle-npy", nargs="+", default=[
        os.path.join("data", "oracle_chain_11.npy"),
        os.path.join("data", "oracle_chain_13.npy")])
    ap.add_argument("--oracle-burn", type=int, default=500)
    ap.add_argument("--parity-npy", default=None)
    ap.add_argument("--adaptive-npy", default=None)
    ap.add_argument("--ext-burn", type=int, default=2500,
                    help="draws dropped from each engine's run")
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--replicates", type=int, default=2)
    ap.add_argument("--parity-iters", type=int,
                    default=ENGINES["parity"][1])
    ap.add_argument("--adaptive-iters", type=int,
                    default=ENGINES["adaptive"][1])
    ap.add_argument("--restart", type=int, default=2000,
                    help="adaptation restart of an engine run here")
    ap.add_argument("--samples-dir", default=None,
                    help="save the draws of an engine run here as "
                         "torch_gate_<engine>.npy")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--t-len", type=int, default=0,
                    help="cut the series (engine runs only; 0: all)")
    ap.add_argument("--out", default=os.path.join("data",
                                                  "torch_accuracy_gate.json"))
    args = ap.parse_args(argv)

    results = {}
    chains = []
    for path in args.oracle_npy:
        arr = np.load(os.path.join(ROOT, path) if not os.path.isabs(path)
                      else path)
        chains.append((arr[:, None, :] if arr.ndim == 2 else arr)
                      [args.oracle_burn:])
    n = min(c.shape[0] for c in chains)
    o_samples = np.concatenate([c[:n] for c in chains], axis=1)
    mean, se = moments(o_samples, 0)
    results["oracle"] = {"mean": mean, "mc_se": se,
                         "iters": int(o_samples.shape[0]),
                         "chains": int(o_samples.shape[1]), "secs": None,
                         "files": list(args.oracle_npy)}

    ext = {"parity": args.parity_npy, "adaptive": args.adaptive_npy}
    ys = None
    for label, (ess, _, seed) in ENGINES.items():
        if ext[label]:
            path = ext[label]
            samples = np.load(os.path.join(ROOT, path)
                              if not os.path.isabs(path) else path)
            mean, se = moments(samples, args.ext_burn)
            results[label] = {"mean": mean, "mc_se": se,
                              "iters": int(samples.shape[0])
                              - args.ext_burn,
                              "chains": int(samples.shape[1]), "secs": None,
                              "file": path}
            continue
        if ys is None:
            if args.device == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("--device cuda: no CUDA device is "
                                   "available")
            from ssme_tpu_torch.examples.spy_flagship import (run_flagship,
                                                              spy_returns)
            ys = spy_returns(args.device, args.t_len)
        iters = (args.parity_iters if label == "parity"
                 else args.adaptive_iters)
        print(f"== engine {label}: ess={ess} N={args.particles} "
              f"R={args.replicates} C={args.chains} iters={iters} ==",
              file=sys.stderr, flush=True)
        samples, state, secs = run_flagship(
            ys, iters, args.chains, args.particles, args.replicates, ess,
            seed=seed, burn=args.restart)
        if args.samples_dir:
            os.makedirs(args.samples_dir, exist_ok=True)
            np.save(os.path.join(args.samples_dir,
                                 f"torch_gate_{label}.npy"), samples)
        mean, se = moments(samples, args.ext_burn)
        results[label] = {"mean": mean, "mc_se": se,
                          "iters": iters - args.ext_burn,
                          "chains": args.chains, "secs": secs,
                          "seed": seed,
                          "accept_rate": float(state.accept_ma.mean()),
                          "device": args.device}

    out = {"results": results,
           "gate": dict(t_len=None if ys is None else int(ys.shape[0]),
                        **gate(results))}
    if ys is not None and args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["gate"]), flush=True)
    for r in out["gate"]["comparisons"]:
        print(f"  {r['pair']:>20} {r['param']:>5}: {r['a']:.4f} vs "
              f"{r['b']:.4f} (se {r['combined_se']:.4f}, z {r['z']:+.2f}) "
              f"{'OK' if r['ok'] else 'FAIL'}", file=sys.stderr)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["gate"]["pass"] else 1)
