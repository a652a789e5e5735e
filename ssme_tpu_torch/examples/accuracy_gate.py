#!/usr/bin/env python
"""The SPY accuracy gate on the PyTorch port's own draws.

The counterpart of ``examples/accuracy_gate.py``: three runs of the same
posterior on the same data, each pair of posterior means of (beta, phi,
sigma^2) within ``2 * combined MC-SE + 1e-3``:

- **oracle**: the float64 reference-exact MCMC.  By default its committed
  chains ``data/oracle_chain_{11,13}.npy`` (the JAX package's judge), or
  the chains given to ``--oracle-npy``, pooled after ``--oracle-burn``
  draws each.  ``--oracle-npy`` with no file runs the port's own oracle
  here (``ssme_tpu_torch/oracle.py``, seed 11, ``t0=150``): T as
  ``--t-len``, ``--oracle-particles`` N, ``--replicates`` R,
  ``--oracle-iters`` iterations from the posterior mode
  (``--oracle-start mode``) or the reference's cold start, adapting up to
  ``--oracle-t1`` (0: throughout); its first quarter is dropped;
- **parity**: the port's engine at the reference schedule (resampling
  every step, ``--ess 1.0``);
- **adaptive**: the port's flagship schedule (ESS 0.5).

Without ``--parity-npy`` / ``--adaptive-npy`` the engines run here, in
this process, through ``spy_flagship.run_flagship`` at the flagship's
width (C=64, N=512, R=2; the flagship's adaptation restart at 2000):
parity for 6000 iterations (seed 23), adaptive for 10000 (seed 29), or
``--engine-iters`` each, unless ``--parity-iters`` / ``--adaptive-iters``
say otherwise.  Either way the first ``--ext-burn`` (2500) draws of each
engine are dropped, as the JAX gate dropped them from the JAX flagship's
draws in ``data/accuracy_gate.json``.  The draws of a run here are saved
in ``<out>_samples.npz`` beside ``--out``; ``--skip-oracle`` and
``--reuse-engines`` take them from there instead of running again.
Moments as the JAX gate: float64 before averaging, SE = sd / sqrt(Geyer
ESS) through ``ssme_tpu_torch.diagnostics.ess``.

    python -m ssme_tpu_torch.examples.accuracy_gate [--device cuda|cpu]
        [--oracle-npy [O.npy ...]] [--parity-npy P.npy]
        [--adaptive-npy A.npy] [--out data/torch_accuracy_gate.json]

Prints the gate as one JSON line on stdout and exits 1 when a pair fails.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

NAMES = ("beta", "phi", "ss")
PAIRS = (("oracle", "parity"), ("oracle", "adaptive"), ("parity", "adaptive"))
ENGINES = {"parity": (1.0, 6000, 23), "adaptive": (0.5, 10000, 29)}

REF_START_Z = (1.0, 2.0 * np.arctanh(0.5), np.log(2e-4))
# twiceFisher(.5) = log(1.5/.5) = 2*atanh(.5); estimate_univ_svol.h:152-154

MODE_START_Z = (0.849, 2.0 * np.arctanh(0.9744), np.log(0.0659))
# transformed posterior mode (RESULTS.md posterior means)


def run_oracle(ys, iters, n_particles, n_reps, seed, start="mode",
               t1=10**9, device="cuda"):
    """One oracle chain (``examples/accuracy_gate.py::run_oracle``): from
    the posterior mode and adapting throughout by default, which leaves
    the stationary target the reference's (adaptation changes only the
    mixing).  Returns ((iters, 1, 3) draws, wall seconds)."""
    from ssme_tpu_torch.oracle import oracle_pmmh

    t0 = time.perf_counter()
    z0 = MODE_START_Z if start == "mode" else REF_START_Z
    samples = oracle_pmmh(seed, torch.as_tensor(ys, dtype=torch.float64),
                          np.asarray(z0), iters, n_particles, n_reps,
                          t0=150, t1=t1,
                          progress_every=max(iters // 10, 1), device=device)
    return samples[:, None, :], time.perf_counter() - t0


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


def _path(path):
    return path if os.path.isabs(path) else os.path.join(ROOT, path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--oracle-npy", nargs="*", default=[
        os.path.join("data", "oracle_chain_11.npy"),
        os.path.join("data", "oracle_chain_13.npy")],
        help="oracle chains (.npy, (iters, 3) or (iters, 1, 3) each), "
             "pooled as chains; given with no file: run the oracle here")
    ap.add_argument("--oracle-burn", type=int, default=500,
                    help="per-chain burn-in of --oracle-npy files")
    ap.add_argument("--oracle-iters", type=int, default=4000)
    ap.add_argument("--oracle-particles", type=int, default=500,
                    help="reference NUMPARTS (main.cpp:9)")
    ap.add_argument("--oracle-start", choices=["mode", "reference"],
                    default="mode")
    ap.add_argument("--oracle-t1", type=int, default=0,
                    help="0 = adapt throughout (mixing only; same "
                         "stationary target)")
    ap.add_argument("--skip-oracle", action="store_true",
                    help="reuse the oracle draws saved beside --out")
    ap.add_argument("--reuse-engines", action="store_true",
                    help="reuse the parity/adaptive draws saved beside "
                         "--out (oracle-only rerun)")
    ap.add_argument("--parity-npy", default=None)
    ap.add_argument("--adaptive-npy", default=None)
    ap.add_argument("--ext-burn", type=int, default=2500,
                    help="draws dropped from each engine's run")
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--replicates", type=int, default=2)
    ap.add_argument("--engine-iters", type=int, default=None,
                    help="iterations of each engine run here (default: "
                         "parity 6000, adaptive 10000)")
    ap.add_argument("--parity-iters", type=int, default=None)
    ap.add_argument("--adaptive-iters", type=int, default=None)
    ap.add_argument("--restart", type=int, default=2000,
                    help="adaptation restart of an engine run here")
    ap.add_argument("--samples-dir", default=None,
                    help="save the draws of an engine run here as "
                         "torch_gate_<engine>.npy")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--t-len", type=int, default=0,
                    help="cut the series (runs here only; 0: all)")
    ap.add_argument("--out", default=os.path.join("data",
                                                  "torch_accuracy_gate.json"))
    args = ap.parse_args(argv)
    iters = {"parity": args.parity_iters, "adaptive": args.adaptive_iters}
    for label in iters:
        iters[label] = iters[label] or args.engine_iters or ENGINES[label][1]

    samples_npz = os.path.splitext(args.out)[0] + "_samples.npz"
    saved = {}
    if ((args.skip_oracle or args.reuse_engines)
            and os.path.exists(samples_npz)):
        saved = dict(np.load(samples_npz))
    if not args.skip_oracle:
        saved.pop("oracle", None)
        saved.pop("oracle_secs", None)
    if not args.reuse_engines:
        saved.pop("parity", None)
        saved.pop("adaptive", None)

    ys = None

    def series():
        nonlocal ys
        if ys is None:
            if args.device == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("--device cuda: no CUDA device is "
                                   "available")
            from ssme_tpu_torch.examples.spy_flagship import spy_returns
            ys = spy_returns(args.device, args.t_len)
        return ys

    def save():
        if args.out != os.devnull:
            np.savez_compressed(samples_npz, **saved)

    results = {}
    if args.oracle_npy:
        chains = []
        for path in args.oracle_npy:
            arr = np.load(_path(path))
            chains.append((arr[:, None, :] if arr.ndim == 2 else arr)
                          [args.oracle_burn:])
        n = min(c.shape[0] for c in chains)
        o_samples = np.concatenate([c[:n] for c in chains], axis=1)
        mean, se = moments(o_samples, 0)
        results["oracle"] = {"mean": mean, "mc_se": se,
                             "iters": int(o_samples.shape[0]),
                             "chains": int(o_samples.shape[1]), "secs": None,
                             "files": list(args.oracle_npy)}
    else:
        if "oracle" in saved:
            o_samples = saved["oracle"]
            o_secs = float(saved.get("oracle_secs", np.nan))
        else:
            t_len = series().shape[0]
            print(f"== oracle: T={t_len} N={args.oracle_particles} "
                  f"R={args.replicates} iters={args.oracle_iters} "
                  f"start={args.oracle_start} ==", file=sys.stderr,
                  flush=True)
            o_samples, o_secs = run_oracle(
                series(), args.oracle_iters, args.oracle_particles,
                args.replicates, seed=11, start=args.oracle_start,
                t1=(args.oracle_t1 or 10**9), device=args.device)
            saved["oracle"] = o_samples
            saved["oracle_secs"] = o_secs
            save()
        mean, se = moments(o_samples, args.oracle_iters // 4)
        results["oracle"] = {"mean": mean, "mc_se": se,
                             "iters": int(o_samples.shape[0]), "chains": 1,
                             "secs": o_secs, "seed": 11,
                             "device": args.device}

    ext = {"parity": args.parity_npy, "adaptive": args.adaptive_npy}
    for label, (ess, _, seed) in ENGINES.items():
        if ext[label]:
            path = ext[label]
            samples = np.load(_path(path))
            mean, se = moments(samples, args.ext_burn)
            results[label] = {"mean": mean, "mc_se": se,
                              "iters": int(samples.shape[0])
                              - args.ext_burn,
                              "chains": int(samples.shape[1]), "secs": None,
                              "file": path}
            continue
        if label in saved:
            samples = saved[label]
            extra = {"secs": None, "file": samples_npz}
        else:
            from ssme_tpu_torch.examples.spy_flagship import run_flagship
            print(f"== engine {label}: ess={ess} N={args.particles} "
                  f"R={args.replicates} C={args.chains} "
                  f"iters={iters[label]} ==", file=sys.stderr, flush=True)
            samples, state, secs = run_flagship(
                series(), iters[label], args.chains, args.particles,
                args.replicates, ess, seed=seed, burn=args.restart)
            if args.samples_dir:
                os.makedirs(args.samples_dir, exist_ok=True)
                np.save(os.path.join(args.samples_dir,
                                     f"torch_gate_{label}.npy"), samples)
            saved[label] = samples
            save()
            extra = {"secs": secs, "seed": seed,
                     "accept_rate": float(state.accept_ma.mean()),
                     "device": args.device}
        mean, se = moments(samples, args.ext_burn)
        results[label] = {"mean": mean, "mc_se": se,
                          "iters": int(samples.shape[0]) - args.ext_burn,
                          "chains": int(samples.shape[1]), **extra}

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
