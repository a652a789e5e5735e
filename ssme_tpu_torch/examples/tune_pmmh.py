#!/usr/bin/env python
"""Sampler efficiency of candidate (chains, N, R, t1) configurations on
the SPY workload, on the PyTorch port: accept rate, split R-hat, Geyer
ESS and ESS per second.

The counterpart of ``examples/tune_pmmh.py``, the second half of the
pseudo-marginal tuning loop after ``tune_variance``: adaptive PMMH on
univariate SVOL over SPY with every chain x replicate of an iteration in
one launch of the SVOL filter kernel
(``ops/svol_filter_kernel.py::svol_batched_log_like``).  Chains start AT
the posterior mean, so the numbers measure stationary efficiency, not
burn-in.  Seconds per iteration come from the chunks after the first
(which builds the kernels), each timed by ``profiling.PhaseTimer``.

    python -m ssme_tpu_torch.examples.tune_pmmh [--iters 3000]
        [--chunk 250] [--configs label,chains,N,R,t1 ...]
        [--gate-stride 1] [--t-len T] [--device cuda|cpu]
        [--out data/torch_tune_pmmh.jsonl]

One JSON line per configuration on stdout, appended to ``--out`` (never
the JAX run's ``data/tune_pmmh.jsonl``).  ``--gate-stride`` is the
kernel's ESS-check stride (the JAX hook's ``gate_stride``).
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the kernel's plain version (add ``--t-len`` there).
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

THETA_STAR = (0.849, 0.9744, 0.0659)

# (label, chains, N, R, t1)
DEFAULT_CONFIGS = [
    ("flagship_r3", 8, 512, 16, 1000),       # the JAX round-3 default
    ("tuned_r2", 64, 512, 2, 1000),          # var=1.6, 8x chains
    ("tuned_r2_adapt", 64, 512, 2, 10**9),   # + never stop adapting
    ("n1024_r1_adapt", 16, 1024, 1, 10**9),  # var=1.2, big-N variant
    ("tuned_r4_adapt", 32, 512, 4, 10**9),   # var=1.0 middle ground
]


def measure(label, chains, n, r, t1, num_iters, ys, chunk=250,
            ess_tau=0.5, gate_stride=1, timer=None):
    """Run one configuration on the device of ``ys``; returns its record.
    ``timer`` (a ``PhaseTimer``) times the init and every chunk."""
    from ssme_tpu_torch import diagnostics
    from ssme_tpu_torch.inference import AdaptivePMMH
    from ssme_tpu_torch.models import svol
    from ssme_tpu_torch.ops.svol_filter_kernel import svol_batched_log_like
    from ssme_tpu_torch.profiling import PhaseTimer

    timer = PhaseTimer() if timer is None else timer
    model = svol.make_model()
    batched = svol_batched_log_like(n, r, ess_threshold=ess_tau,
                                    gate_stride=gate_stride)
    pmmh = AdaptivePMMH(model, num_particles=n, num_replicates=r,
                        t0=150, t1=t1, batched_log_like=batched)
    start = model.transform.unconstrain(
        torch.tensor(THETA_STAR, dtype=torch.float32, device=ys.device))
    with timer.phase(f"{label} init") as h:
        state = pmmh.init(7, start, ys, num_chains=chains)
        h["result"] = state.log_like

    samples, accepted = [], []
    warm_secs, warm_iters = 0.0, 0
    done = 0
    name = f"{label} chunk"
    while done < num_iters:
        before = timer.totals.get(name, 0.0)
        with timer.phase(name) as h:
            res = pmmh.run_from(state, chunk, ys)
            h["result"] = res.samples
        if done > 0:                  # the first chunk builds the kernels
            warm_secs += timer.totals[name] - before
            warm_iters += chunk
        state = res.final_state
        samples.append(res.samples.cpu().numpy())
        accepted.append(res.accepted.cpu().numpy())
        done += chunk
    samples = np.concatenate(samples)          # (iters, C, 3)
    accepted = np.concatenate(accepted)        # (iters, C)
    sec_per_iter = warm_secs / max(warm_iters, 1)

    burn = num_iters // 4
    post = samples[burn:]
    acc = float(accepted[burn:].mean())
    rhat = diagnostics.split_rhat(post)
    ess = diagnostics.ess(post)
    min_ess = float(np.min(ess))
    total_secs = num_iters * sec_per_iter
    post_secs = (num_iters - burn) * sec_per_iter
    return {
        "label": label, "chains": chains, "N": n, "R": r,
        "t1": (None if t1 >= 10**8 else t1), "iters": num_iters,
        "accept_rate": acc,
        "sec_per_iter": sec_per_iter,
        "rhat": [float(x) for x in rhat],
        "ess": [float(x) for x in ess],
        "min_ess": min_ess,
        "ess_per_sec": min_ess / post_secs,
        "total_secs_est": total_secs,
        "posterior_mean": [float(x) for x in post.reshape(-1, 3).mean(0)],
        "posterior_sd": [float(x)
                         for x in post.reshape(-1, 3).std(0, ddof=1)],
        "ess_threshold": ess_tau, "gate_stride": gate_stride,
        "T": int(ys.shape[0]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--configs", nargs="*", default=None,
                    help="label,chains,N,R,t1 tuples; default built-ins")
    ap.add_argument("--gate-stride", type=int, default=1,
                    help="kernel ESS check stride")
    ap.add_argument("--t-len", type=int, default=0,
                    help="cut the series to its first T steps (0: all)")
    ap.add_argument("--out", default=os.path.join(ROOT, "data",
                                                  "torch_tune_pmmh.jsonl"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    from ssme_tpu_torch.examples.spy_flagship import spy_returns
    from ssme_tpu_torch.profiling import PhaseTimer

    ys = spy_returns(args.device, args.t_len)
    if args.configs:
        configs = []
        for c in args.configs:
            label, chains, n, r, t1 = c.split(",")
            configs.append((label, int(chains), int(n), int(r), int(t1)))
    else:
        configs = DEFAULT_CONFIGS
    card = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    timer = PhaseTimer()
    with open(args.out, "a") as out_f:
        for label, chains, n, r, t1 in configs:
            print(f"== {label}: C={chains} N={n} R={r} t1={t1} ==",
                  file=sys.stderr, flush=True)
            rec = measure(label, chains, n, r, t1, args.iters, ys,
                          chunk=args.chunk, gate_stride=args.gate_stride,
                          timer=timer)
            rec["device"] = card
            print(json.dumps(rec), flush=True)
            out_f.write(json.dumps(rec) + "\n")
            out_f.flush()
            print(f"   accept={rec['accept_rate']:.3f} "
                  f"iter={rec['sec_per_iter'] * 1e3:.1f}ms "
                  f"minESS={rec['min_ess']:.0f} "
                  f"ESS/s={rec['ess_per_sec']:.2f} rhat={rec['rhat']}",
                  file=sys.stderr, flush=True)
    print(timer.report(), file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
