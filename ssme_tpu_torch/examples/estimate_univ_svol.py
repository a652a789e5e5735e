#!/usr/bin/env python
"""CLI driver: adaptive PMMH on the univariate SVOL model (PyTorch port).

The counterpart of ``examples/estimate_univ_svol.py``, with the same five
positional arguments and the same outputs:

    python -m ssme_tpu_torch.examples.estimate_univ_svol \\
        <datafile> <samples_base> <messages_base> <n_mcmc> <n_pfilters> \\
        [--chains C] [--particles N] [--device cuda|cpu] \\
        [--engine kernel|generic] [--gate-stride G] [--no-timestamp]

Chain configuration is the reference's: start theta = (1.0,
twiceFisher(.5), log 2e-4), transforms {null, twice_fisher, log},
C0 = .15 I, adaptation window t0=150..t1=1000, priors beta~N(1,1),
phi~U(0,1), ss~InvGamma(.001,.001).  Outputs: a timestamped CSV of
constrained samples per chain and a message stream per chain.

``--engine kernel`` evaluates all chains x replicates of an MH iteration
in one launch of the CUDA filter kernel (ESS-adaptive resampling); it is
the default on ``cuda``.  ``--engine generic`` runs the PyTorch filter
bank.  ``--device`` defaults to ``cuda`` and raises without a card;
nothing continues on the CPU in its place unless ``--device cpu`` asks.
"""

import argparse
import os
import sys

# allow running by path without installation: put the repo root first
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def kernel_particles(n: int) -> int:
    """Round a particle count to the kernel's granularity (a multiple of
    32 in [32, 1024])."""
    return min(max(32, (n + 31) // 32 * 32), 1024)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("datafile")
    p.add_argument("samples_base")
    p.add_argument("messages_base")
    p.add_argument("n_mcmc", type=int)
    p.add_argument("n_pfilters", type=int)
    p.add_argument("--chains", type=int, default=1)
    p.add_argument("--particles", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print-every-k", type=int, default=1)
    p.add_argument("--print-to-console", action="store_true")
    p.add_argument("--no-timestamp", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="path to write a resumable chain checkpoint")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--engine", choices=["kernel", "generic"], default=None,
                   help="kernel: all chains x replicates per MH iteration "
                        "in one filter-kernel launch (default on cuda); "
                        "generic: the PyTorch filter bank")
    p.add_argument("--gate-stride", type=int, default=1,
                   help="kernel engine: LSE/ESS check stride")
    p.add_argument("--tuned", action="store_true",
                   help="64 chains x 2 PF replicates and adaptation that "
                        "never freezes; an explicit --chains still wins")
    args = p.parse_args(argv)

    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    engine = args.engine or ("kernel" if device == "cuda" else "generic")
    if engine == "generic" and args.gate_stride != 1:
        p.error("--gate-stride applies to the kernel engine only")

    t1 = 1000
    if args.tuned:
        if args.chains == 1:
            args.chains = 64
        args.n_pfilters = 2
        t1 = 10 ** 9

    from ssme_tpu_torch.diagnostics import summarize
    from ssme_tpu_torch.inference import AdaptivePMMH
    from ssme_tpu_torch.io import MessageWriter, SampleWriter, read_data
    from ssme_tpu_torch.models import svol

    ys = torch.as_tensor(read_data(args.datafile, num_cols=1), device=device)
    print(f"first row of data:\n{float(ys[0, 0])}", file=sys.stderr)

    batched_ll = None
    if engine == "kernel":
        n_parts = kernel_particles(args.particles)
        if n_parts != args.particles:
            print(f"kernel engine: rounding --particles to {n_parts} "
                  "(multiple of 32, <= 1024)", file=sys.stderr)
        args.particles = n_parts
        from ssme_tpu_torch.ops.svol_filter_kernel import \
            svol_batched_log_like
        batched_ll = svol_batched_log_like(n_parts, args.n_pfilters,
                                           gate_stride=args.gate_stride)
    pmmh = AdaptivePMMH(svol.make_model(), num_particles=args.particles,
                        num_replicates=args.n_pfilters, t0=150, t1=t1,
                        batched_log_like=batched_ll)

    ts = not args.no_timestamp
    sample_writers, message_writers = [], []
    for chain in range(args.chains):
        suffix = f"_chain{chain}" if args.chains > 1 else ""
        sample_writers.append(SampleWriter(
            args.samples_base + suffix, print_every_k=args.print_every_k,
            timestamp=ts))
        message_writers.append(MessageWriter(
            args.messages_base + suffix, print_every_k=args.print_every_k,
            print_to_console=args.print_to_console, timestamp=ts))
    try:
        samples, state = pmmh.sample(
            args.seed, svol.START_TRANS_THETA, args.n_mcmc, ys,
            num_chains=args.chains, sample_writer=sample_writers,
            message_writer=message_writers,
            checkpoint_path=args.checkpoint)
    finally:
        for w in sample_writers + message_writers:
            w.close()

    ar = float(state.accept_ma.mean())
    print(f"done: {args.n_mcmc} iters x {args.chains} chains on {device} "
          f"({engine}), final accept rate {ar:.3f}", file=sys.stderr)

    draws = np.asarray(samples)[args.n_mcmc // 4:]
    for name, stats in summarize(
            draws, names=["beta", "phi", "sigma_sq"]).items():
        print(f"{name}: mean={stats['mean']:.4f} sd={stats['sd']:.4f} "
              f"[{stats['q5']:.4f}, {stats['q95']:.4f}] "
              f"rhat={stats['rhat']:.3f} ess={stats['ess']:.0f}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
