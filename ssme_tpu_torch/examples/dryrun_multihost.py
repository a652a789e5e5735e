#!/usr/bin/env python
"""Multi-process dry run: chain-sharded PMMH over 2 processes.

The counterpart of ``examples/dryrun_multihost.py``: two processes joined
by ``torch.distributed`` stand in for two hosts, and run the recipe of
``ssme_tpu_torch/parallel/distributed.py``.  Each process takes 2 of 4
chains (one rank a device) through 3 PMMH iterations on a tiny SVOL
series (T=64, N=64, R=2), with each chain's replicates from its own
generator (a per-chain likelihood), and gathers the samples.  PASS
requires the gathered samples to be finite, of shape (3, 4, 3), equal
on both processes, and bit for bit those of one process that runs all
4 chains.

    python -m ssme_tpu_torch.examples.dryrun_multihost [--device cuda|cpu]

``--device cuda`` (the default) runs NCCL with one card a process and
raises when there are fewer than two cards; ``--device cpu`` spawns two
gloo processes on this machine.  Every rank has 120 s.  Prints
``PASS: ...`` and exits 0, or ``FAIL: ...`` and exits 1.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

NUM_PROCS = 2
CHAINS = 4
ITERS = 3
T_LEN = 64


def _pmmh_and_data(dev):
    from ssme_tpu_torch.filters import log_likelihood_fn
    from ssme_tpu_torch.inference import AdaptivePMMH
    from ssme_tpu_torch.models import svol

    model = svol.make_model()
    ys = torch.as_tensor(0.2 * np.random.default_rng(1).normal(
        size=(T_LEN, 1)), dtype=torch.float32, device=dev)
    pmmh = AdaptivePMMH(model, num_particles=64, num_replicates=2, t0=5,
                        t1=20, custom_log_like=log_likelihood_fn(model, 64))
    return pmmh, ys, torch.tensor(svol.START_TRANS_THETA)


def rank_main():
    """The SPMD program, the same on every process: its gathered samples
    and those of the same program run unsharded in this process."""
    from ssme_tpu_torch import parallel

    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.distributed.get_backend() == "nccl"
           else torch.device("cpu"))
    pmmh, ys, start = _pmmh_and_data(dev)
    mesh = parallel.make_global_mesh()
    state = pmmh.init(0, start, ys, num_chains=CHAINS)  # same seed everywhere
    state = parallel.shard_chain_state(state, mesh)
    res = parallel.sharded_pmmh(pmmh, mesh, ITERS)(state, ys)
    whole = pmmh.run(0, start, ITERS, ys, num_chains=CHAINS)
    return {"rank": torch.distributed.get_rank(),
            "world": torch.distributed.get_world_size(),
            "samples": res.samples.cpu(), "whole": whole.samples.cpu()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    from ssme_tpu_torch.parallel import spawn_local

    if args.device == "cuda" and torch.cuda.device_count() < NUM_PROCS:
        raise RuntimeError(f"--device cuda: {NUM_PROCS} processes need "
                           f"{NUM_PROCS} cards, {torch.cuda.device_count()} "
                           "available (pass --device cpu for gloo)")
    outs = spawn_local(rank_main, NUM_PROCS, args.device)
    samples = [o["samples"] for o in outs]
    ok = all(o["world"] == NUM_PROCS for o in outs)
    ok = ok and all(tuple(s.shape) == (ITERS, CHAINS, 3)
                    and bool(torch.isfinite(s).all()) for s in samples)
    same = all(torch.equal(s, samples[0]) for s in samples)
    bit_match = all(torch.equal(o["samples"], o["whole"]) for o in outs)
    digests = [float(s.double().sum()) for s in samples]
    print(f"digests: ranks {digests}, one process "
          f"{float(outs[0]['whole'].double().sum())}")
    if ok and same and bit_match:
        print(f"PASS: {NUM_PROCS}-process chain-sharded PMMH ran and "
              "bit-matches the single-process program")
        return 0
    print(f"FAIL: ok={ok} equal_across_ranks={same} bit_match={bit_match}")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
