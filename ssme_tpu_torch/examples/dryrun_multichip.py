#!/usr/bin/env python
"""Multi-device dry run of the PyTorch port over ``torch.distributed``.

The counterpart of ``__graft_entry__.py::dryrun_multichip``: one rank per
device on a (chain, particle) mesh, (n/2, 2) for an even n and (n, 1)
for an odd one, then on tiny shapes:

1. one adaptive-PMMH step whose per-chain likelihood is the
   particle-sharded bootstrap filter (``parallel.sharded_pf``), with the
   chains split over the chain axis (``parallel.sharded_pmmh``); the same
   step without the chain split must give the same samples (to 1e-5) and
   log-likelihoods (to 1e-3), as the JAX dryrun requires;
2. the particle-sharded Liu-West filter on SVOL with leverage, whose
   constant functional must come out 42 to 1e-3;
3. with 2 or more ranks, one joint resample at n_local = 2048 on the first
   two ranks: the ring exchange equal to the allgather reference, bit for
   bit.

    python -m ssme_tpu_torch.examples.dryrun_multichip [--devices N]
        [--device cuda|cpu]

``--device cuda`` (the default) runs NCCL with one card a rank and
raises when N exceeds the card count; ``--device cpu`` spawns N gloo
processes on this machine.  Every rank has 120 s.  Prints one line,
``dryrun_multichip OK: ...``, and exits 0 when every check holds.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_LEN = 8
BISECTION_N_LOCAL = 2048


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def mesh_shape(n_devices):
    """(chain shards, particle shards) of the dryrun's mesh."""
    particle = 2 if n_devices % 2 == 0 else 1
    return n_devices // particle, particle


def rank_main(n_devices, device_type):
    """One rank's dryrun (every rank runs it); returns its summary."""
    import torch.distributed as dist

    from ssme_tpu_torch import parallel
    from ssme_tpu_torch.inference import AdaptivePMMH
    from ssme_tpu_torch.models import svol, svol_leverage
    from ssme_tpu_torch.parallel.mesh import all_gather_cat
    from ssme_tpu_torch.parallel.sharded_lw import ShardedLiuWest
    from ssme_tpu_torch.parallel.sharded_pf import (
        make_sharded_ll_callable, ring_resample, sharded_systematic_ancestors)

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    n_chain, n_particle = mesh_shape(n_devices)
    mesh = parallel.make_mesh(n_chain, n_particle)
    model = svol.make_model()
    num_particles = 16 * n_particle
    chains = 2 * n_chain
    rng = np.random.default_rng(1)
    ys = torch.as_tensor(0.5 * rng.normal(size=(T_LEN, 1)),
                         dtype=torch.float32, device=dev)
    start = torch.tensor(svol.START_TRANS_THETA)

    # 1. one PMMH step: chains over the chain axis, each chain's
    # likelihood over the particle axis; then the same step unsplit
    ll = make_sharded_ll_callable(model, num_particles, mesh)
    pmmh = AdaptivePMMH(model, num_particles=num_particles,
                        num_replicates=2, t0=2, t1=50, custom_log_like=ll)
    plain = AdaptivePMMH(model, num_particles=num_particles,
                         num_replicates=2, t0=2, t1=50)
    state = parallel.shard_chain_state(
        plain.init(0, start, ys, num_chains=chains), mesh)
    res = parallel.sharded_pmmh(pmmh, mesh, 1)(state, ys)
    check(tuple(res.samples.shape) == (1, chains, 3), res.samples.shape)
    check(bool(torch.isfinite(res.log_likes).all()), "non-finite log-likes")
    ref = pmmh.run_from(plain.init(0, start, ys, num_chains=chains), 1, ys)
    diff = float((res.samples - ref.samples).abs().max())
    ll_diff = float((res.log_likes - ref.log_likes).abs().max())
    # accepted proposals are O(1) constrained parameters
    check(diff <= 1e-5, f"sharded vs unsharded samples differ: {diff}")
    check(ll_diff <= 1e-3, f"sharded vs unsharded log-likes differ: {ll_diff}")

    # 2. particle-sharded Liu-West, the normalisation invariant
    lev = svol_leverage.make_model()
    lw = ShardedLiuWest(lev, num_particles=8 * n_particle, functionals=(
        lambda x, z, p: torch.full(x.shape[:-1] + (1,), 42.0,
                                   device=x.device),))
    lw_ys = torch.as_tensor(0.05 * np.random.default_rng(2).normal(
        size=(T_LEN, 1)), dtype=torch.float32, device=dev)
    lw_zs = svol_leverage.lagged_covariates(lw_ys)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    lw_res = parallel.make_sharded_lw_runner(lw, mesh)(gen, lw_ys, lw_zs)
    check(bool(torch.isfinite(lw_res.log_cond_likes).all()),
          "non-finite Liu-West conditional likelihoods")
    lw42 = float((lw_res.expectations[0] - 42.0).abs().max())
    check(lw42 < 1e-3, f"sharded Liu-West normalisation broken: {lw42}")

    # 3. the ring at n_local = 2048 on two ranks (every rank forms the
    # group; the first two use it)
    bis_diff = None
    if n_devices >= 2:
        pair = dist.new_group([0, 1])
        if dist.get_rank() < 2:
            n = 2 * BISECTION_N_LOCAL
            r = np.random.default_rng(9)
            logw = torch.as_tensor(3.0 * r.normal(size=n), dtype=torch.float32)
            xs = torch.as_tensor(r.normal(size=(n, 1)), dtype=torch.float32)
            th = torch.as_tensor(r.normal(size=(n, 3)), dtype=torch.float32)
            sl = slice(dist.get_rank() * BISECTION_N_LOCAL,
                       (dist.get_rank() + 1) * BISECTION_N_LOCAL)
            local = [v[sl].to(dev) for v in (logw, xs, th)]

            def seeded():
                g = torch.Generator(device=dev)
                g.manual_seed(4)
                return g

            ring = ring_resample(seeded(), local[0], tuple(local[1:]), pair)
            anc = sharded_systematic_ancestors(seeded(), local[0], pair)
            gathered = [all_gather_cat(v, pair)[anc] for v in local[1:]]
            bis_diff = max(float((a - b).abs().max())
                           for a, b in zip(ring, gathered))
            check(bis_diff == 0.0,
                  f"ring != allgather at n_local=2048: {bis_diff}")
    return {"rank": dist.get_rank(), "mesh": (n_chain, n_particle),
            "chains": chains, "particles": num_particles,
            "samples": tuple(res.samples.shape), "diff": diff,
            "ll_diff": ll_diff, "lw42": lw42, "bisection": bis_diff}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks (default: the card count, or 4 on cpu)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    from ssme_tpu_torch.parallel import spawn_local

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    n = args.devices or (torch.cuda.device_count() if args.device == "cuda"
                         else 4)
    outs = spawn_local(rank_main, n, args.device, args=(n, args.device))
    s = outs[0]
    bis = ("bisection-ring(n_local=2048) bit-exact" if n >= 2
           else "(bisection-ring check needs >= 2 devices: skipped)")
    print(f"dryrun_multichip OK: mesh=chain {s['mesh'][0]} x particle "
          f"{s['mesh'][1]} on {n} {args.device} ranks, chains={s['chains']} "
          f"particles={s['particles']} samples={s['samples']} "
          f"max|sharded-unsharded|={max(o['diff'] for o in outs):.3g} "
          f"(log-like {max(o['ll_diff'] for o in outs):.3g}) "
          f"sharded_lw |E[42]-42|={max(o['lw42'] for o in outs):.2g} {bis}",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
