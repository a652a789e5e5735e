#!/usr/bin/env python
"""Times of the generic filter kernel (K2) on one card, by CUDA events, as
one JSON line: SVOL-leverage at its tuned and parity schedules (B=128,
N=512, over all of ``data/spy_returns.csv``) and, where the tree has
them, svol_t bootstrap and svol APF and bootstrap (B=256, N=512).

    python scripts/k2_timing.py [ROOT] [--label NAME] [--reps 20]

ROOT (default: this checkout) is the tree whose ``ssme_tpu_torch`` is
imported, so that two trees can be timed in turns within one call on
one card, e.g. a parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists: parent, change, change, parent.
Each timing is the mean over ``--reps`` launches after one warm-up.
Needs a CUDA card; imports no JAX.
"""

import argparse
import json
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("root", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--label", default=None)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    from ssme_tpu_torch.io import read_data
    from ssme_tpu_torch.models import svol_leverage
    from ssme_tpu_torch.ops import filter_megakernel as fmk

    if not fmk.__file__.startswith(root):
        raise RuntimeError(f"imported {fmk.__file__}, not from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: k2_timing runs on the card only")
    dev = torch.device("cuda")
    ys = torch.as_tensor(read_data(os.path.join(root, "data",
                                                "spy_returns.csv"),
                                   num_cols=1), device=dev)[:, 0].contiguous()

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    out = {"tree": args.label or root, "device": torch.cuda.get_device_name(0),
           "reps": args.reps}
    lev = fmk.svol_leverage_kernel_model()
    zs = svol_leverage.lagged_covariates(ys)
    rows = torch.tensor([(0.95, -0.1, 0.3, -0.7)] * 128, device=dev)
    for name, ess in (("leverage_tuned", 0.5), ("leverage_parity", 1.0)):
        out[f"{name}_ms"] = ms(lambda: fmk.filter_megakernel(
            lev, 11, rows, ys, zs, num_particles=512, ess_threshold=ess))
    if hasattr(fmk, "svol_t_param_rows"):
        svt = fmk.svol_t_param_rows(torch.tensor(
            [(0.868, 0.975, 0.064, 10.0)] * 256)).to(dev)
        out["svol_t_parity_ms"] = ms(lambda: fmk.filter_megakernel(
            fmk.svol_t_kernel_model(), 11, svt, ys, num_particles=512))
        srows = fmk.svol_kernel_rows(torch.tensor(
            [(0.868, 0.975, 0.064)] * 256)).to(dev).contiguous()
        for mode in ("apf", "bootstrap"):
            out[f"svol_{mode}_ms"] = ms(lambda: fmk.filter_megakernel(
                fmk.svol_kernel_model(), 11, srows, ys, num_particles=512,
                mode=mode))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
