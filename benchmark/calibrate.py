"""Readings that the limits of ``correct`` are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 \\
        --seconds 4 [--first-seed N] [--fault NAME] [--out FILE]

Runs the cell's driver once a seed in one process (a short window at the
cell's own load and sizes), and prints one JSON line a seed: each number
compared for the program, and the same numbers for the control (the
plain reference computed in bfloat16, the precision below the
configuration's float32, in the program's place on the same recorded
window).  A limit lies above the largest of the program's readings and
below the smallest of the control's.  With ``--fault`` the program runs
with that fault of ``tests/test_bench_faults.py`` planted, and no control
is read.  Not part of a benchmark run.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark.lib.cell import BENCH_DIR, load_cell, load_module

    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA device")
    cell = load_cell(args.workload)
    with open(os.path.join(BENCH_DIR, "limits",
                           args.workload + ".json")) as f:
        limits = {k: v["limit"] for k, v in json.load(f).items()}
    device = torch.device("cuda", 0)
    drv = cell.driver()
    if args.fault:
        import pytest

        faults = load_module(os.path.join(BENCH_DIR, "tests",
                                          "test_bench_faults.py"),
                             "bench_faults")
        faults.apply_fault(pytest.MonkeyPatch(), cell, drv, args.fault)
    out = open(args.out, "a") if args.out else None
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t = time.time()
        run = drv.run(cell, seed, args.seconds, False, t, device, limits,
                      control=not args.fault)
        line = json.dumps({
            "workload": args.workload, "seed": seed, "fault": args.fault,
            "iterations": run.iterations, "setup_s": run.setup_s,
            "props_per_s": run.props / run.window_s,
            "program": {n: v for n, v, _ in run.checks},
            "control": dict(run.notes.get("control", {})),
            "correct": run.correct, "seconds": time.time() - t})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()


if __name__ == "__main__":
    main()
