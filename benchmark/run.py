"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration and
traffic files; the traffic names the driver; the limits of the numbers
that decide ``correct`` are in ``benchmark/limits/<cell>.json``.  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, each read by its own file in
``benchmark/metrics/`` from the traced window.  The last line on
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines on standard error and the result's last key.

It measures the card only: without CUDA, or with fewer cards than the
cell asks for, it exits with code 2 and prints no result.  It also exits
without a result if the run loaded JAX or the JAX package.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every compiled artefact stays at a fixed place inside the checkout (the
# program builds its CUDA sources into ssme_tpu_torch/_build/ itself)
CACHE = os.path.join(ROOT, "benchmark", "cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "ssme_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def percentile(values, q):
    """The q-th percentile (0-100) by linear interpolation."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def end_to_end(run):
    """The end-to-end metrics of a run, by name."""
    out = {"setup_s": run.setup_s,
           "props_per_s": run.props / run.window_s}
    if run.intervals_ms:
        out["iter_ms_p95"] = percentile(run.intervals_ms, 95)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.lib.cell import BENCH_DIR, load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    with open(os.path.join(BENCH_DIR, "limits",
                           args.workload + ".json")) as f:
        limits = {k: v["limit"] for k, v in json.load(f).items()}
    run = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace),
                            T_PROCESS, device, limits)

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = cell.metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        values = end_to_end(run)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips,
                   "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": run.correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info}
    if args.trace:
        tr = run.trace
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    checks = {}
    for name, value, limit in run.checks:
        checks[name] = {"value": value if value == value
                        and abs(value) != math.inf else None,
                        "limit": limit}
    result["checks"] = checks
    print(f"workload={args.workload} seed={args.seed} iterations="
          f"{run.iterations} window_s={run.window_s} reference_s="
          f"{run.notes.get('reference_s')} "
          f"intervals_median_ms="
          f"{statistics.median(run.intervals_ms) if run.intervals_ms else None}"
          f" intervals_max_ms="
          f"{max(run.intervals_ms) if run.intervals_ms else None}",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    # last, after every metric's reader ran: whatever the run or a reader
    # loaded counts
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}: no result",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
