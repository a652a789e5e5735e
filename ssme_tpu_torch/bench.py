#!/usr/bin/env python
"""Benchmark: the flagship PMMH workload on one CUDA card.

Counterpart of ``bench.py``'s flagship mode: univariate-SVOL adaptive
PMMH over the T=3084 SPY daily returns (``data/spy_returns.csv``), C=64
chains x R=4 replicates x N=512 particles, 30 MH iterations, every
likelihood from one launch of the CUDA filter kernel per iteration.

Metric: particle propagations per second per card =
iters * chains * replicates * particles * T / wall time of the window
(host clock around work that ends in ``torch.cuda.synchronize()``).

Two schedules: ``parity`` resamples every step (ess_threshold=1.0,
gate_stride=1); ``adaptive`` resamples when ESS < 0.5 N with LSE/ESS
checks every ``BENCH_GATE_STRIDE`` (default 8) steps.

Run: ``python -m ssme_tpu_torch.bench`` (env BENCH_PARTICLES,
BENCH_REPLICATES, BENCH_CHAINS, BENCH_ITERS, BENCH_GATE_STRIDE,
BENCH_ESS override the workload).  Prints ONE JSON line with the keys of
``bench.py`` and ``"impl": "cuda"``, plus the card's name and power
limit, the wall time per MH iteration, and from one more window traced
with ``torch.profiler`` the device's busy share and its time per
iteration by kernel.  Without a card it raises: it never measures the
CPU.

``BENCH_MODE=scaling`` (from ``bench.py``'s scaling mode) sweeps the
chain axis over 1, 2, 4, ... ranks up to D, one card a rank: D is the
card count, or ``WORLD_SIZE`` under ``torchrun`` (``torchrun
--nproc-per-node D -m ssme_tpu_torch.bench``); without ``torchrun`` it
spawns the ranks itself.  Each row runs ``BENCH_CHAINS`` (default 2)
chains a rank through ``parallel.sharded_pmmh`` with the SVOL kernel's
hook (N=256, R=2, 10 iterations, the first 512 SPY returns by default)
and prints JAX's keys: ``pmmh_chain_scaling``, the ``rows`` with
props/s and parallel efficiency, plus the card's name and power limit.
A row's props/s is the best of ``SCALING_WINDOWS`` windows (JAX's is the
best of 2), beside their median and least: the host's jitter spreads
the windows.
"""

import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "spy_returns.csv")
BASELINE = 1e8  # north-star props/s per device (BASELINE.json)
SCALING_WINDOWS = 9


def gpu_identity() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it, in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.split()[0]) * 1e6


def _short(kernel_name: str) -> str:
    """A kernel's name without its template and argument lists."""
    name = kernel_name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ")
    return re.split(r"[<(]", name)[0]


def device_share(run, iters):
    """Run ``run()`` (``iters`` MH iterations) under ``torch.profiler``:
    returns (device busy share of the window's wall time, device ms per
    iteration by kernel name), or (None, {}) if the trace holds no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for evt in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): a CPU op's
        # device time repeats that of the kernels it launched
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and evt.device_time_total > 0:
            by_kernel[_short(evt.key)] = (by_kernel.get(_short(evt.key), 0.0)
                                          + evt.device_time_total / 1e3 / iters)
    if not by_kernel:
        return None, {}
    busy = sum(by_kernel.values()) * iters / 1e3 / wall
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5])
    return busy, top


def measure(num_particles, num_replicates, num_chains, num_iters, ys,
            ess_threshold, gate_stride, windows=2):
    """Best-of-``windows`` seconds for ``num_iters`` MH iterations after
    one warm-up window, then one profiled window; returns (seconds,
    device busy share, device ms per iteration of the top kernels)."""
    from ssme_tpu_torch.inference import AdaptivePMMH
    from ssme_tpu_torch.models import svol
    from ssme_tpu_torch.ops.svol_filter_kernel import svol_batched_log_like

    pmmh = AdaptivePMMH(
        svol.make_model(), num_particles=num_particles,
        num_replicates=num_replicates, t0=150, t1=1000,
        batched_log_like=svol_batched_log_like(
            num_particles, num_replicates, ess_threshold=ess_threshold,
            gate_stride=gate_stride if ess_threshold < 1.0 else 1))
    state = pmmh.init(0, svol.START_TRANS_THETA, ys, num_chains=num_chains)
    res = pmmh.run_from(state, num_iters, ys)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        res = pmmh.run_from(res.final_state, num_iters, ys)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    state = res.final_state
    busy, top = device_share(lambda: pmmh.run_from(state, num_iters, ys),
                             num_iters)
    return best, busy, top


def scaling_rank(device_type, counts, num_particles, num_replicates,
                 chains_per_dev, num_iters, t_sub):
    """One rank's part of the chain-axis sweep (every rank of the default
    group runs it): for each d in ``counts`` the first d ranks run
    ``chains_per_dev * d`` chains, split over a d x 1 mesh, through
    ``SCALING_WINDOWS`` timed windows after a warm-up; returns the rows (a
    window's time is its slowest rank's; props/s from the best window,
    as JAX's, with the median and the range over the windows; a rank
    outside a row's mesh holds None there, so rank 0's rows are the
    sweep's)."""
    import torch.distributed as dist

    from ssme_tpu_torch import parallel
    from ssme_tpu_torch.inference import AdaptivePMMH
    from ssme_tpu_torch.io import read_data
    from ssme_tpu_torch.models import svol
    from ssme_tpu_torch.ops.svol_filter_kernel import svol_batched_log_like

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    ys = torch.as_tensor(read_data(DATA, num_cols=1)[:t_sub], device=dev)
    t_len = int(ys.shape[0])
    pmmh = AdaptivePMMH(svol.make_model(), num_particles=num_particles,
                        num_replicates=num_replicates, t0=150, t1=1000,
                        batched_log_like=svol_batched_log_like(
                            num_particles, num_replicates))
    rows, base = [], None
    for d in counts:
        mesh = parallel.make_mesh(d, 1, ranks=range(d))
        c = chains_per_dev * d
        secs = torch.zeros(SCALING_WINDOWS, dtype=torch.float64,
                           device=dev)
        if dist.get_rank() < d:
            run = parallel.sharded_pmmh(pmmh, mesh, num_iters)
            state = parallel.shard_chain_state(
                pmmh.init(0, svol.START_TRANS_THETA, ys, num_chains=c), mesh)
            res = run(state, ys)               # warm-up: builds the kernel
            sync()
            group = mesh.get_group("chain")
            for w in range(SCALING_WINDOWS):
                dist.barrier(group=group)
                t0 = time.perf_counter()
                res = run(res.final_state, ys)
                sync()
                secs[w] = time.perf_counter() - t0
            dist.all_reduce(secs, op=dist.ReduceOp.MAX, group=group)
        dist.barrier()
        row = {"devices": d, "chains": c, "props_per_sec": None,
               "parallel_efficiency": None}
        if dist.get_rank() < d:
            props = num_iters * c * num_replicates * num_particles * t_len
            thr = sorted(props / float(x) for x in secs.cpu())
            row.update(props_per_sec=thr[-1],
                       props_per_sec_median=thr[len(thr) // 2],
                       props_per_sec_min=thr[0], windows=SCALING_WINDOWS)
            if d == counts[0]:
                base = thr[-1]
            if base is not None:
                row["parallel_efficiency"] = thr[-1] / (base * d / counts[0])
        rows.append(row)
    return rows


def scaling_main():
    """``BENCH_MODE=scaling``: the sweep on the cards (see the module
    note); prints one JSON line."""
    from ssme_tpu_torch import parallel

    args = (int(os.environ.get("BENCH_PARTICLES", 256)),
            int(os.environ.get("BENCH_REPLICATES", 2)),
            int(os.environ.get("BENCH_CHAINS", 2)),
            int(os.environ.get("BENCH_ITERS", 10)),
            int(os.environ.get("BENCH_T", 512)))
    under_torchrun = "TORCHELASTIC_RUN_ID" in os.environ
    world = (int(os.environ["WORLD_SIZE"]) if under_torchrun
             else torch.cuda.device_count())
    counts = tuple(d for d in (1, 2, 4, 8, 16, 32) if d <= world)
    if under_torchrun:
        parallel.initialize_distributed(device="cuda")
        rows = scaling_rank("cuda", counts, *args)
        rank = torch.distributed.get_rank()
        torch.distributed.destroy_process_group()
        if rank != 0:
            return
    else:
        rows = parallel.spawn_local(scaling_rank, world, "cuda",
                                    args=("cuda", counts) + args,
                                    timeout=1800.0)[0]
    for r in rows:
        print(f"devices={r['devices']:3d} chains={r['chains']:4d} "
              f"props/s={r['props_per_sec']:.6e} (median "
              f"{r['props_per_sec_median']:.6e}, least "
              f"{r['props_per_sec_min']:.6e} of {r['windows']} windows) "
              f"efficiency={r['parallel_efficiency']:.6f}", file=sys.stderr)
    print(json.dumps({
        "metric": "pmmh_chain_scaling",
        "value": rows[-1]["parallel_efficiency"],
        "unit": "parallel_efficiency_at_max_devices",
        "vs_baseline": rows[-1]["parallel_efficiency"],
        "platform": "gpu",
        "rows": rows,
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "nvidia_smi": gpu_identity(),
        "config": dict(zip(("particles", "replicates", "chains_per_device",
                            "iters", "t"), args)),
    }), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ssme_tpu_torch.bench: no CUDA device; the "
                         "benchmark measures the card only")
    if os.environ.get("BENCH_MODE") == "scaling":
        scaling_main()
        return
    from ssme_tpu_torch.io import read_data

    num_particles = int(os.environ.get("BENCH_PARTICLES", 512))
    num_replicates = int(os.environ.get("BENCH_REPLICATES", 4))
    num_chains = int(os.environ.get("BENCH_CHAINS", 64))
    num_iters = int(os.environ.get("BENCH_ITERS", 30))
    gate_stride = int(os.environ.get("BENCH_GATE_STRIDE", 8))
    ess = float(os.environ.get("BENCH_ESS", 0.5))
    ys = torch.as_tensor(read_data(DATA, num_cols=1), device="cuda")
    t_len = int(ys.shape[0])
    props = num_iters * num_chains * num_replicates * num_particles * t_len

    t_parity, busy_parity, top_parity = measure(
        num_particles, num_replicates, num_chains, num_iters, ys, 1.0, 1)
    t_adaptive, busy_adaptive, top_adaptive = measure(
        num_particles, num_replicates, num_chains, num_iters, ys, ess,
        gate_stride)
    parity, adaptive = props / t_parity, props / t_adaptive
    print(json.dumps({
        "metric": "pmmh_particle_propagations_per_sec_per_chip",
        "value": adaptive,
        "unit": "propagations/s/chip",
        "vs_baseline": adaptive / BASELINE,
        "parity": parity,
        "adaptive": adaptive,
        "impl": "cuda",
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": gpu_identity(),
        "iteration_ms": {"parity": 1e3 * t_parity / num_iters,
                         "adaptive": 1e3 * t_adaptive / num_iters},
        "device_busy_share": {"parity": busy_parity,
                              "adaptive": busy_adaptive},
        "device_ms_per_iteration": {"parity": top_parity,
                                    "adaptive": top_adaptive},
    }))
    print(f"config: T={t_len} N={num_particles} R={num_replicates} "
          f"C={num_chains} iters={num_iters} gate_stride={gate_stride} "
          f"parity={parity:.6e} ({t_parity:.6f}s) "
          f"adaptive={adaptive:.6e} ({t_adaptive:.6f}s)", file=sys.stderr)


if __name__ == "__main__":
    main()
