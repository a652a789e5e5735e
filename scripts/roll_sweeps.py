#!/usr/bin/env python
"""Sweeps of the rejection resampler on ``chip_smoke.py`` phase 23's path,
and the generic kernel's time per launch there, as one JSON line.

    python scripts/roll_sweeps.py [ROOT] [--label NAME] [--iters 10]
        [--extra 2] [--twin] [--save-inputs F.pt] [--inputs F.pt]

Phase 23 runs adaptive PMMH on SVOL over SPY (C=64 chains x R=4
replicates, N=2048 particles, ESS 0.5) through
``megakernel_log_like(resampler="rejection")``: one generic-kernel
(K2) launch per MH iteration.  This script runs that path for
``--iters`` iterations (wall ms per iteration, as phase 23 reports it)
and ``--extra`` more (phase 23 profiles two after its timed ten),
records each launch's inputs (the seed words and the (B, 3) kernel
rows), and then times each launch again on its own by CUDA events
(``kernel_ms``, one warm-up launch first).  ``--inputs`` replays launch
inputs saved by ``--save-inputs`` instead of running the chain, so that
two trees (ROOT, as in ``scripts/kernel_timing.py``) can be timed on the
same launches in turns within one call.

``--twin`` replays every launch through the generic kernel's
instrumented svol twin under rejection (``step_spans``: the kernel's
own path, bits and law) and reports per launch:

- ``sweeps``: sweeps a resample ran (1 + its last slot's accept sweep,
  4096 at the cap): median, 99th percentile, maximum, and the share of
  resamples that reached the cap;
- ``ratio``: max weight / mean weight of a resample (median, 99th
  percentile), and at the resamples of the 1% most sweeps;
- ``top_rows``: the rows with the most sweeps over the launch (their
  theta, resamples, total and largest sweeps, largest ratio) beside the
  median row's total: a block runs its row's resamples one after
  another, so these rows set the launch's time;
- the votes and the tail's slots a resample, and the twin's ms.

Needs a CUDA card; imports no JAX.
"""

import argparse
import json
import os
import sys
import time

PHASE23 = dict(chains=64, replicates=4, particles=2048, ess=0.5)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("root", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--label", default=None)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--extra", type=int, default=2)
    p.add_argument("--twin", action="store_true")
    p.add_argument("--save-inputs", default=None)
    p.add_argument("--inputs", default=None)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import ssme_tpu_torch
    from ssme_tpu_torch.bench import gpu_identity
    from ssme_tpu_torch.io import read_data
    from ssme_tpu_torch.ops import filter_megakernel as fmk

    if not ssme_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {ssme_tpu_torch.__file__}, not from "
                           f"{root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: roll_sweeps runs on the card "
                           "only")
    dev = torch.device("cuda")
    ys = torch.as_tensor(read_data(os.path.join(root, "data",
                                                "spy_returns.csv"),
                                   num_cols=1), device=dev)
    out = {"tree": args.label or root,
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": gpu_identity(), **PHASE23,
           "t_len": int(ys.shape[0])}
    kernel = fmk.filter_megakernel
    kw = dict(num_particles=PHASE23["particles"],
              ess_threshold=PHASE23["ess"], resampler="rejection")
    if args.inputs:
        launches = [(s.to(dev), r.to(dev))
                    for s, r in torch.load(args.inputs)]
    else:
        launches, walls = _run_chain(torch, fmk, kernel, ys, args.iters,
                                     args.extra)
        out.update(walls)
    if args.save_inputs:
        torch.save([(s.cpu(), r.cpu()) for s, r in launches],
                   args.save_inputs)
    out["kernel_ms"] = [_event_ms(torch, lambda: kernel(
        fmk.svol_kernel_model(), s, r, ys[:, 0].contiguous(), **kw))
        for s, r in launches]
    if args.twin:
        out["twin"] = [_twin_record(torch, fmk, s, r, ys, kw)
                       for s, r in launches]
    print(json.dumps(out), flush=True)


def _run_chain(torch, fmk, kernel, ys, iters, extra):
    """Phase 23's chain: wall ms per iteration of ``iters`` iterations and
    of ``extra`` more, and every launch's (seed, rows)."""
    from ssme_tpu_torch.inference import AdaptivePMMH
    from ssme_tpu_torch.models import svol

    launches = []

    def recording(kmodel, seed, params, *a, **k):
        launches.append((seed.clone(), params.clone()))
        return kernel(kmodel, seed, params, *a, **k)

    # a ROOT older than ops/_cuda.py's launch table counts each launch on
    # the name the kernel is bound to, here this function
    recording.launches = 0
    model = svol.make_model()
    pmmh = AdaptivePMMH(model, num_particles=PHASE23["particles"],
                        num_replicates=PHASE23["replicates"], t0=150,
                        t1=1000, batched_log_like=fmk.megakernel_log_like(
                            fmk.svol_kernel_model(), PHASE23["particles"],
                            PHASE23["replicates"],
                            constrain=fmk.svol_kernel_rows,
                            ess_threshold=PHASE23["ess"],
                            resampler="rejection", model=model))
    fmk.filter_megakernel = recording
    try:
        state = pmmh.init(0, svol.START_TRANS_THETA, ys,
                          num_chains=PHASE23["chains"])
        walls = {}
        for name, count in (("iters", iters), ("extra", extra)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pmmh.run_from(state, count, ys)
            torch.cuda.synchronize()
            walls[f"wall_ms_per_iteration_{name}"] = (
                (time.perf_counter() - t0) * 1e3 / count)
            state = res.final_state
            walls[f"accepts_{name}"] = int(res.accepted.sum())
    finally:
        fmk.filter_megakernel = kernel
    return launches, walls


def _event_ms(torch, fn):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _quantiles(torch, v, qs=(0.5, 0.99)):
    v = v.double()
    return [float(torch.quantile(v, q)) for q in qs] + [float(v.max())]


def _twin_record(torch, fmk, seed, rows, ys, kw):
    """One launch through the svol twin under rejection: per-launch
    statistics of its resamples' sweeps and ratios, the rows that set its
    time, its votes and tail slots, and the twin's ms."""
    from ssme_tpu_torch.ops import _prng

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rec = fmk.step_spans(seed, rows, ys[:, 0].contiguous(), None,
                         kw["num_particles"],
                         ess_threshold=kw["ess_threshold"],
                         resampler="rejection",
                         kmodel=fmk.svol_kernel_model())
    end.record()
    torch.cuda.synchronize()
    hit = (rec["sweeps"] > 0).cpu()
    if not bool(hit.any()):
        return {"resamples": 0, "twin_ms": start.elapsed_time(end)}
    r = hit.nonzero()[:, 0]
    sweeps = rec["sweeps"].cpu()[hit].long()
    ratio = rec["ratio"].cpu()[hit]
    b = rows.shape[0]
    total = torch.zeros(b, dtype=torch.int64).index_add_(0, r, sweeps)
    count = torch.zeros(b, dtype=torch.int64).index_add_(
        0, r, torch.ones_like(sweeps))
    top_sweeps = sweeps >= torch.quantile(sweeps.double(), 0.99)
    out = {
        "resamples": int(sweeps.numel()),
        "sweeps": dict(zip(("median", "p99", "max"),
                           _quantiles(torch, sweeps)),
                       mean=float(sweeps.double().mean()),
                       cap_share=float((sweeps >= _prng.ROLL_MAX_ITERS)
                                       .double().mean())),
        "ratio": dict(zip(("median", "p99", "max"),
                          _quantiles(torch, ratio)),
                      median_at_top1pct_sweeps=float(torch.quantile(
                          ratio[top_sweeps].double(), 0.5))),
        "row_total_median": float(torch.quantile(total.double(), 0.5)),
        "row_total_max": int(total.max()),
        "votes_per_resample": rec["votes"] / sweeps.numel(),
        "tail_slots_per_resample": rec["tail_slots"] / sweeps.numel(),
        "twin_ms": start.elapsed_time(end),
    }
    top = []
    for row in torch.argsort(total, descending=True)[:3].tolist():
        mine = r == row
        top.append({"row": row, "chain": row // PHASE23["replicates"],
                    "theta": [float(v) for v in rows[row].cpu()],
                    "resamples": int(count[row]),
                    "total_sweeps": int(total[row]),
                    "max_sweeps": int(sweeps[mine].max()),
                    "max_ratio": float(ratio[mine].max())})
    out["top_rows"] = top
    return out


if __name__ == "__main__":
    main()
