#!/usr/bin/env python
"""Device times of the fused SVOL step kernel (K5) of one or more trees,
beside the card's launch floor and the kernel's bounds, as one JSON line.

    python scripts/k5_timing.py [ROOT ...] [--labels L ...] [--reps 50]
                                [--bits] [--out FILE]

Each ROOT (default: this checkout) is a tree whose
``ssme_tpu_torch/csrc/svol_step.cu`` is compiled alone by ``nvcc`` with
the port's flags into a library of its own, so that two trees are timed
in turns within one call on one card, e.g. a parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists: parent,
change, change, parent.  Every tree's kernel is called through the same
C entry, ``ssme_svol_step``.

At (B, N) = (256, 512), (1024, 2048) and (4096, 4096), per turn:

- ``ms``: the kernel's device time per launch by ``torch.profiler``,
  over ``--reps`` launches that cycle through enough copies of the
  inputs and outputs (at least 200 MB) that each launch finds its inputs
  outside the 50 MB L2 cache, as a caller stepping a large batch would;
- ``event_ms``: CUDA events around the same launches, over their count
  (the host's enqueue paces this at the small shapes);
- ``floor_ms``: an empty kernel on the same grid (the tree's
  ``ssme_svol_step_grid`` where it has one, else one thread a pair in
  blocks of 256 on a (ceil(N / 512), B) grid), by the profiler;
- ``bound_ms``: ``ops/svol_kernel.py::step_bounds``, the larger of the
  bytes over 3.35 TB/s and the issue floor, the special-function
  operations over 16 a clock an SM and the integer multiplies over 64 a
  clock an SM at the card's highest SM clock (``nvidia-smi``'s
  ``clocks.max.sm``): both pipes' published rates (CUDA C++ Programming
  Guide, compute capability 9.0), so it stays a lower bound.

``--bits`` adds, per tree, ``ops/svol_kernel.py::digest`` of the outputs
on ``fixed_inputs`` at every shape of ``SHAPES_BITS`` (seed 5, y 0.37)
and whether x' equals the plain version's bit for bit.  The ptxas lines
of each build (registers, spills) are in ``ptxas``.

Needs a CUDA card; imports no JAX.
"""

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from ssme_tpu_torch.bench import (device_share, gpu_identity,  # noqa: E402
                                  max_sm_clock_hz)
from ssme_tpu_torch.ops import _cuda  # noqa: E402
from ssme_tpu_torch.ops import svol_kernel as k5  # noqa: E402

SHAPES = ((256, 512), (1024, 2048), (4096, 4096))
# the bit checks' shapes: rows 1, 3 and the most the wrapper takes, at
# odd and even counts of pairs, partial blocks and rows off 16 bytes
SHAPES_BITS = tuple((b, n) for b in (1, 3) for n in (2, 4, 6, 8, 10, 12,
                                                      14, 20, 130, 516,
                                                      4098, 4100)) \
    + tuple((65535, n) for n in (2, 6, 130, 4098)) + SHAPES
ROTATE_BYTES = 200e6


def build(root):
    """(ctypes library, ptxas lines) of ROOT's svol_step.cu alone."""
    src = os.path.join(root, "ssme_tpu_torch", "csrc", "svol_step.cu")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    lib = os.path.join(_cuda.BUILD_DIR, f"k5_{tag}.so")
    out = subprocess.run(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", lib, src],
        capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{out.stderr}")
    dll = ctypes.CDLL(lib)
    dll.ssme_svol_step.argtypes = _cuda._SIGNATURES["ssme_svol_step"]
    dll.ssme_svol_step.restype = ctypes.c_int
    if hasattr(dll, "ssme_empty_launch"):
        dll.ssme_empty_launch.argtypes = _cuda._SIGNATURES[
            "ssme_empty_launch"]
    ptxas = [ln for ln in out.stderr.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return dll, ptxas


def tree_grid(dll, b, n):
    if hasattr(dll, "ssme_svol_step_grid"):
        out = (ctypes.c_int * 3)()
        dll.ssme_svol_step_grid(b, n, out)
        return tuple(out)
    return ((n // 2 + 255) // 256, b, 256)


def step_call(dll, seed, params, x, lw, x_out, lw_out):
    b, n = x.shape
    err = dll.ssme_svol_step(seed.data_ptr(), None, 0.37, params.data_ptr(),
                             x.data_ptr(), lw.data_ptr(), b, n,
                             x_out.data_ptr(), lw_out.data_ptr(),
                             _cuda.stream_ptr(x.device))
    _cuda.check(err, "ssme_svol_step")


def device_ms(run, name, reps):
    """Device ms a launch of kernel ``name`` over the ``reps`` launches of
    ``run()``, by torch.profiler."""
    _, top = device_share(run, reps)
    if name not in top:
        raise RuntimeError(f"no device time for {name} in the trace: {top}")
    return top[name]


def time_shape(dll, floor_lib, dev, b, n, reps):
    copies = max(1, math.ceil(ROTATE_BYTES / (16 * b * n)))
    seed = torch.tensor([5, 0], dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(b * 7919 + n)
    params = torch.tensor([[1.3, 0.97, 0.2]] * b, device=dev)
    bufs = [[torch.randn((b, n), generator=gen, device=dev)
             for _ in range(4)] for _ in range(copies)]

    def launches():
        for k in range(reps):
            step_call(dll, seed, params, *bufs[k % copies])

    launches()
    ms = device_ms(launches, "svol_step_kernel", reps)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launches()
    end.record()
    torch.cuda.synchronize()
    grid = tree_grid(dll, b, n)

    def empties():
        for _ in range(reps):
            _cuda.check(floor_lib.ssme_empty_launch(
                *grid, _cuda.stream_ptr(dev)), "ssme_empty_launch")

    empties()
    floor_ms = device_ms(empties, "empty_kernel", reps)
    del bufs
    torch.cuda.empty_cache()
    return {"ms": ms, "event_ms": start.elapsed_time(end) / reps,
            "floor_ms": floor_ms, "grid": list(grid), "copies": copies}


def bits(dll, dev):
    out = {}
    for b, n in SHAPES_BITS:
        params, x, lw = k5.fixed_inputs(b, n, dev)
        x_out, lw_out = torch.empty_like(x), torch.empty_like(lw)
        seed = torch.tensor([5, 0], dtype=torch.int64, device=dev)
        step_call(dll, seed, params, x, lw, x_out, lw_out)
        torch.cuda.synchronize()
        plain_x, _ = k5.fused_svol_propagate_weight_reference(
            seed, 0.37, params, x, lw)
        out[f"{b}x{n}"] = {"digest": k5.digest(x_out, lw_out),
                           "x_equals_plain": bool(torch.equal(x_out,
                                                              plain_x))}
        del params, x, lw, x_out, lw_out, plain_x
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("roots", nargs="*", default=[HERE])
    p.add_argument("--labels", nargs="*", default=None)
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--bits", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k5_timing: needs a CUDA card")
    labels = args.labels or [os.path.basename(os.path.abspath(r))
                             for r in args.roots]
    if len(labels) != len(args.roots):
        raise SystemExit("one label per ROOT")
    dev = torch.device("cuda")
    libs = {}
    for root in [HERE] + args.roots:
        key = os.path.abspath(root)
        if key not in libs:
            libs[key] = build(key)
    floor_lib = libs[HERE][0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    rec = {"card": gpu_identity(), "sms": sms, "max_sm_clock_hz": clock,
           "bounds": {}, "turns": [], "ptxas": {}}
    for b, n in SHAPES:
        bnd, by, byte_ms, issue_ms = k5.step_bounds(b, n, sms, clock)
        rec["bounds"][f"{b}x{n}"] = {"bound_ms": bnd, "bound_by": by,
                                     "byte_ms": byte_ms,
                                     "issue_ms": issue_ms}
    for root, label in zip(args.roots, labels):
        dll, ptxas = libs[os.path.abspath(root)]
        rec["ptxas"][label] = ptxas
        turn = {"label": label, "root": root, "shapes": {}}
        for b, n in SHAPES:
            turn["shapes"][f"{b}x{n}"] = time_shape(dll, floor_lib, dev, b,
                                                    n, args.reps)
        if args.bits:
            turn["bits"] = bits(dll, dev)
        rec["turns"].append(turn)
        print(label, json.dumps(turn["shapes"]), file=sys.stderr,
              flush=True)
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
