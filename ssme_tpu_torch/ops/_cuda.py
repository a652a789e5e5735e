"""Build and load the port's hand-written CUDA kernels.

The sources in ``ssme_tpu_torch/csrc/`` expose a plain C interface.  At
first use each ``.cu`` file is compiled by its own ``nvcc`` for
``sm_90a``, all of them at once, and the objects are linked into one
shared library under ``ssme_tpu_torch/_build/`` whose name carries a hash
of the sources, loaded with ``ctypes``; ptxas' register and spill lines
are kept beside it (``build_info["ptxas"]``).  Nothing here runs at import time:
a machine without ``nvcc`` or a card can import every module, and only a
call on a CUDA tensor reaches :func:`library`, which raises if the build
fails.  Its first call is the ``profiling`` span ``kernels.library``
(whose self time is the sources' hash), with the children
``kernels.library.build`` (nvcc, when it builds) and
``kernels.library.load`` (``dlopen`` and the signatures).

Every C call of ``ops/`` goes through :func:`call`, and every kernel
launch through :func:`launch`, which counts it in one table by (entry,
key): the CUDA instance for the generic filter kernel, the layout for
the Liu-West kernel, None elsewhere.  An instrumented twin counts under
its own ``*_spans`` entry, so a kernel's count leaves its twins out.
:func:`launches` reads the table.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

from ssme_tpu_torch import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_SIGNATURES = {
    # model id, apf, seed, params, ys, zs, B, T, N, ess_limit, always,
    # gate_stride, resampler, metropolis_iters, total, lcl, fmean, cloud,
    # cloud_lw, stream
    "ssme_filter_megakernel": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                               _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # model id, apf, seed, params, ys, zs, B, T, N, ess_limit, always,
    # gate_stride, resampler, metropolis_iters, total, lcl, fmean, spans,
    # sweeps, ratio (each or null), stream
    "ssme_filter_megakernel_spans": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _F,
                                     _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                     _P],
    # model id, seed, ys, zs, F, T, N, apf, resample_every, ess_limit,
    # resampler, metropolis_iters, cluster, coefs, prior_lo, prior_scale,
    # model_args (host arrays), lcl, fpaths, cloud, stream
    "ssme_lw_megakernel": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                           _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # model id, seed, ys, zs, F, T, N, apf, resample_every, ess_limit,
    # resampler, metropolis_iters, cluster, coefs, prior_lo, prior_scale,
    # model_args (host arrays), lcl, fpaths, cloud, spans, stream
    "ssme_lw_megakernel_spans": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                 _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P],
    # model id, N, count (host int)
    "ssme_lw_megakernel_clusters": [_I, _I, _P],
    # seed, params, ys, B, T, N, ess_limit, always, gate_stride,
    # resampler, metropolis_iters, total, lcl, xmean, spans (or null),
    # stream
    "ssme_svol_filter": [_P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _P, _P,
                         _P, _P, _P],
    # w, leaves, u0, L, B, N, kper, picked, ancestors, cdf (or null), stream
    "ssme_systematic_select": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    # w, leaves, seed, step, tag, resampler, metropolis_iters, L, B, N,
    # picked, ancestors, stream
    "ssme_roll_select": [_P, _P, _P, _U, _U, _I, _I, _I, _I, _I, _P, _P,
                         _P],
    # seed, B, N/2, step, bits, u1, u2, normals, offsets, stream
    "ssme_philox_fill": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # seed, y (device pointer or null), y value, params, x, logw, B, N,
    # x_out, logw_out, stream
    "ssme_svol_step": [_P, _P, _F, _P, _P, _P, _I, _I, _P, _P, _P],
    # B, N, out (3 host ints: grid x, grid y, threads)
    "ssme_svol_step_grid": [_I, _I, _P],
    # grid x, grid y, threads, stream
    "ssme_empty_launch": [_I, _I, _I, _P],
}

# the profiling spans opened here
HOST_SPANS = ("kernels.library", "kernels.library.build",
              "kernels.library.load")

# entries that share another's C function: the SVOL kernel's twin is
# its entry with a record pointer
_ALIASES = {"ssme_svol_filter_spans": "ssme_svol_filter"}

_lock = threading.Lock()
_lib = None
build_info = {}
# launches by (entry, key), written by launch() alone
_launches = {}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")
    return path


def _library_path() -> str:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libssme_kernels_{digest.hexdigest()[:16]}.so")


def _run(procs):
    """Wait for every (name, Popen) and raise on the first failure."""
    logs = []
    for name, proc in procs:
        out, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):"
                               f"\n{out}\n{err}")
        logs.append(err)
    return logs


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        try:
            for src in (s for s in _sources() if s.endswith(".cu")):
                obj = os.path.join(tmp, os.path.basename(src) + ".o")
                objs.append(obj)
                procs.append((src, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            logs = _run(procs)
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = os.path.join(tmp, "lib.so")
        _run([("link", subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        ptxas = [ln for log in logs for ln in log.splitlines()
                 if "registers" in ln or "Compiling" in ln or "spill" in ln]
        with open(path + ".ptxas", "w") as f:
            f.write("\n".join(ptxas))
        os.replace(lib, path)
    build_info["ptxas"] = ptxas


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use; raises when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with profiling.span("kernels.library"):
            path = _library_path()
            if not os.path.exists(path):
                with profiling.span("kernels.library.build") as built:
                    _build(path)
                # None only for a build after a failed one, with no
                # recording on: the first occurrence is always recorded
                if built is not None:
                    build_info["seconds"] = built.seconds
            else:
                build_info.setdefault("seconds", 0.0)
                with open(path + ".ptxas") as f:
                    build_info.setdefault("ptxas", f.read().splitlines())
            with profiling.span("kernels.library.load"):
                lib = ctypes.CDLL(path)
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            build_info["path"] = path
            _lib = lib
            return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def call(entry: str, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and raise through
    :func:`check` on an error: the path of every launch, and of the
    queries that launch nothing, which are not counted."""
    check(getattr(library(), _ALIASES.get(entry, entry))(*args), entry)


def launch(entry: str, *args, device, key=None) -> None:
    """Launch ``entry`` on ``device``'s current stream (appended to
    ``args``) and count it under (``entry``, ``key``)."""
    call(entry, *args, stream_ptr(device))
    _launches[entry, key] = _launches.get((entry, key), 0) + 1


def launches(entry: str, key=...) -> int:
    """The launches of ``entry`` under ``key``, or under every key when
    none is given."""
    if key is ...:
        return sum(n for (e, _), n in _launches.items() if e == entry)
    return _launches.get((entry, key), 0)


__all__ = ["library", "check", "stream_ptr", "call", "launch", "launches",
           "build_info", "BUILD_DIR"]
