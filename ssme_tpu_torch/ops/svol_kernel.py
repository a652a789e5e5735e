"""One fused SVOL propagate + weight step: the CUDA kernel and its plain
PyTorch version.

Replaces ``ssme_tpu/ops/svol_kernel.py::fused_svol_propagate_weight``.
For a (B, N) particle batch with per-row constrained parameters [beta,
phi, sigma] and one observation y shared by every row:

    x'    = phi x + sigma eps,
    logw' = logw - log(2 pi) / 2 - log sd - (y / sd)^2 / 2,  sd = beta e^{x'/2},

with eps the Philox normals of ``ops/_prng.py``: normal i of row b under
the seed's key, counter (i >> 1, 0, b, 0).  The kernel is
``csrc/svol_step.cu`` (one thread per particle pair, the layout that
keeps every warp an SM holds busy; its note says why wider layouts lost
on the card).  With the same seed the plain version draws the same
normals, so x' agrees bit for bit and logw' up to the libraries' log,
exp, sin and cos.  Like the JAX kernel it lies on no entry point's path:
the whole-sequence filter kernels fuse this step themselves.
"""

from __future__ import annotations

import ctypes
import hashlib

import torch

from ssme_tpu_torch.ops import _cuda, _prng

# grid rows of the kernel (blockIdx.y)
MAX_ROWS = 65535


def _validate(seed, y, params, x, logw):
    for name, t in (("params", params), ("x", x), ("logw", logw)):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a tensor")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.ndim != 2 or logw.shape != x.shape:
        raise ValueError(f"x and logw must be one (B, N) shape, got "
                         f"{tuple(x.shape)} and {tuple(logw.shape)}")
    b, n = x.shape
    if not 1 <= b <= MAX_ROWS or n < 2 or n % 2:
        raise ValueError(f"(B, N)=({b}, {n}): B must lie in [1, {MAX_ROWS}] "
                         "and N be even (one thread per particle pair)")
    if params.shape != (b, 3):
        raise ValueError(f"params must be ({b}, 3) [beta, phi, sigma] rows, "
                         f"got {tuple(params.shape)}")
    if isinstance(y, torch.Tensor):
        if y.numel() != 1 or y.dtype != torch.float32 \
                or y.device != x.device:
            raise ValueError("y must be a Python float or a one-element "
                             "float32 tensor on the device of x")
    elif not isinstance(y, (int, float)):
        raise ValueError("y must be a Python float or a one-element tensor")
    seed = _prng.seed_words(seed, device=x.device)
    if seed.device != x.device:
        raise ValueError(f"seed is on {seed.device}, x on {x.device}")
    return seed


def fused_svol_propagate_weight_reference(seed, y, params, x, logw):
    """Plain PyTorch version of :func:`fused_svol_propagate_weight`."""
    seed = _validate(seed, y, params, x, logw)
    b, n = x.shape
    eps = _prng.normals_steps(seed, torch.arange(b, device=x.device),
                              torch.zeros(1, dtype=torch.int64,
                                          device=x.device), n)[0]
    beta, phi, sigma = params[:, 0:1], params[:, 1:2], params[:, 2:3]
    x_new = phi * x + sigma * eps
    sd = beta * torch.exp(0.5 * x_new)
    # a tensor numerator: a Python scalar over a tensor is computed as a
    # reciprocal times the scalar, another rounding than the kernel's divide
    y = y.reshape(()) if isinstance(y, torch.Tensor) \
        else torch.full_like(sd, float(y))
    z = y / sd
    log_g = (-_prng.HALF_LOG_2PI - torch.log(sd)) - 0.5 * z * z
    return x_new, logw + log_g


def fused_svol_propagate_weight(seed, y, params, x, logw):
    """One fused propagate + weight step for a (B, N) SVOL batch.

    seed: (2,) int64 Philox key words on the device of ``x``, or an int
    (vary it per step); y: the step's observation, a Python float or a
    one-element float32 tensor on the device (never read on the host);
    params: (B, 3) float32 constrained [beta, phi, sigma]; x, logw: (B, N)
    float32, N even.  Returns (x', logw').  Launches the CUDA kernel for
    CUDA tensors and runs the plain version for CPU tensors.
    """
    seed = _validate(seed, y, params, x, logw)
    if x.device.type == "cpu":
        return fused_svol_propagate_weight_reference(seed, y, params, x,
                                                     logw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_svol_propagate_weight: unsupported device "
                         f"{x.device}")
    for name, t in (("x", x), ("logw", logw)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned (the kernel "
                             "reads particle pairs)")
    lib = _cuda.library()
    b, n = x.shape
    x_out = torch.empty_like(x)
    logw_out = torch.empty_like(logw)
    y_ptr, y_val = (y.data_ptr(), 0.0) if isinstance(y, torch.Tensor) \
        else (None, float(y))
    err = lib.ssme_svol_step(seed.data_ptr(), y_ptr, y_val,
                             params.data_ptr(), x.data_ptr(),
                             logw.data_ptr(), b, n, x_out.data_ptr(),
                             logw_out.data_ptr(), _cuda.stream_ptr(x.device))
    _cuda.check(err, "ssme_svol_step")
    fused_svol_propagate_weight.launches += 1
    return x_out, logw_out


fused_svol_propagate_weight.launches = 0


# the card's rates the bound uses (H100 SXM: the data sheet's HBM rate;
# per SM and clock, the CUDA C++ Programming Guide's throughput table at
# compute capability 9.0 for special functions and 32-bit multiplies)
PEAK_BYTES_PER_S = 3.35e12
SPECIAL_PER_CLOCK_SM = 16
IMUL_PER_CLOCK_SM = 64


def step_bounds(num_rows, num_particles, sms, clock_hz):
    """The least time of one launch at (B, N), in ms: (bound, "bytes" or
    "operations", byte bound, issue bound), counted from the law.  Bytes:
    x and logw read once, x' and logw' written once, the parameter rows,
    y and the seed.  Issue: the slower of two pipes at ``sms`` SMs and
    ``clock_hz`` (the card's highest SM clock), the special functions
    (per pair a Box-Muller's log, sqrt, sin and cos; per particle the
    weight's exp, log and divide) and the 32 x 32 -> 64-bit multiplies
    (per pair one Philox4x32-10 call, 10 rounds of two), so it stays a
    lower bound whatever else the kernel issues."""
    pairs = num_rows * num_particles // 2
    num_bytes = 16 * num_rows * num_particles + 12 * num_rows + 4 + 16
    byte_ms = num_bytes / PEAK_BYTES_PER_S * 1e3
    issue_ms = max((4 + 2 * 3) * pairs / SPECIAL_PER_CLOCK_SM,
                   20 * pairs / IMUL_PER_CLOCK_SM) / (sms * clock_hz) * 1e3
    return (max(byte_ms, issue_ms),
            "bytes" if byte_ms >= issue_ms else "operations", byte_ms,
            issue_ms)


def launch_grid(num_rows, num_particles):
    """(grid x, grid y, threads a block) of the kernel's launch at (B, N)
    on the current card."""
    out = (ctypes.c_int * 3)()
    _cuda.check(_cuda.library().ssme_svol_step_grid(num_rows, num_particles,
                                                    out),
                "ssme_svol_step_grid")
    return tuple(out)


def empty_launch(grid, device):
    """One launch of an empty kernel on ``grid`` (as :func:`launch_grid`
    gives it): the card's floor for a launch of that geometry."""
    _cuda.check(_cuda.library().ssme_empty_launch(*grid,
                                                  _cuda.stream_ptr(device)),
                "ssme_empty_launch")


def fixed_inputs(num_rows, num_particles, device):
    """(params, x, logw) of the bit checks, made from an integer hash of
    the element index with exact float arithmetic, so that every machine
    makes the same floats: beta in [0.5, 1.5), phi in [0.8, 0.99), sigma
    in [0.05, 0.35), x in [-2, 2), logw in (-8, 0]."""
    def unit(i, c):  # 24 random bits in [0, 1), exact
        return (((i * 2654435761 + c) & 0xFFFFFFFF) >> 8).to(
            torch.float32) * 2.0 ** -24
    i = torch.arange(num_rows * num_particles, dtype=torch.int64,
                     device=device)
    r = torch.arange(num_rows, dtype=torch.int64, device=device)
    params = torch.stack([0.5 + unit(r, 3), 0.8 + 0.19 * unit(r, 4),
                          0.05 + 0.3 * unit(r, 5)], dim=-1).contiguous()
    x = (unit(i, 1) * 4.0 - 2.0).reshape(num_rows, num_particles)
    logw = (unit(i, 2) * -8.0).reshape(num_rows, num_particles)
    return params, x, logw


_DIGEST_P = 2147483629  # a prime below 2^31


def digest(*tensors):
    """16 hex digits that change with any bit of the tensors' float32
    values or their order, computed with integer sums on the tensors'
    device (the order of an integer sum does not change it)."""
    parts = []
    for t in tensors:
        v = t.contiguous().view(torch.int32).reshape(-1).to(
            torch.int64) & 0xFFFFFFFF
        w = (torch.arange(v.numel(), dtype=torch.int64, device=v.device)
             * 40503 + 1) % _DIGEST_P
        parts += [int(v.sum()), int((v * w % _DIGEST_P).sum())]
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]


__all__ = ["fused_svol_propagate_weight",
           "fused_svol_propagate_weight_reference", "step_bounds",
           "launch_grid", "empty_launch", "fixed_inputs", "digest"]
