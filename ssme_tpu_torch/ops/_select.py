"""Systematic ancestor selection that moves all leaves jointly.

Replaces ``ssme_tpu/ops/_select.py::select_leaves_dense``.  The CUDA side
is ``csrc/systematic_select.cuh`` (inlined by the filter kernel; launched
alone by :func:`systematic_select`); this module holds its plain PyTorch
version and that wrapper.

Law, per row: cdf = inclusive float32 cumulative sum of w, total =
cdf[-1], points u_j = min((j + u0) * (total / N), total) and ancestor_j =
the first i with cdf[i] >= u_j, which is the half-open test
cdf[i-1] < u_j <= cdf[i] on the same rounded array (cdf[-1] read as 0).
The kernel's block scan adds in another order than ``torch.cumsum``, so
a point within rounding of a CDF boundary can pick the neighbour.
"""

from __future__ import annotations

import torch

from ssme_tpu_torch.ops import _cuda

MAX_PARTICLES = 1024


def check_particles(n: int) -> None:
    if n % 32 or not 32 <= n <= MAX_PARTICLES:
        raise ValueError(f"num_particles={n} must be a multiple of 32 in "
                         f"[32, {MAX_PARTICLES}] (one CTA of N threads)")


def systematic_points(w, u0):
    """Inclusive CDF (B, N) and clamped systematic points (B, N)."""
    n = w.shape[-1]
    cdf = torch.cumsum(w, dim=-1)
    total = cdf[:, -1:]
    j = torch.arange(n, dtype=w.dtype, device=w.device)[None, :]
    u = torch.minimum((j + u0[:, None]) * (total / n), total)
    return cdf, u


def systematic_ancestors(w, u0):
    """Ancestor indices (B, N), int64, of the plain law above."""
    cdf, u = systematic_points(w, u0)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), side="left")
    return torch.clamp(idx, max=w.shape[-1] - 1)


def systematic_select_reference(w, leaves, u0):
    """Plain version of :func:`systematic_select`."""
    anc = systematic_ancestors(w, u0)
    picked = torch.gather(leaves, 2, anc[None].expand_as(leaves))
    return picked, anc.to(torch.int32)


def _validate(w, leaves, u0):
    if w.ndim != 2 or leaves.ndim != 3 or u0.ndim != 1:
        raise ValueError("expected w (B, N), leaves (L, B, N), u0 (B,)")
    b, n = w.shape
    if leaves.shape[1:] != (b, n) or u0.shape[0] != b or leaves.shape[0] < 1:
        raise ValueError(f"shape mismatch: w {tuple(w.shape)}, leaves "
                         f"{tuple(leaves.shape)}, u0 {tuple(u0.shape)}")
    check_particles(n)
    for name, t in (("w", w), ("leaves", leaves), ("u0", u0)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def systematic_select(w, leaves, u0):
    """Systematic selection of every leaf row by per-row weights.

    ``w``: (B, N) nonnegative float32 weights; ``leaves``: (L, B, N)
    float32, moved by the same ancestors; ``u0``: (B,) offsets in (0, 1).
    Returns (picked (L, B, N), ancestors (B, N) int32).  Launches the CUDA
    kernel for CUDA tensors and runs the plain version for CPU tensors.
    """
    _validate(w, leaves, u0)
    if w.device.type == "cpu":
        return systematic_select_reference(w, leaves, u0)
    if w.device.type != "cuda":
        raise ValueError(f"systematic_select: unsupported device {w.device}")
    lib = _cuda.library()
    num_leaves, b, n = leaves.shape
    picked = torch.empty_like(leaves)
    anc = torch.empty((b, n), dtype=torch.int32, device=w.device)
    err = lib.ssme_systematic_select(w.data_ptr(), leaves.data_ptr(),
                                     u0.data_ptr(), num_leaves, b, n,
                                     picked.data_ptr(), anc.data_ptr(),
                                     _cuda.stream_ptr(w.device))
    _cuda.check(err, "ssme_systematic_select")
    systematic_select.launches += 1
    return picked, anc


systematic_select.launches = 0

__all__ = ["systematic_select", "systematic_select_reference",
           "systematic_ancestors", "systematic_points", "check_particles",
           "MAX_PARTICLES"]
