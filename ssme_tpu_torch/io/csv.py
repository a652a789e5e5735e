"""Headerless CSV data loading and posterior-sample reuse.

PyTorch-package counterpart of ``ssme_tpu/io/csv.py``: the native C++
reader when it builds, a Python parser otherwise.  Returns numpy arrays;
callers move them to a device with ``torch.as_tensor``.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ssme_tpu_torch.native import native_read_csv


def read_data(path: str, num_cols: Optional[int] = None,
              dtype=np.float32) -> np.ndarray:
    """Read a headerless comma-separated file into a (T, num_cols) array;
    malformed rows are reported to stderr and skipped."""
    arr = native_read_csv(path)
    if arr is None:
        rows = []
        with open(path, "r") as f:
            for line_num, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append([float(tok) for tok in line.split(",")])
                except ValueError:
                    print(f"error parsing line {line_num} of {path}",
                          file=sys.stderr)
        if not rows:
            print(f"could not read in data from {path}", file=sys.stderr)
            return np.zeros((0, num_cols or 1), dtype=dtype)
        width = len(rows[0])
        rows = [r for r in rows if len(r) == width]
        arr = np.asarray(rows, dtype=dtype)
    else:
        arr = arr.astype(dtype, copy=False)
    if num_cols is not None and arr.shape[1] != num_cols:
        raise ValueError(
            f"{path}: expected {num_cols} columns, found {arr.shape[1]}")
    return arr


def read_params_csv(path: str, dim_param: Optional[int] = None) -> np.ndarray:
    """Posterior parameter samples from CSV."""
    return read_data(path, num_cols=dim_param)


class ParamSampler:
    """Uniformly-at-random draws, with replacement, from stored posterior
    samples (``ssme_tpu.io.ParamSampler``): a CSV that
    :func:`read_params_csv` reads, or an (M, d) array."""

    def __init__(self, path_or_array, dim_param: Optional[int] = None):
        if isinstance(path_or_array, (str, bytes)):
            arr = read_params_csv(path_or_array, dim_param)
        else:
            arr = path_or_array
        self.samples = torch.as_tensor(arr, dtype=torch.float32)
        if self.samples.ndim != 2 or self.samples.shape[0] == 0:
            raise ValueError("parameter samples must be a nonempty (M, d) "
                             "array")
        if dim_param is not None and self.samples.shape[1] != dim_param:
            raise ValueError(f"expected {dim_param} columns, found "
                             f"{self.samples.shape[1]}")

    def samp(self, generator: torch.Generator,
             num: Optional[int] = None) -> torch.Tensor:
        """(d,) or (num, d) rows drawn with ``generator``, on its
        device."""
        shape = () if num is None else (num,)
        idx = torch.randint(0, self.samples.shape[0], shape,
                            generator=generator, device=generator.device)
        return self.samples.to(generator.device)[idx]


__all__ = ["read_data", "read_params_csv", "ParamSampler"]
