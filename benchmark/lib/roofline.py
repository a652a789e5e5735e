"""Peaks of the card and the least time of a layer's work.

The peaks and the per-propagation operation counts are copied from
``chip_smoke.py`` at commit 979befa (``PEAK_F32_PER_S``,
``PEAK_BYTES_PER_S``, ``STEP_OPS``, ``bound``); a configuration's
``paths`` entry holds the counts of each layer it runs, frozen there.
Selection inside a gated schedule depends on the data and is not
counted, so a share of the roofline is a lower bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense float32 outside the tensor cores and
# HBM3 bandwidth, at the 700 W limit
PEAK_F32_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _bytes(terms, shape):
    """A byte count written as {"B*T": 8, "B": 4, "1": 16}: each key a
    product of the launch's symbols (B rows, N particles, T steps)."""
    total = 0.0
    for key, coeff in terms.items():
        v = float(coeff)
        for sym in key.split("*"):
            if sym != "1":
                v *= shape[sym]
        total += v
    return total


def launch_ops(layer, shape):
    """Counted float32 operations of one launch."""
    return layer["ops_per_prop"] * shape["B"] * shape["N"] * shape["T"]


def launch_bound_s(layer, shape):
    """The least seconds of one launch: the larger of its operations over
    the float32 peak and its bytes (inputs read once, outputs written
    once) over the memory peak."""
    t_ops = launch_ops(layer, shape) / PEAK_F32_PER_S
    t_bytes = (_bytes(layer["bytes_in"], shape)
               + _bytes(layer["bytes_out"], shape)) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes)


def roofline_share(run):
    """Percent: the bound of every launch in the traced window over the
    device time of every kernel launched inside the benchmark's span
    around the layer; None where the trace links no launch to a span."""
    busy, launches = run.trace.span_device_s(run.layer_span)
    if not busy or not launches:
        return None
    return 100.0 * launches * launch_bound_s(run.layer, run.launch_shape) \
        / busy
