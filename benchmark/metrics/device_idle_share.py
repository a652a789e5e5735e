"""device_idle_share: 1 - (union of the device's kernel, memcpy and
memset intervals in the traced window) / the window, from the profiler's
trace.  Layer: the device.  Moves props_per_s."""


def read(run):
    tr = run.trace
    if not tr.device or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s() / tr.window_s
