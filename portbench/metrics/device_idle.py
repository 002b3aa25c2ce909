"""device_idle (layer device): the share of the traced window in which no
operation ran on the device (1 - the union of the operations' intervals
over the window), in percent."""

from portbench import devtrace


def read(rec) -> float | None:
    lo, hi = rec.window_ns
    if hi <= lo or not rec.device_ops:
        return None
    return (1 - devtrace.busy_ns(rec.device_ops, lo, hi) / (hi - lo)) * 100
