"""fold_roofline (layer kernels): the least time of the fold work that the
window's chains need (roofline.py: real pairs x k^3 MACs x 9 integer-pipe
ops at 16.75e12 ops/s, or the bytes at 3.35e12 B/s, whichever is larger)
over the device time of the fold kernels in the trace (kernel 1 and the
dense fold, both instances of `numeric_round_kernel`), in percent."""

from portbench import roofline

KERNEL = "numeric_round_kernel"


def read(rec) -> float | None:
    lo, hi = rec.window_ns
    device_s = sum(min(e, hi) - max(s, lo) for name, s, e in rec.device_ops
                   if KERNEL in name and e > lo and s < hi) / 1e9
    if device_s <= 0 or rec.chains == 0 or rec.work is None:
        return None
    least, _ = roofline.least_seconds(rec.work.scaled(rec.chains))
    return least / device_s * 100
