"""chain_p95_s: the 95th percentile, by nearest rank, of the latency of
every request of the window, each from its submit to the synchronize after
it."""

import math


def read(win) -> float:
    lat = sorted(win.latencies)
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
