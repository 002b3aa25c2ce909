"""A closed loop of one caller: each request draws its inputs on the device,
then calls the program once and synchronizes; the next request starts when
that one is done.  Its latency runs from the call to the synchronize; the
draw falls inside the window and outside the latency."""

from __future__ import annotations

import sys
import time
import traceback


def run(driver, seed: int, seconds: float, reservoir, spans: bool = False):
    """Requests until `seconds` have passed since the first began; the last
    one runs to its end.  A request that raises ends the window."""
    from portbench.harness import Loop, sync
    if int(driver.mix.get("callers", 1)) != 1:
        raise ValueError(f"portbench: a closed loop has one caller, not {driver.mix['callers']}")
    loop = Loop()
    loop.start = time.perf_counter()
    deadline = loop.start + seconds
    i = 0
    while i == 0 or time.perf_counter() < deadline:
        d0 = time.perf_counter()
        driver.draw(seed, i)
        sync(driver.device)
        loop.attempted += 1
        t0 = time.perf_counter()
        try:
            results = driver.request()
            tc = time.perf_counter()
            sync(driver.device)
        except Exception:  # noqa: BLE001 -- a request that fails is counted and reported
            loop.failed += 1
            traceback.print_exc(file=sys.stderr)
            break
        t1 = time.perf_counter()
        loop.latencies.append(t1 - t0)
        loop.completed += 1
        reservoir.offer(i, results)
        del results
        if spans:
            loop.spans += [("portbench.draw", d0, t0), ("portbench.request", t0, tc),
                           ("portbench.wait", tc, t1)]
        i += 1
    loop.end = time.perf_counter()
    return loop
