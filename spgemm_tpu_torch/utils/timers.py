"""Per-phase wall-clock timers and event counters for the CLI's `-v` report.

ENGINE is the process-wide registry of the chain engine's host phases:

  * plan      -- ops/spgemm.plan (join, rounds, assembly permutation), on
                 the plan-ahead worker thread or inline;
  * plan_wait -- how long the dispatching thread waited for a plan (the
                 whole plan when it plans inline, near zero when the
                 worker is ahead);
  * upload    -- ops/spgemm.execute staging each round's indices and the
                 assembly permutation in pinned memory and queueing their
                 copies to the card;
  * stage_prep, dispatch, assembly -- ops/spgemm.spgemm_outofcore's three
                 stages: gathering a round's tiles into pinned memory,
                 its upload and launch, landing its result on the host.

and counters: plan_cache_hits and plan_cache_misses (ops/spgemm.plan),
ooc_rounds and ooc_upload_bytes (spgemm_outofcore).  The CLI resets it
before a run and reports it with `-v`.

maybe_profile wraps a region in torch.profiler for the CLI's --profile."""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

log = logging.getLogger("spgemm_tpu_torch.timers")


class PhaseTimers:
    """Accumulates wall-clock per named phase (re-entrant by name) plus
    named event counters.  Lock-guarded, so worker threads may share one."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def incr(self, name: str, n: int = 1):
        """Bump a named event counter (e.g. 'dispatches' per launch)."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def reset(self):
        """Zero every phase and counter."""
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.counters.clear()

    def snapshot(self) -> dict[str, float]:
        """Seconds per phase."""
        with self._lock:
            return dict(self.totals)

    def log_report(self):
        with self._lock:
            totals, counts = dict(self.totals), dict(self.counts)
            counters = dict(self.counters)
        for name, total in totals.items():
            log.info("phase %s: %.6fs (x%d)", name, total, counts.get(name, 0))
        for name, n in counters.items():
            log.info("counter %s: %d", name, n)


ENGINE = PhaseTimers()


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None, device=None):
    """torch.profiler over the block when trace_dir is set: CPU activity,
    and CUDA activity when `device` is a CUDA device; on exit one Chrome
    trace, trace_<pid>_<ns>.json, is written into trace_dir."""
    if not trace_dir:
        yield None
        return
    import torch  # noqa: PLC0415 -- only a profiled run needs it here

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
