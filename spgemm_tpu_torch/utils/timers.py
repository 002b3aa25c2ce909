"""Per-phase wall-clock timers and event counters for the CLI's `-v` report."""

from __future__ import annotations

import contextlib
import logging
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

    def log_report(self):
        with self._lock:
            totals, counts = dict(self.totals), dict(self.counts)
            counters = dict(self.counters)
        for name, total in totals.items():
            log.info("phase %s: %.4fs (x%d)", name, total, counts.get(name, 0))
        for name, n in counters.items():
            log.info("counter %s: %d", name, n)
