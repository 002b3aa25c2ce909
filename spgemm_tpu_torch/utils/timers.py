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
ooc_rounds and ooc_upload_bytes (spgemm_outofcore), and the launches of
each CUDA kernel (launches_<kernel>, bumped by its wrapper where it
launches and nowhere else: the only launch count there is).  The CLI
resets it before a run and reports it with `-v`; the daemon
(serve/daemon.py) reads each job's share through a PhaseScope, and a
launch that serves several jobs at once (a cross-job batch) counts once
here and once in each of their scopes; chip_smoke.py zeroes the launch
counters (zero("launches_")) before a main path and reads them after.

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
    named event counters.  Lock-guarded, so worker threads may share one.

    Per-job attribution (the JAX package's utils/timers.py): scope() opens
    a PhaseScope bound to the calling thread, and accumulation lands in a
    scope only from a thread that carries it, so two open scopes (a wedged
    executor's job and the next job on its replacement) never count each
    other's work.  A worker thread doing a job's work (chain.py's planner)
    adopts the job's scopes with attributed(attribution())."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.counters: dict[str, int] = {}
        # thread ident -> the PhaseScopes that thread's accumulation feeds
        self._sinks: dict[int, list] = {}
        self._lock = threading.Lock()

    def _add_phase_locked(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        for sink in self._sinks.get(threading.get_ident(), ()):
            sink._add_phase_locked(name, dt)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._add_phase_locked(name, dt)

    def record(self, name: str, seconds: float):
        """Accumulate a duration measured elsewhere under a phase name."""
        with self._lock:
            self._add_phase_locked(name, seconds)

    def incr(self, name: str, n: int = 1):
        """Bump a named event counter (e.g. 'dispatches' per launch)."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
            for sink in self._sinks.get(threading.get_ident(), ()):
                sink.counters[name] = sink.counters.get(name, 0) + n

    def zero(self, prefix: str) -> None:
        """Drop the counters whose names start with prefix (they read 0);
        open scopes keep what they hold."""
        with self._lock:
            for name in [n for n in self.counters if n.startswith(prefix)]:
                del self.counters[name]

    def reset(self):
        """Zero every phase and counter; open scopes keep what they hold."""
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.counters.clear()

    def snapshot(self) -> dict[str, float]:
        """Seconds per phase."""
        with self._lock:
            return dict(self.totals)

    def counter_snapshot(self) -> dict[str, int]:
        """The event counters."""
        with self._lock:
            return dict(self.counters)

    def log_report(self):
        with self._lock:
            totals, counts = dict(self.totals), dict(self.counts)
            counters = dict(self.counters)
        for name, total in totals.items():
            log.info("phase %s: %.6fs (x%d)", name, total, counts.get(name, 0))
        for name, n in counters.items():
            log.info("counter %s: %d", name, n)

    def scope(self) -> "PhaseScope":
        """A per-job collector bound to the calling thread (see the class
        docstring); close() detaches it."""
        return PhaseScope(self)

    def attribution(self) -> tuple:
        """Opaque token: the calling thread's open scopes, for a worker
        thread doing this thread's work to adopt with attributed()."""
        with self._lock:
            return tuple(self._sinks.get(threading.get_ident(), ()))

    @contextlib.contextmanager
    def attributed(self, token: tuple):
        """Adopt an attribution() token on the current thread for the
        block."""
        ident = threading.get_ident()
        with self._lock:
            self._sinks.setdefault(ident, []).extend(token)
        try:
            yield
        finally:
            with self._lock:
                lst = self._sinks.get(ident)
                if lst is not None:
                    for sink in token:
                        if sink in lst:
                            lst.remove(sink)
                    if not lst:
                        self._sinks.pop(ident, None)


class PhaseScope:
    """What the attributed threads accumulated into a PhaseTimers while the
    scope was open: snapshot() and counter_snapshot()."""

    def __init__(self, timers: PhaseTimers):
        self._timers = timers
        self._lock = timers._lock  # one lock: a scope is the timers' state
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.counters: dict[str, int] = {}
        with self._lock:
            timers._sinks.setdefault(threading.get_ident(), []).append(self)

    def _add_phase_locked(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def record(self, name: str, seconds: float) -> None:
        """Accumulate a duration measured elsewhere into this scope alone
        (PhaseTimers.record feeds every scope the calling thread carries)."""
        with self._lock:
            self._add_phase_locked(name, seconds)

    def close(self) -> None:
        """Detach from every thread; what was collected stays readable.
        Idempotent: a wedged executor that comes back late closes a scope
        the daemon already reported from."""
        with self._lock:
            sinks = self._timers._sinks
            for ident in list(sinks):
                lst = sinks[ident]
                while self in lst:
                    lst.remove(self)
                if not lst:
                    sinks.pop(ident, None)

    def __enter__(self) -> "PhaseScope":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def snapshot(self) -> dict[str, float]:
        """Seconds per phase attributed to this scope, rounded to 0.1 ms."""
        with self._lock:
            return {name: round(t, 4) for name, t in self.totals.items()}

    def counter_snapshot(self) -> dict[str, int]:
        """Event counters attributed to this scope."""
        with self._lock:
            return dict(self.counters)


# The chain engine's host phases and counters, process-wide.
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
