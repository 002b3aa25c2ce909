"""Structured event log: a bounded, rotating JSONL of engine and daemon
transitions (the port's copy of the JAX package's `obs/events.py`, in its
record format, so either package's `follow_file` reads the other's file).

The flight recorder (obs/trace.py) answers "what was running when"; this
log answers "what happened": job lifecycle (submit, start, done, failed),
watchdog reap, wedge and degrade, the card probe's recovery, estimator and
delta fallbacks with their reasons, chain failover, warm-store loads and
flushes, failpoint triggers.  One JSON object per line, each with a
monotonically increasing `seq`, a wall-clock `ts`, a `mono_us` on the
flight recorder's span origin (so an event lines up against the trace),
and the emitting thread's job and trace tags (an event emitted inside a
tagged job carries that job's id without the call site passing it).

Two sinks, both bounded:

  * an in-process ring (`RING_RETAIN` newest records): the daemon's
    `events` op and `spgemm_tpu_torch.cli events --tail N` read it;
  * a JSONL file once `configure()` names one (spgemmd: next to its journal
    at `<socket>.events.jsonl`), rotated to `<path>.1` past
    SPGEMM_TPU_OBS_EVENTS_MAX_KB -- at most about twice the cap on disk.

`SPGEMM_TPU_OBS_EVENTS=0` turns emission off (both sinks).  emit() only
appends to the ring and a bounded pending queue; one daemonized writer
thread does every file syscall, so a stalling filesystem never blocks an
emitter, least of all the spgemmd watchdog, whose reap and degrade events
sit on its recovery path.  Write errors are counted; a pending queue past
its bound drops its oldest lines (counted).  `flush()` waits for the queue
to drain (tests, daemon shutdown).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from spgemm_tpu_torch.obs import trace
from spgemm_tpu_torch.utils import knobs


# The port's event kinds (kind -> when it fires): only the kinds the port
# emits.  tests/test_torch_obs.py holds every emit() literal in the package
# to this dict and each kind to the JAX package's registry; the
# lock_contention kind comes with its module.
EVENT_KINDS: dict[str, str] = {
    "daemon_start": "spgemmd came up (socket, slice, pid)",
    "daemon_drain_reap": "a SIGTERM/SIGINT or shutdown drain failed an in-flight job "
                         "that outlived the grace window",
    "daemon_degrade": "the slice degraded: its executor was retired and the card is "
                      "probed (the probe decides what serves the queued jobs)",
    "journal_torn": "journal replay truncated at the first torn (CRC/length-framing) "
                    "record",
    "job_submit": "job admitted: id, folder, queue depth, tenant, trace context, "
                  "placement",
    "job_start": "the executor picked the job up (slice, degraded flag, batch id "
                 "when co-batched)",
    "job_done": "job finished bit-exact",
    "job_failed": "job ended in a structured error (the error rides along)",
    "watchdog_reap": "the watchdog reaped a job past its deadline",
    "watchdog_wedge": "the executor was declared wedged: the wedge grace passed "
                      "after a reap without a heartbeat",
    "slice_canary": "a reinstated slice's canary armed: its first job runs a "
                    "tightened deadline",
    "slice_canary_passed": "the canary job finished; the slice is fully reinstated",
    "slice_recover_probe": "a probe of a degraded slice's card found it dead "
                           "(outcome rides along)",
    "slice_recovered": "a probe found the card live; the slice is reinstated behind "
                       "the canary",
    "accum_route_mismatch": "the estimator's predicted accumulator route differed "
                            "from the exact plan's (counted, bit-exact either way)",
    "est_fallback": "the sampled estimator fell back to the exact symbolic join, "
                    "with the reason",
    "delta_fallback": "delta recompute fell back to the full multiply, with the "
                      "reason",
    "plan_exact_landed": "an estimated plan's deferred exact join landed",
    "warm_disabled": "the warm store ran cold (flock contention or an unusable "
                     "directory), with the reason",
    "warm_load": "the warm store bound its directory (entry counts ride along)",
    "warm_corrupt_skipped": "a corrupt or version-skewed warm entry was skipped as a "
                            "counted cold fallback",
    "warm_flush": "the warm store flushed to disk (entry counts ride along)",
    "chain_failover": "the chain failed over to the host oracle after a lost card, "
                      "with the triggering error",
    "compile": "jit compile record: site, wall, FLOPs/bytes, memory footprints "
               "(obs/profile.py)",
    "slo_burn": "SLO burn-rate breach transition for a (tenant, slice) window; "
                "carries the newest bad job's trace context",
    "slo_burn_clear": "the burn condition cleared for the window",
    "failpoint_trigger": "an armed chaos failpoint fired (point name and action "
                         "ride along)",
    "tune_trial": "autotuner ran one timed trial leg on an idle slice (class, knob "
                  "vector, measured wall ride along; the port adds the leg's digest, "
                  "phases and counters)",
    "tune_trial_preempted": "a trial leg aborted because a real job arrived (or the "
                            "overlay was swapped mid-measurement, or it failed); the "
                            "measurement was discarded",
    "tune_apply": "a class's tuned override was promoted (trial winner persisted to "
                  "the warm tune tier, canary armed)",
    "tune_canary_passed": "the first job under a fresh tuned override committed "
                          "clean; the override is live",
    "tune_revert": "a tuned override was dropped (canary failure or trial-time parity "
                   "mismatch) and its class backed off before re-trial",
    "router_start": "spgemm-router came up (listen address, backend list, poll cadence)",
    "router_backend_down": "a backend failed its stats poll (or was degraded) and left "
                           "placement",
    "router_backend_up": "a backend answered its stats poll healthy and (re)joined "
                         "placement",
    "router_failover": "a job's backend died mid-flight; the job was re-submitted once to "
                       "a healthy peer (or failed structured backend-lost -- outcome rides "
                       "along)",
}


def event_table_md() -> str:
    """The event-kind table as markdown (the README's event table)."""
    lines = ["| event kind | when it fires |", "|---|---|"]
    for kind, doc in EVENT_KINDS.items():
        lines.append(f"| `{kind}` | {doc} |")
    return "\n".join(lines)


def enabled() -> bool:
    """SPGEMM_TPU_OBS_EVENTS=0|1 (default 1)."""
    return knobs.get("SPGEMM_TPU_OBS_EVENTS")


def cap_bytes() -> int:
    """SPGEMM_TPU_OBS_EVENTS_MAX_KB (default 256) in bytes."""
    return knobs.get("SPGEMM_TPU_OBS_EVENTS_MAX_KB") * 1024


class EventLog:
    """The process-wide event emitter: bounded ring + async rotating
    file sink (one daemonized writer thread owns every file syscall)."""

    # in-process records retained for tail()/the daemon `events` op
    RING_RETAIN = 512
    # encoded lines awaiting the writer thread: past this the OLDEST
    # pending lines drop (counted) -- a stalled disk bounds memory, and
    # the ring above still holds the newest records
    PENDING_RETAIN = 1024

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: deque = deque()   # spgemm-lint: guarded-by(_lock)
        self._pending: deque = deque()  # spgemm-lint: guarded-by(_lock)
        self._seq = 0                 # spgemm-lint: guarded-by(_lock)
        self._emitted = 0             # spgemm-lint: guarded-by(_lock)
        self._dropped = 0             # spgemm-lint: guarded-by(_lock)
        self._io_dropped = 0          # spgemm-lint: guarded-by(_lock)
        self._rotations = 0           # spgemm-lint: guarded-by(_lock)
        self._write_errors = 0        # spgemm-lint: guarded-by(_lock)
        self._path = None             # spgemm-lint: guarded-by(_lock)
        self._size = 0                # spgemm-lint: guarded-by(_lock)
        self._writer = None           # spgemm-lint: guarded-by(_lock)
        # lines POPPED from pending but not yet on disk: flush()'s drain
        # contract must cover them too, or a caller (test asserting file
        # bytes, daemon shutdown) can observe the rotation's mid-air
        # window -- old file replaced away, new one not yet created
        self._in_flight = 0           # spgemm-lint: guarded-by(_lock)
        self._wake = threading.Event()

    def configure(self, path: str | None) -> None:
        """Point the file sink at `path` (None detaches it) and start
        the writer thread on first attach.  An existing file is appended
        to -- its current size seeds the rotation budget, so a daemon
        restart cannot grow it past ~2x the cap."""
        with self._lock:
            self._path = path
            self._size = 0
            if path is not None:
                try:
                    self._size = os.path.getsize(path)
                except OSError:
                    self._size = 0
                if self._writer is None or not self._writer.is_alive():
                    self._writer = threading.Thread(
                        target=self._writer_loop, name="obs-events-writer",
                        daemon=True)
                    self._writer.start()
        self._wake.set()

    def emit(self, kind: str, **fields) -> None:
        """One event.  None-valued fields are dropped; the emitting
        thread's flight-recorder tags (job_id/trace_id) merge in under
        the explicit fields.  NO file I/O happens here -- the line is
        queued for the writer thread, so a stalling disk never blocks
        an emitter (the spgemmd watchdog emits on its recovery path)."""
        if not enabled():
            return
        rec = {"ts": round(time.time(), 6),
               "mono_us": round((time.perf_counter() - trace._BASE) * 1e6,
                                3),
               "kind": kind}
        rec.update(trace.RECORDER.current_tags())
        rec.update({k: v for k, v in fields.items() if v is not None})
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, **rec}
            self._ring.append(rec)
            self._emitted += 1
            while len(self._ring) > self.RING_RETAIN:
                self._ring.popleft()
                self._dropped += 1
            if self._path is None:
                return
            # encode here (cheap, no syscall): the rotation budget is in
            # BYTES, so the queued unit is the utf-8 line, not the str
            self._pending.append(
                (json.dumps(rec, separators=(",", ":"), default=str)
                 + "\n").encode("utf-8"))
            while len(self._pending) > self.PENDING_RETAIN:
                self._pending.popleft()
                self._io_dropped += 1
        self._wake.set()

    # ------------------------------------------------- the writer thread --
    def _writer_loop(self) -> None:
        while True:
            self._wake.wait(0.5)
            self._wake.clear()
            self._drain_once()

    def _drain_once(self) -> None:
        """Write queued lines until the pending queue is empty.  Every
        syscall happens here, on the writer thread, outside _lock --
        a blocked write stalls only this thread and the (bounded,
        oldest-dropped) pending queue."""
        while True:
            with self._lock:
                if self._path is None:
                    self._pending.clear()
                    return
                if not self._pending:
                    return
                data = self._pending.popleft()
                self._in_flight = 1
                path = self._path
                size = self._size
            cap = cap_bytes()
            rotated = False
            try:
                if size + len(data) > cap and size > 0:
                    # one rotation generation: the previous .1 is the
                    # price of boundedness
                    os.replace(path, path + ".1")
                    size = 0
                    rotated = True
                with open(path, "ab") as f:
                    f.write(data)
            except OSError:
                # best-effort sink: a full disk loses log lines, never
                # the device owner.  Re-stat the file so the tracked
                # size resyncs with reality -- a vanished file (an
                # operator logrotate/cleaner) must not leave a stale
                # over-cap _size that makes every later rotation attempt
                # fail forever; the next append simply recreates it.
                with self._lock:
                    self._in_flight = 0
                    self._write_errors += 1
                    if self._path == path:
                        if rotated:
                            self._rotations += 1
                        try:
                            self._size = os.path.getsize(path)
                        except OSError:
                            self._size = 0
                continue
            with self._lock:
                self._in_flight = 0
                if self._path == path:  # configure() may have moved it
                    self._size = size + len(data)
                    if rotated:
                        self._rotations += 1

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait for the pending queue -- AND the line the writer has
        already popped but not yet landed -- to drain (tests, daemon
        shutdown); True when both drained within `timeout`."""
        self._wake.set()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if ((not self._pending and not self._in_flight)
                        or self._path is None):
                    return True
                writer = self._writer
            if writer is None or not writer.is_alive():
                return False
            time.sleep(0.01)
        return False

    def tail(self, n: int = 50) -> list[dict]:
        """The newest n records, oldest first (copies)."""
        n = max(0, int(n))
        with self._lock:
            items = list(self._ring)
        return [dict(r) for r in items[len(items) - n:]]

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": enabled(), "ring": len(self._ring),
                    "emitted": self._emitted, "dropped": self._dropped,
                    "pending": len(self._pending),
                    "io_dropped": self._io_dropped,
                    "rotations": self._rotations,
                    "write_errors": self._write_errors,
                    "path": self._path, "bytes": self._size}

    def clear(self) -> None:
        """Drop the ring/pending lines and zero the counters; the file
        sink detaches (tests, harnesses).  The writer thread stays up
        for the next configure()."""
        with self._lock:
            self._ring.clear()
            self._pending.clear()
            self._seq = 0
            self._emitted = self._dropped = self._rotations = 0
            self._io_dropped = 0
            self._write_errors = 0
            self._path = None
            self._size = 0


# The process-wide log: the engine emits here, spgemmd configures the
# file sink and serves the `events` op from the ring.
LOG = EventLog()


def emit(kind: str, **fields) -> None:
    """Module-level convenience: LOG.emit."""
    LOG.emit(kind, **fields)


# ------------------------------------------------------------- follow --
def _read_records(path: str, offset: int) -> tuple[int, list[dict]]:
    """Complete JSONL records in `path` from byte `offset` on: returns
    (offset past the last complete line, parsed records).  A trailing
    half-written line is left for the next poll; a malformed line is
    skipped (its bytes are consumed -- the writer never rewrites)."""
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read()
    except OSError:
        return offset, []
    end = data.rfind(b"\n")
    if end < 0:
        return offset, []
    records = []
    for line in data[: end + 1].splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            records.append(rec)
    return offset + end + 1, records


def follow_file(path: str, last_seq: int = 0, last_ts: float = 0.0,
                poll_s: float = 0.2, stop=None):
    """Yield records appended to the rotating event JSONL at `path`
    (the `cli events --follow` engine): polls the file, survives a
    rotation boundary (detected by INODE change, not just shrinkage --
    a burst can grow the fresh file past the old read offset within one
    poll; the tail of `<path>.1` beyond the old offset is drained
    first) without dropping or duplicating a line.  Dedup is on each
    record's (ts, seq) pair, not seq alone: a restarted daemon resets
    its seq counter while appending to the same file, and its records
    carry newer wall timestamps -- seq regression with a newer ts is a
    new generation, not a duplicate.  `stop` (optional callable) ends
    the generator when truthy (tests); the CLI ends it with Ctrl-C."""
    offset = 0
    last_ino: int | None = None
    # (wall ts, seq): generation-safe dedup -- pass the newest
    # already-printed record's ts alongside its seq, or file re-reads of
    # the same records (their real ts beats a zero) would duplicate
    last_key = (last_ts, last_seq)

    def _emit_new(records):
        nonlocal last_key
        for rec in records:
            key = (rec.get("ts", 0.0), rec.get("seq", 0))
            if key > last_key:
                last_key = key
                yield rec

    while True:
        if stop is not None and stop():
            return
        try:
            st = os.stat(path)
            size, ino = st.st_size, st.st_ino
        except OSError:
            size, ino = 0, None  # sink not created yet (or mid-rotation)
        rotated = (last_ino is not None and ino is not None
                   and ino != last_ino) or size < offset
        if rotated:
            # the bytes past our offset moved to <path>.1 -- drain them
            # before reading the fresh file from 0
            _, old_tail = _read_records(path + ".1", offset)
            yield from _emit_new(old_tail)
            offset = 0
        if ino is not None:
            last_ino = ino
        offset, records = _read_records(path, offset)
        yield from _emit_new(records)
        time.sleep(poll_s)
