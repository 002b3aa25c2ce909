"""spgemmd job queue: a bounded per-tenant fair queue with admission control
(the port's copy of the JAX package's `serve/queue.py`).

A submit that arrives with the queue cap's jobs already queued is answered
with a structured queue-full error instead of waiting.  Every job carries a
tenant (absent on the wire = protocol.DEFAULT_TENANT); jobs queue per
tenant and dispatch serves tenants deficit-round-robin, which with unit job
costs is strict rotation, FIFO within a tenant.  An optional per-tenant
in-flight cap (SPGEMM_TPU_SERVE_TENANT_INFLIGHT: queued + running) rejects
a tenant's overflow with a structured tenant-cap error.  Per-job deadlines
are stored at submit so the watchdog can reap.

`next(accept=...)` runs the executor's predicate under the queue lock, so
the executor that got True is the one that owns the job.  `drain_batch`
pops the batch mates of a job already picked up (cross-job batching) through
the same round-robin pass, scanning past jobs that do not match.

Imports the standard library and the knob registry only.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from spgemm_tpu_torch.serve import protocol
from spgemm_tpu_torch.utils import knobs

TERMINAL = ("done", "failed")


class QueueFull(Exception):
    """Admission-control rejection; carries the cap."""

    def __init__(self, cap: int):
        super().__init__(f"queue full: {cap} jobs already queued")
        self.cap = cap


class TenantCapExceeded(Exception):
    """Per-tenant in-flight cap rejection; carries the tenant and the cap."""

    def __init__(self, tenant: str, cap: int):
        super().__init__(f"tenant {tenant!r} already has {cap} jobs in flight")
        self.tenant = tenant
        self.cap = cap


class JobAbandoned(BaseException):
    """Raised from a job's heartbeat to end a chain whose job is already
    terminal (reaped by the watchdog, or failed when its executor died).

    A BaseException, so that chain_product's failover, which catches
    Exception for a lost card, lets it through to the executor loop."""

    def __init__(self, job_id: str):
        super().__init__(f"job {job_id} reached a terminal state; abandoning its chain")
        self.job_id = job_id


class Job:
    """One submitted chain job and its lifecycle: queued -> running -> done |
    failed.  Terminal transitions are first-write-wins: the watchdog may
    reap a job while its runner is still inside the chain, and the runner's
    own finish must then change nothing."""

    def __init__(self, job_id: str, folder: str, output: str, options: dict,
                 timeout_s: float = 0.0, tenant: str = protocol.DEFAULT_TENANT,
                 trace_id: str | None = None):
        self.id = job_id
        self.folder = folder
        self.output = output
        self.options = options
        self.tenant = tenant
        # the end-to-end trace context: the client's, else minted here
        self.trace_id = trace_id or protocol.mint_trace()
        self.timeout_s = timeout_s  # 0 = no deadline
        self.state = "queued"                   # spgemm-lint: guarded-by(_lock)
        self.error: dict | None = None          # spgemm-lint: guarded-by(_lock)
        self.detail: dict = {}                  # spgemm-lint: guarded-by(_lock)
        self.submitted_at = time.time()
        self.started_at: float | None = None    # spgemm-lint: guarded-by(_lock)
        self.finished_at: float | None = None   # spgemm-lint: guarded-by(_lock)
        # one writer (the heartbeat), a float store; the watchdog's read
        # tolerates staleness
        self.heartbeat_at: float | None = None
        # the placement record (serve/placement.route, set at admission) and
        # what the executor sets at pickup: the slice's name, its torch
        # devices, and whether an idle slice outside the job's class took it
        self.placement: dict | None = None
        self.slice: str | None = None
        self.devices: tuple[str, ...] | None = None
        self.stolen = False
        # the batching group key (ops/plancache.chain_structure, set at
        # admission): jobs that share it walk one plan sequence and may run
        # as one batch; None (first contact, an unreadable folder) runs solo
        self.group_key: str | None = None
        # set by the executor when the job ran in a batch: the batch's id,
        # the head job's id
        self.batch_id: str | None = None
        # set by the executor at pickup: the job's PhaseScope (opaque here),
        # whether it runs degraded, and the plan cache's counters then, so
        # a reaped job's status still carries its own phases and counters
        self.scope = None
        self.scope_degraded = False
        self.cache_base = None
        # set by the executor at pickup: the job's autotuner class
        # (ops/plancache.tune_class_key; None on first contact) and the
        # estimator's account then, which the terminal path diffs
        self.tune_class: str | None = None
        self.est_base = None
        self._lock = threading.Lock()
        self._terminal = threading.Event()

    @property
    def device(self) -> str | None:
        """The job's devices as its detail shows them: one device's name, a
        wide slice's names joined by commas; None before pickup.  Setting
        it gives the job that one device."""
        return None if self.devices is None else ",".join(self.devices)

    @device.setter
    def device(self, name: str | None) -> None:
        self.devices = None if name is None else (name,)

    def touch(self) -> None:
        """Progress heartbeat (after every multiply): the watchdog's
        slow-or-wedged signal."""
        self.heartbeat_at = time.time()

    def start(self) -> None:
        with self._lock:
            if self.state == "queued":
                self.state = "running"
                self.started_at = time.time()
                self.heartbeat_at = self.started_at

    def finish(self, state: str, error: dict | None = None, detail: dict | None = None,
               on_commit=None) -> bool:
        """Terminal transition; False (and nothing changes) when the job is
        already terminal.  on_commit (the journal append) runs inside the
        winning transition, before waiters wake: a client that saw the job
        finish never races a restart past its journal record."""
        assert state in TERMINAL
        with self._lock:
            if self.state in TERMINAL:
                return False
            self.state = state
            self.error = error
            if detail:
                self.detail = detail
            self.finished_at = time.time()
            try:
                if on_commit is not None:
                    on_commit()
            finally:
                self._terminal.set()
        return True

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the job is terminal; False on timeout."""
        return self._terminal.wait(timeout)

    def overdue(self, now: float | None = None) -> bool:
        """True iff running with a deadline and past it."""
        with self._lock:
            if self.timeout_s <= 0 or self.state != "running":
                return False
            started = self.started_at or self.submitted_at
        return (now or time.time()) - started > self.timeout_s

    def snapshot(self) -> dict:
        """Wire form for status and wait answers."""
        with self._lock:
            return {
                "id": self.id,
                "folder": self.folder,
                "output": self.output,
                "options": dict(self.options),
                "tenant": self.tenant,
                "trace": self.trace_id,
                "state": self.state,
                "error": self.error,
                "detail": dict(self.detail),
                "timeout_s": self.timeout_s,
                "submitted_at": self.submitted_at,
                "started_at": self.started_at,
                "finished_at": self.finished_at,
                "heartbeat_at": self.heartbeat_at,
                "slice": self.slice,
                "stolen": self.stolen,
                "batch": self.batch_id,
                "placement": dict(self.placement) if self.placement else None,
            }


class JobQueue:
    """Bounded per-tenant fair queue of Jobs and the daemon's job index.

    The cap bounds queued jobs across tenants (a running job no longer
    holds a slot); the optional tenant cap bounds queued + running per
    tenant.  Terminal jobs stay in the index for status and wait, the
    RETAIN_TERMINAL newest only: a status for an evicted id answers
    unknown-job."""

    # terminal jobs retained; older ones are evicted at the next admission
    RETAIN_TERMINAL = 512

    def __init__(self, cap: int, tenant_inflight: int | None = None):
        self.cap = cap
        # an explicit cap wins; None reads the knob at each submit
        self._tenant_cap = tenant_inflight
        self._queues: dict[str, deque[Job]] = {}  # spgemm-lint: guarded-by(_lock)
        self._rr: list[str] = []                  # spgemm-lint: guarded-by(_lock)
        self._queued = 0                          # spgemm-lint: guarded-by(_lock)
        self._inflight: dict[str, int] = {}       # spgemm-lint: guarded-by(_lock)
        self._served: dict[str, int] = {}         # spgemm-lint: guarded-by(_lock)
        self._last_seen: dict[str, float] = {}    # spgemm-lint: guarded-by(_lock)
        self._jobs: dict[str, Job] = {}           # spgemm-lint: guarded-by(_lock)
        self._lock = threading.Lock()
        self._avail = threading.Condition(self._lock)

    def tenant_cap(self) -> int | None:
        """The per-tenant in-flight cap (None = uncapped)."""
        if self._tenant_cap is not None:
            return self._tenant_cap
        return knobs.get("SPGEMM_TPU_SERVE_TENANT_INFLIGHT")

    def submit(self, job: Job) -> int:
        """Admit job (FIFO within its tenant); QueueFull at the cap,
        TenantCapExceeded at the tenant's cap.  Returns the queue depth
        with the new job."""
        cap_t = self.tenant_cap()
        with self._avail:
            if self._queued >= self.cap:
                raise QueueFull(self.cap)
            if cap_t is not None and self._inflight.get(job.tenant, 0) >= cap_t:
                raise TenantCapExceeded(job.tenant, cap_t)
            # evict the oldest terminal jobs past the retention bound (dict
            # order is admission order)
            terminal = [j.id for j in self._jobs.values() if j.state in TERMINAL]
            for jid in terminal[:max(0, len(terminal) - self.RETAIN_TERMINAL)]:
                del self._jobs[jid]
            if job.tenant not in self._queues:
                self._queues[job.tenant] = deque()
                if job.tenant not in self._rr:
                    self._rr.append(job.tenant)
            self._queues[job.tenant].append(job)
            self._queued += 1
            self._inflight[job.tenant] = self._inflight.get(job.tenant, 0) + 1
            self._last_seen[job.tenant] = time.time()
            # release() frees an in-flight slot only for a job that took one
            job._admitted = True
            self._jobs[job.id] = job
            self._avail.notify_all()
            return self._queued

    def _pop_locked(self, accept, scan: bool = False) -> Job | None:
        """One round-robin pass (caller holds _lock): serve the first tenant
        with a job accept takes (None takes anything), then move the served
        tenant, and every tenant it skipped, to the back.  A tenant offers
        its head job only; with scan (the batch-mate pass) any queued job,
        and the ones passed over keep their places (a job of another
        structure at a tenant's head does not block the mates behind it, and
        stays first for the next solo pop)."""
        order = self._rr
        for idx, tenant in enumerate(order):
            q = self._queues.get(tenant)
            if not q:
                continue
            for pos, job in enumerate(q):
                if accept is None or accept(job):
                    del q[pos]
                    self._queued -= 1
                    if not q:
                        del self._queues[tenant]
                    self._served[tenant] = self._served.get(tenant, 0) + 1
                    self._rr = order[idx + 1:] + order[:idx + 1]
                    return job
                if not scan:
                    break
        return None

    def next(self, timeout: float | None = None, accept=None) -> Job | None:
        """Pop the next job in fair order that accept takes (None takes
        anything); None on timeout.  accept runs under the queue lock, so it
        must be cheap."""
        with self._avail:
            job = self._pop_locked(accept)
            if job is None:
                self._avail.wait(timeout)
                job = self._pop_locked(accept)
            return job

    def drain_batch(self, limit: int, window_s: float, accept) -> list[Job]:
        """Pop up to `limit` more jobs that accept takes (the executor's
        mate filter), waiting up to window_s for them to arrive.  The pops
        go through the round-robin pass, so tenant fairness and the tenant
        caps decide a batch's members before it forms.  The window bounds
        waiting only: jobs already queued drain at once."""
        mates: list[Job] = []
        deadline = time.time() + window_s
        with self._avail:
            while len(mates) < limit:
                job = self._pop_locked(accept, scan=True)
                if job is not None:
                    mates.append(job)
                    continue
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._avail.wait(remaining)
        return mates

    def release(self, job: Job) -> None:
        """Retire a terminal job from the in-flight accounting.  Idempotent,
        and a no-op for a job that was never admitted."""
        with self._lock:
            if not getattr(job, "_admitted", False) or getattr(job, "_released", False):
                return
            job._released = True
            n = self._inflight.get(job.tenant, 0) - 1
            if n > 0:
                self._inflight[job.tenant] = n
            else:
                self._inflight.pop(job.tenant, None)
            # a tenant with nothing queued and nothing in flight leaves the
            # rotation, so per-tenant state does not grow with names seen
            if job.tenant not in self._queues and job.tenant not in self._inflight:
                if job.tenant in self._rr:
                    self._rr.remove(job.tenant)
                self._served.pop(job.tenant, None)
                self._last_seen.pop(job.tenant, None)

    def get(self, job_id: str) -> Job | None:
        with self._lock:
            return self._jobs.get(job_id)

    def running(self) -> list[Job]:
        """Jobs in the running state."""
        with self._lock:
            return [j for j in self._jobs.values() if j.state == "running"]

    def counts(self) -> dict[str, int]:
        """Jobs per state over the index, and the queue depth."""
        with self._lock:
            jobs = list(self._jobs.values())
            depth = self._queued
        hist = {"queued": 0, "running": 0, "done": 0, "failed": 0}
        for j in jobs:
            hist[j.state] = hist.get(j.state, 0) + 1
        hist["depth"] = depth
        return hist

    def tenants(self) -> dict[str, dict]:
        """Per tenant with live state: queued, in flight, served, last seen."""
        with self._lock:
            names = set(self._queues) | set(self._inflight) | set(self._served)
            return {t: {"queued": len(self._queues.get(t, ())),
                        "inflight": self._inflight.get(t, 0),
                        "served": self._served.get(t, 0),
                        "last_seen": self._last_seen.get(t, 0.0)}
                    for t in sorted(names)}
