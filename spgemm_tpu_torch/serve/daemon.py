"""spgemmd on the port: the resident daemon that owns the cards (the port's
copy of the JAX package's `serve/daemon.py`).

One long-lived process runs every submitted chain job through the port's
engine on a pool of device slices (parallel/mesh.slice_pool, the spec in
SPGEMM_TPU_SERVE_SLICES), so what is expensive
stays warm across jobs: the built nvcc and g++ libraries, the plan cache
(ops/plancache), the delta store (ops/delta, SPGEMM_TPU_DELTA at its
default 1: an edited resubmit re-folds only the rows its edit reaches) and
the crossover caches; the warm store (ops/warmstore, <socket>.warm unless
SPGEMM_TPU_WARM_DIR says otherwise) keeps plans and delta entries across a
restart.  The run-once CLI pays CUDA start-up and cold planning per call.

The pool, as in the JAX package: one executor per slice.  A single-device
slice runs chain.chain_product on its device (`cuda:<i>`); a wider slice
runs each multiply as the output-sharded multiply over its devices
(parallel/rowshard.spgemm_sharded, the exact fold, partials on the host).
Placement (_accepts, under the queue's lock) prefers the slices of the
job's class (serve/placement.route: `small` the narrowest healthy slices,
`large` the widest, `default` the spec's default slices) and steals: an
idle slice takes a job whose preferred slices are all busy (ENGINE
`serve_steals`, the slice's `steals`).  A job under mxu, whose field-mode
bytes differ from the exact fold's, runs on a single-device slice whenever
one is healthy, and is never stolen onto a wide one; where every healthy
slice is wide it runs unsharded on the wide slice's first device, so its
bytes never depend on where it ran (the JAX daemon drops the backend on a
wide slice).
Two slices that share a device never run at once.  On the card the spec is
checked against the visible cards (one H100: `1` or `auto`); on the CPU
every slice position is `cpu` and the spec's device count is taken as
given, so tests and chaos_smoke run pools of several slices there.

Reliability, per slice, as in the JAX package but for who decides where a
degraded slice's jobs run (the probe):

  * A card can fail by hanging, never raising.  The watchdog reaps a job
    past its deadline with a structured job-timeout error; when the
    executor is still inside that job SPGEMM_TPU_SERVE_WEDGE_GRACE_S later
    with no heartbeat (chain_product beats after every multiply), or when
    the executor thread died, the slice DEGRADES: the thread is abandoned
    and the card probed from a subprocess (utils/backend_probe) while the
    queued jobs wait.  The probe decides, as the port's failover rule
    does: a card that computes gets a new executor at once, its first job
    a canary with a tightened deadline; only a card the probe finds dead
    hands the slice to the host oracle, in the job's own arithmetic (field
    mode under mxu; the JAX daemon drops the backend there, and serves on
    the oracle whatever its probe says).  SPGEMM_TPU_SERVE_RECOVER_S > 0
    then probes the dead card again at that cadence (doubling) and
    reinstates it the same way.  A degrade is loud: a stderr line, the
    ENGINE counter `serve_degrades`, `degraded`/`degrade_reason`/
    `backend_probe` and the slice's state in `stats`, and `degraded: true`
    in the detail of each job the oracle served.
  * A submit past SPGEMM_TPU_SERVE_QUEUE_CAP gets a queue-full answer.
  * Every admitted job is journaled next to the socket (<socket>.journal,
    CRC32 and length per record); a restart re-queues the jobs that never
    finished, and a job with a checkpoint_dir resumes from its newest pass.

Each job runs under an ENGINE PhaseScope on the executor thread (and on
the chain's planner thread, which adopts it), so its detail holds its own
phases and counters: queue wait, load, chain, write, plan-cache hits and
misses, delta rows, and the launches of each CUDA kernel.

Cross-job batching (SPGEMM_TPU_SERVE_BATCH_WINDOW_S > 0, up to
SPGEMM_TPU_SERVE_BATCH_K jobs, and SPGEMM_TPU_DELTA=0): admission gives a
job the recorded structure of its folder's chain as its group key
(ops/plancache's structure book, which the runners fill once they have read
a chain).  A pickup on the card drains the queued jobs of the same key,
deadline, backend and round_size (_drain_batch_mates, through the queue's
fair pass), and the group runs as one lockstep reduction (run_chain_jobs):
each multiply planned once and run for every job by
ops/spgemm.execute_batched, each round one launch over the jobs' stacked
indices, each job's bytes its solo run's.  Every member keeps its own
PhaseScope (so each sees the shared launches), journal records and
`batch` id; the head is the watchdog's job, and when it is reaped the mates
fail with a structured error.  A batch whose kernel fails fails its members
with the error; only a slice the probe found dead serves on the host, and
such a pickup never batches.

Observability (obs/): every job's execute runs under the flight
recorder's tags (job id, trace id, slice; a batch adds its batch id and is
tagged with its head), so its spans, and its planner thread's, carry them.
The event log writes <socket>.events.jsonl (job_submit, job_start, job_done
and job_failed, watchdog_reap, watchdog_wedge, daemon_degrade, the probe's
slice_recover_probe and slice_recovered, the canary's slice_canary and
slice_canary_passed, journal_torn, daemon_start, daemon_drain_reap).  A
reap, a wedge and a degrade each dump the recorder to
<socket>.flight/<name>.trace.json, the newest FLIGHT_RETAIN kept.  The
`metrics` op renders the Prometheus scrape
(obs/metrics.py), `trace` the recorder as trace_event JSON, `events` the
event ring's tail, `profile` the profiling accounts (obs/profile.py: build
records, the device memory watermark, estimator and delta accountability)
and `slo` the SLO engine's report (obs/slo.py).  Every terminal job feeds
one record into the SLO engine (tenant, slice, wall, queue wait, error,
trace id), outside the daemon's lock; with SPGEMM_TPU_SLO_TARGET_S set a
burning (tenant, slice) window emits `slo_burn` with the newest bad job's
trace id.  Each pickup opens a device memory window per member
(profile.memory_job_begin) and a job's detail carries its
`hbm_peak_bytes` when the card reported: the allocator's view at the
engine's multiply boundaries.  The engine's samples land in the window of
the thread's job tag, so under a batch, whose spans all carry the head's
id, the head's window takes the batch's samples and a mate's holds the
reading at its pickup (the JAX package's behaviour).  Nothing in obs
catches a kernel failure or moves a job to the host: it catches only its
own I/O errors.

The autotuner (tune/): at start the daemon wires the warm store's tune
tier as the tuner's store and adopts its records.  An executor whose poll
comes up empty may run one timed trial leg (_maybe_tune) while the pool is
idle, the queue empty and the slice neither degraded nor auditioning; the
leg (_tune_run_fn) reads the class's representative folder and reduces its
chain exactly, under SPGEMM_TPU_DELTA=0, and a job queued meanwhile preempts
it at the next multiply boundary.  At pickup a job's class key
(ops/plancache.tune_class_key: its group key and the card's name) selects
the overlay it runs under (ENGINE phase tune_apply when it changes), and the
first job under a freshly promoted vector is the tuned canary: a tightened
deadline and no batching.  The terminal path registers the class and its
folder, settles a canary and scores the estimator for the class.  Under
SPGEMM_TPU_TUNE=0 none of this runs.

The daemon is degraded (`degraded`, a non-null `degrade_reason`) only
while every slice is; a degraded slice serves only then, on the host oracle.
This module imports no torch and no numpy at import time: the engine is
imported inside the runners, the executor and main().
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import signal
import socket
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from functools import partial

from spgemm_tpu_torch import tune as tune_mod
from spgemm_tpu_torch.obs import events as obs_events
from spgemm_tpu_torch.obs import metrics as obs_metrics
from spgemm_tpu_torch.obs import profile as obs_profile
from spgemm_tpu_torch.obs import slo as obs_slo
from spgemm_tpu_torch.obs import trace as obs_trace
from spgemm_tpu_torch.parallel import mesh as mesh_mod
from spgemm_tpu_torch.serve import placement, protocol
from spgemm_tpu_torch.serve.queue import (TERMINAL, Job, JobAbandoned, JobQueue, QueueFull,
                                          TenantCapExceeded)
from spgemm_tpu_torch.utils import failpoints, knobs
from spgemm_tpu_torch.utils.timers import ENGINE

log = logging.getLogger("spgemm_tpu_torch.serve")

# options a submit may carry; any other is a bad request
SUBMIT_OPTIONS = ("backend", "round_size", "checkpoint_dir", "output", "timeout_s", "failover")

# ENGINE counters the daemon bumps, reported by `stats`
SERVE_COUNTERS = ("serve_reaps", "serve_degrades", "serve_recoveries", "serve_steals",
                  "serve_batches", "serve_batched_jobs")


# -------------------------------------------------------- journal framing --
def journal_frame(event: dict) -> str:
    """One journal line: `CRC32 LENGTH PAYLOAD\\n` (crc as 8 hex digits over
    the utf-8 payload, length in bytes).  A record cut mid-write fails
    either check on replay and is truncated at."""
    payload = json.dumps(event, separators=(",", ":"))
    data = payload.encode("utf-8")
    return f"{zlib.crc32(data):08x} {len(data)} {payload}\n"


def journal_parse_line(line: str) -> dict | None:
    """One journal line decoded; None = a torn or corrupt record.  A bare
    JSON line (a journal written before framing) parses too."""
    if line.startswith("{"):
        try:
            ev = json.loads(line)
        except ValueError:
            return None
        return ev if isinstance(ev, dict) else None
    parts = line.split(" ", 2)
    if len(parts) != 3:
        return None
    crc_hex, length_s, payload = parts
    try:
        want_crc = int(crc_hex, 16)
        want_len = int(length_s)
    except ValueError:
        return None
    data = payload.encode("utf-8")
    if len(data) != want_len or zlib.crc32(data) != want_crc:
        return None
    try:
        ev = json.loads(payload)
    except ValueError:
        return None
    return ev if isinstance(ev, dict) else None


def engine_backend(name: str | None) -> str:
    """The port backend a submit's `backend` option runs: the port's own
    names as they are, the JAX package's `xla` and `pallas` as `exact`
    (both are the exact fold there), absent as `exact`."""
    if name is None:
        return "exact"
    return protocol.BACKEND_ALIASES.get(name, name)


def _book_chain(job: Job, mats: list) -> None:
    """Record, for the folder's current content, what admission reads and
    its books do not know yet: the placement price (placement.note_mass;
    a resubmit of unchanged content was priced at admission) and the chain
    structure (plancache.note_chain_structure; a job admitted with a group
    key was recorded before).  ENGINE phase serve_price.  Routing only: a
    failure is logged, never the job's."""
    from spgemm_tpu_torch.ops import estimate, plancache  # noqa: PLC0415

    price = (job.placement or {}).get("source") != "estimate"
    if not price and job.group_key is not None:
        return
    try:
        with ENGINE.phase("serve_price"):
            coords = [m.coords for m in mats]
            if price:
                placement.note_mass(job.folder, estimate.chain_mass(coords))
            if job.group_key is None:
                plancache.note_chain_structure(placement.signature(job.folder),
                                               plancache.chain_fingerprint(coords))
    except Exception as e:  # noqa: BLE001 -- pricing never decides a result
        log.warning("placement pricing failed for %s: %r", job.folder, e)


def result_digest(result) -> str:
    """sha256 over a chain result's coords and tiles (ops/plancache.
    hash_update): the autotuner's parity digest of a trial leg."""
    from spgemm_tpu_torch.ops import plancache  # noqa: PLC0415 -- the engine loads lazily

    h = hashlib.sha256()
    plancache.hash_update(h, result.coords)
    plancache.hash_update(h, result.tiles)
    return h.hexdigest()


def run_chain_job(job: Job, degraded: bool = False) -> None:
    """The default runner: read the job's folder, reduce the chain on the
    job's device (set at pickup; `cuda` when unset), write the output in
    the reference's text format.  ENGINE phases serve_load, serve_chain and
    serve_write.  A job on a wide slice (job.devices, set at pickup, holds
    more than one device) runs each multiply sharded over them
    (parallel/rowshard), the exact fold; the delta store is not consulted
    there.  Under mxu, whose field-mode bytes the sharded fold does not
    give, it runs unsharded on the slice's first device instead.

    degraded=True runs the chain on the host oracle in the job's
    arithmetic: the field-mode oracle under mxu, the reference's fold
    otherwise.  round_size and failover then do not apply."""
    from spgemm_tpu_torch import chain  # noqa: PLC0415 -- the engine loads lazily
    from spgemm_tpu_torch.utils import io_text  # noqa: PLC0415

    with ENGINE.phase("serve_load"):
        n, k = io_text.read_size(job.folder)
        mats = io_text.read_chain(job.folder, 0, n - 1, k)
    _book_chain(job, mats)
    backend = engine_backend(job.options.get("backend"))

    def beat() -> None:
        # heartbeat, and the end of a chain whose job the watchdog already
        # finished: at the next multiply, not after the whole chain
        failpoints.check("serve.heartbeat")
        job.touch()
        if job.state in TERMINAL:
            raise JobAbandoned(job.id)

    if degraded:
        kwargs = {"multiply": chain.field_oracle_multiply if backend == "mxu"
                  else chain.oracle_multiply}
    else:
        rs = job.options.get("round_size")
        devices = job.devices or ("cuda",)
        kwargs = {"device": devices[0],
                  "round_size": int(rs) if rs is not None else None,
                  "failover": bool(job.options.get("failover"))}
        if len(devices) > 1 and backend != "mxu":
            from spgemm_tpu_torch.parallel.rowshard import spgemm_sharded  # noqa: PLC0415

            kwargs["multiply"] = partial(spgemm_sharded, devices=list(devices))
    with ENGINE.phase("serve_chain"):
        result = chain.chain_product(mats, backend=backend,
                                     checkpoint_dir=job.options.get("checkpoint_dir"),
                                     heartbeat=beat, **kwargs)
    if job.state in TERMINAL:
        # reaped while inside the chain: a resubmit may own job.output now
        return
    with ENGINE.phase("serve_write"):
        io_text.write_matrix(job.output, result.prune_zeros())


def run_chain_jobs(jobs: list[Job], degraded: bool = False) -> None:
    """The batch runner: the chains of jobs of one recorded structure,
    reduced in lockstep on the jobs' device (a single-device slice's: the
    batch gate excludes wide slices) by
    chain.chain_products_batched: each multiply planned once and each round
    one launch for all of them.  Every member's heartbeat after each
    multiply; a reaped head (the watchdog's job) raises JobAbandoned.

    The structure book may be stale, so the chains read are compared
    again: if any differs from the head's, every job runs solo
    (run_chain_job), never a wrong answer.  A single job or a degraded call
    runs solo too.  ENGINE phases serve_load, serve_price, serve_chain and
    serve_write."""
    if degraded or len(jobs) == 1:
        for job in jobs:
            run_chain_job(job, degraded=degraded)
        return
    import numpy as np  # noqa: PLC0415 -- the engine loads lazily

    from spgemm_tpu_torch import chain  # noqa: PLC0415
    from spgemm_tpu_torch.ops.device import DeviceBlockMatrix  # noqa: PLC0415
    from spgemm_tpu_torch.utils import io_text  # noqa: PLC0415

    chains = []
    with ENGINE.phase("serve_load"):
        for job in jobs:
            n, k = io_text.read_size(job.folder)
            chains.append(io_text.read_chain(job.folder, 0, n - 1, k))
    for job, mats in zip(jobs, chains):
        _book_chain(job, mats)
    head = chains[0]
    if not all(len(mats) == len(head)
               and all(m.k == h.k and m.rows == h.rows and m.cols == h.cols
                       and np.array_equal(m.coords, h.coords) for m, h in zip(mats, head))
               for mats in chains[1:]):
        log.warning("a batch of %d jobs is not of one structure after all (a stale "
                    "structure book); running each solo", len(jobs))
        for job in jobs:
            run_chain_job(job)
        return

    def beat() -> None:
        failpoints.check("serve.heartbeat")
        for job in jobs:
            job.touch()
        if jobs[0].state in TERMINAL:
            raise JobAbandoned(jobs[0].id)

    rs = jobs[0].options.get("round_size")
    with ENGINE.phase("serve_chain"):
        device = (jobs[0].devices or ("cuda",))[0]
        results = chain.chain_products_batched(
            [[DeviceBlockMatrix.from_host(m, device=device) for m in mats] for mats in chains],
            backend=engine_backend(jobs[0].options.get("backend")),
            round_size=int(rs) if rs is not None else None, heartbeat=beat)
    for job, result in zip(jobs, results):
        if job.state in TERMINAL:
            continue  # reaped: a resubmit may own job.output now
        with ENGINE.phase("serve_write"):
            io_text.write_matrix(job.output, result.to_host().prune_zeros())


def _pool(spec: str, n_devices: int | None, device: str) -> list:
    """The slice table the daemon serves: the spec checked against
    n_devices when it is known; on the CPU, where it is not, `auto` takes
    one device and an explicit spec is taken as given."""
    if n_devices is None and device == "cpu" and spec.strip() == "auto":
        n_devices = 1
    return mesh_mod.slice_pool(spec, n_devices)


class _Slice:
    """One pool slice's serving state: its devices, its executor thread and
    the watchdog's handoff slots (thread, gen, current, reaped, reaped_at:
    one writer each, read without a lock), and the degrade, recovery and
    steal state, written under the daemon's _lock (the accept predicate
    reads `degraded` without it, and a stale value costs at most one more
    job for a replacement executor).  devices: the torch device names of
    its positions."""

    def __init__(self, spec: mesh_mod.DeviceSlice, devices: list[str]):
        self.spec = spec
        self.name = spec.name
        self.devices = tuple(devices)
        self.degraded = False
        self.degrade_reason: str | None = None
        self.jobs_total = 0
        self.steals = 0
        self.oracle_jobs = 0   # jobs a degraded executor ran on the host oracle
        self.recoveries = 0
        self.recovered_at: float | None = None
        self.recover_next = 0.0
        self.recover_backoff = 0.0
        self.canary = False
        self.canary_job: Job | None = None  # the job auditioning a reinstated slice
        self.probing = False   # a probe of the card is out
        # None while a degraded slice waits for its probe: jobs stay queued
        self.thread: threading.Thread | None = None
        self.gen = 0
        self.current: Job | None = None   # the job the slice's live executor holds
        self.reaped: Job | None = None    # a reaped job in its wedge grace
        self.reaped_at = 0.0

    @property
    def width(self) -> int:
        return self.spec.width

    @property
    def device(self) -> str:
        """The slice's devices as logs and `stats` show them: one device's
        name, a wide slice's names joined by commas."""
        return ",".join(self.devices)


class Daemon:
    """The spgemmd server: accept loops, one executor per slice, the
    watchdog, the journal.

    device: `cuda` (the default; slices run on cuda:<position>) or `cpu`
    (the kernels' plain versions; tests).  runner(job, degraded=) does a
    job's work (default run_chain_job) and probe() is the card's liveness
    check (default utils/backend_probe.probe_default_backend, a subprocess
    with a time limit); both are injectable for tests.  slices: the slice
    spec (default SPGEMM_TPU_SERVE_SLICES), checked against n_devices, the
    visible devices, when given (main() counts the cards; on the CPU tests
    inject it, and `auto` takes 1 when it is not given).
    device_name is reported by `stats` and is the device half of the
    autotuner's class keys (`cpu` on the CPU).  batch_runner(jobs, degraded=)
    runs a batch of two or more jobs (default run_chain_jobs), injectable
    so tests watch batches form without running chains."""

    # one journal compaction per this many terminal events
    JOURNAL_COMPACT_EVERY = 256
    # concurrent connections (each pins a thread): one more gets a busy answer
    MAX_CONNS = 128
    # a connection with no request line for this long is dropped
    CONN_IDLE_TIMEOUT_S = 600.0
    # one server-side wait is clamped to this (client.wait polls in slices)
    MAX_WAIT_SLICE_S = 30.0
    # stop() gives in-flight jobs this long before reaping them
    DRAIN_GRACE_S = 10.0
    # a dead card is probed again no more often than this
    RECOVER_BACKOFF_MAX_S = 900.0
    # flight dumps kept in <socket>.flight/ (the oldest pruned past it)
    FLIGHT_RETAIN = 64

    def __init__(self, socket_path: str | None = None, *, runner=None, batch_runner=None,
                 probe=None,
                 queue_cap: int | None = None, job_timeout_s: float | None = None,
                 wedge_grace_s: float | None = None, journal: bool = True,
                 slices: str | None = None, n_devices: int | None = None,
                 tenant_inflight: int | None = None, recover_s: float | None = None,
                 device: str = "cuda", device_name: str | None = None,
                 addr: str | None = None):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {device!r}")
        self.device = device
        self.device_name = device_name or ("cpu" if device == "cpu" else None)
        self.socket_path = socket_path or protocol.default_socket_path()
        # the optional TCP front-end beside the unix socket, parsed here so
        # a malformed spec fails construction
        self._addr_spec = addr if addr is not None else knobs.get("SPGEMM_TPU_SERVE_ADDR")
        self._tcp_bind = None
        if self._addr_spec:
            parsed = protocol.parse_addr(self._addr_spec)
            if parsed[0] != "tcp":
                raise ValueError(f"SPGEMM_TPU_SERVE_ADDR must be tcp:HOST:PORT (the unix "
                                 f"socket always listens), got {self._addr_spec!r}")
            self._tcp_bind = (parsed[1], parsed[2])
        self.tcp_port: int | None = None  # the bound port, set in start()
        self.journal_path = self.socket_path + ".journal"
        self.flight_dir = self.socket_path + ".flight"
        self.events_path = self.socket_path + ".events.jsonl"
        self.warm_dir = self.socket_path + ".warm"
        self._runner = runner or run_chain_job
        self._batch_runner = batch_runner or run_chain_jobs
        self._probe = probe
        self._cap = queue_cap if queue_cap is not None \
            else knobs.get("SPGEMM_TPU_SERVE_QUEUE_CAP")
        self._job_timeout_s = job_timeout_s if job_timeout_s is not None \
            else knobs.get("SPGEMM_TPU_SERVE_JOB_TIMEOUT")
        # must cover one whole multiply: the heartbeat fires per finished one
        self._wedge_grace_s = wedge_grace_s if wedge_grace_s is not None \
            else knobs.get("SPGEMM_TPU_SERVE_WEDGE_GRACE_S")
        # 0 = a degraded slice stays degraded until restart
        self._recover_s = recover_s if recover_s is not None \
            else knobs.get("SPGEMM_TPU_SERVE_RECOVER_S")
        self._journal_enabled = journal
        self._journal_terminal_events = 0  # spgemm-lint: guarded-by(_lock)
        self._journal_compactions = 0      # spgemm-lint: guarded-by(_lock)
        self._journal_torn = 0             # spgemm-lint: guarded-by(_lock)
        self._terminal_totals = {"done": 0, "error": 0, "timeout": 0, "abandoned": 0,
                                 "drained": 0}  # spgemm-lint: guarded-by(_lock)
        # each terminal job's wall, pickup (or submit) to its end
        self._job_wall = {"buckets": dict.fromkeys(obs_metrics.JOB_WALL_BUCKETS, 0),
                          "sum": 0.0, "count": 0}  # spgemm-lint: guarded-by(_lock)
        # jobs per armed pickup that may batch (1: no mate came within the
        # window), sampled only while the window is open
        self._batch_size = {"buckets": dict.fromkeys(obs_metrics.BATCH_SIZE_BUCKETS, 0),
                            "sum": 0.0, "count": 0}  # spgemm-lint: guarded-by(_lock)
        # flight dumps in this daemon's write order (retention prunes the
        # oldest first even where mtimes tie)
        self._flight_order: list[str] = []  # spgemm-lint: guarded-by(_lock)
        self.queue = JobQueue(self._cap, tenant_inflight=tenant_inflight)
        self._slice_spec = slices if slices is not None \
            else knobs.get("SPGEMM_TPU_SERVE_SLICES")
        self.slices = [_Slice(spec, mesh_mod.slice_device_names(spec, device))
                       for spec in _pool(self._slice_spec, n_devices, device)]
        self.degraded = False                    # spgemm-lint: guarded-by(_lock)
        self.degrade_reason: str | None = None   # spgemm-lint: guarded-by(_lock)
        # the autotuner's class keys carry the card's name, so a vector tuned
        # on one kind of card is never adopted on another; one trial leg per
        # SPGEMM_TPU_TUNE_TRIAL_S across the pool's executors
        self._tune_device_kind = self.device_name or self.device
        self._tune_last_trial = 0.0              # spgemm-lint: guarded-by(_lock)
        self._probe_outcome: str | None = None   # spgemm-lint: guarded-by(_lock)
        self._started_at = time.time()
        self._next_id = 1                        # spgemm-lint: guarded-by(_lock)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._listener: socket.socket | None = None
        self._tcp_listener: socket.socket | None = None
        self._conn_count = 0                     # spgemm-lint: guarded-by(_lock)
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------ journal --
    def _journal_append(self, event: dict) -> None:
        if not self._journal_enabled:
            return
        with self._lock:
            line = journal_frame(event)
            if failpoints.check("serve.journal"):
                # a torn record, as a write cut by a crash leaves it
                line = line[:max(1, len(line) // 2)]
            with open(self.journal_path, "a", encoding="utf-8") as f:
                f.write(line)
            if event.get("event") in TERMINAL:
                self._journal_terminal_events += 1
                if self._journal_terminal_events >= self.JOURNAL_COMPACT_EVERY:
                    self._journal_compact_locked()

    def _journal_live_records(self) -> tuple[list[dict], int]:
        """(submit records with no terminal event, in file order; torn
        records).  Reading stops at the first record that fails its frame
        check: what follows it cannot be attributed."""
        submitted: dict[str, dict] = {}
        torn = 0
        with open(self.journal_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                ev = journal_parse_line(line)
                if ev is None:
                    torn += 1
                    break
                if ev.get("event") == "submit":
                    submitted[ev["id"]] = ev
                elif ev.get("event") in TERMINAL:
                    submitted.pop(ev.get("id"), None)
        return list(submitted.values()), torn

    def _journal_compact_locked(self) -> None:
        """Rewrite the journal to its live submit records (caller holds
        _lock); a torn tail is dropped and counted."""
        live, torn = self._journal_live_records()
        with open(self.journal_path, "w", encoding="utf-8") as f:
            for ev in live:
                f.write(journal_frame(ev))
        self._journal_terminal_events = 0
        self._journal_compactions += 1
        if torn:
            self._journal_torn += torn
            obs_events.emit("journal_torn", records=torn, path=self.journal_path)
            log.warning("journal: dropped %d torn record(s) at the tail of %s",
                        torn, self.journal_path)

    def _journal_replay(self) -> None:
        """Re-queue journaled jobs that never finished, then compact the
        journal to them."""
        if not self._journal_enabled or not os.path.exists(self.journal_path):
            return
        live, _ = self._journal_live_records()
        with self._lock:
            self._journal_compact_locked()
        for ev in live:
            try:
                job = Job(ev["id"], ev["folder"], ev["output"], ev.get("options", {}),
                          timeout_s=ev.get("timeout_s", 0.0),
                          tenant=ev.get("tenant", protocol.DEFAULT_TENANT),
                          trace_id=ev.get("trace"))
            except (KeyError, TypeError) as e:
                log.warning("journal: skipping malformed record %r (%r)", ev, e)
                continue
            self._route(job)  # the folder may have changed
            try:
                self.queue.submit(job)
                log.info("journal: re-queued unfinished job %s (%s)", job.id, job.folder)
            except (QueueFull, TenantCapExceeded) as e:
                code = protocol.E_TENANT_CAP if isinstance(e, TenantCapExceeded) \
                    else protocol.E_QUEUE_FULL
                if job.finish("failed",
                              error={"code": code,
                                     "message": f"{e} while re-queueing from journal"},
                              on_commit=self._commit_terminal(job, "failed", "error")):
                    self._observe_terminal(job, "error")
            tail = ev["id"].rsplit("-", 1)[-1]
            with self._lock:
                self._next_id = max(self._next_id, (int(tail) if tail.isdigit() else 0) + 1)

    # ---------------------------------------------------------- lifecycle --
    def start(self) -> None:
        """Bind the socket, bind the warm store, replay the journal, start
        the accept, executor and watchdog threads.  RuntimeError when a live
        daemon owns the socket; a stale socket file is unlinked."""
        from spgemm_tpu_torch.ops import warmstore  # noqa: PLC0415

        if os.path.exists(self.socket_path):
            peer = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                peer.settimeout(1.0)
                peer.connect(self.socket_path)
            except OSError:
                os.unlink(self.socket_path)  # stale: no listener behind it
            else:
                peer.close()
                raise RuntimeError(f"a daemon is already serving on {self.socket_path}")
        obs_events.LOG.configure(self.events_path)
        obs_events.emit("daemon_start", socket=self.socket_path,
                        slices=[s.name for s in self.slices], pid=os.getpid())
        # loading stays lazy: the first fingerprint match reads its entry
        warmstore.configure(self.warm_dir)
        # the tuner's records are small and read whole: a restarted daemon
        # serves a class's first job tuned (a canary record audits again)
        if tune_mod.enabled():
            tune_mod.TUNER.persist_with(warmstore.save_tune)
            adopted = tune_mod.TUNER.load(warmstore.load_tunes())
            if adopted:
                log.info("tuner: adopted %d persisted override record(s)", adopted)
        self._journal_replay()
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen(16)
        # accept() polls, so the loop sees the stop flag
        self._listener.settimeout(0.2)
        if self._tcp_bind is not None:
            self._tcp_listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._tcp_listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._tcp_listener.bind(self._tcp_bind)
            self._tcp_listener.listen(16)
            self._tcp_listener.settimeout(0.2)
            self.tcp_port = self._tcp_listener.getsockname()[1]
        for sl in self.slices:
            self._spawn_executor(sl)
        loops = [(self._listener, "spgemmd-accept")]
        if self._tcp_listener is not None:
            loops.append((self._tcp_listener, "spgemmd-accept-tcp"))
        for listener, name in loops:
            t = threading.Thread(target=self._accept_loop, args=(listener,), name=name,
                                 daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._watchdog_loop, name="spgemmd-watchdog", daemon=True)
        t.start()
        self._threads.append(t)
        log.info("spgemmd serving on %s%s (slices %s; queue cap %d, job timeout %s)",
                 self.socket_path,
                 f" + tcp:{self._tcp_bind[0]}:{self.tcp_port}" if self.tcp_port else "",
                 ", ".join(f"{sl.name} on {sl.device}" for sl in self.slices), self._cap,
                 self._job_timeout_s or "none")

    def serve_forever(self) -> None:
        self.start()
        try:
            while not self._stop.wait(0.5):
                pass
        finally:
            self.stop()

    def stop(self) -> None:
        """Graceful drain and teardown (the shutdown op, SIGTERM/SIGINT,
        serve_forever's end): admission stops, in-flight jobs get
        DRAIN_GRACE_S, stragglers are failed with shutting-down, the warm
        store flushes and releases its directory, the socket unlinks.
        Queued jobs keep their journal records for the next daemon."""
        from spgemm_tpu_torch.ops import warmstore  # noqa: PLC0415

        self._stop.set()
        for listener in (self._listener, self._tcp_listener):
            if listener is not None:
                try:
                    listener.close()
                except OSError:
                    pass
        deadline = time.time() + self.DRAIN_GRACE_S
        while time.time() < deadline and self.queue.running():
            time.sleep(0.05)
        leftovers = self.queue.running()
        if leftovers:
            obs_events.emit("daemon_drain_reap", jobs=[j.id for j in leftovers])
        for job in leftovers:
            if job.finish("failed", error={
                    "code": protocol.E_SHUTTING_DOWN,
                    "message": f"daemon shut down before the job finished (drained "
                               f"{self.DRAIN_GRACE_S:g}s); resubmit to the next daemon"},
                    detail=self._reap_detail(job),
                    on_commit=self._commit_terminal(job, "failed", "drained")):
                self._observe_terminal(job, "drained")
        for t in self._threads:
            t.join(timeout=5.0)
        for sl in self.slices:
            if sl.thread is not None:
                sl.thread.join(timeout=5.0)  # a wedged executor is a daemon thread
        warmstore.flush()
        warmstore.release()
        # the event log's writer drains, so a clean shutdown leaves the file whole
        obs_events.LOG.flush(timeout=2.0)
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    def degrade_at_start(self, reason: str, probe_outcome: str | None = None) -> None:
        """Mark every slice degraded before serving (main() when the startup
        probe finds the card dead): jobs run on the host oracle until a
        slice's re-probe (SPGEMM_TPU_SERVE_RECOVER_S > 0) finds its card."""
        with self._lock:
            self._probe_outcome = probe_outcome
            for sl in self.slices:
                sl.degraded = True
                sl.degrade_reason = reason
                sl.recover_backoff = self._recover_s
                sl.recover_next = time.time() + self._recover_s
                if sl.thread is not None:
                    self._spawn_executor(sl)  # already serving: the oracle's turn
            self.degraded = True
            self.degrade_reason = reason
        for sl in self.slices:
            obs_events.emit("daemon_degrade", reason=reason, slice=sl.name, probe=probe_outcome)

    @staticmethod
    def _route(job: Job) -> None:
        """Admission's reads of the folder, stat calls and book lookups,
        never a parse: the placement record and the batching group key (the
        chain structure the structure book recorded for this content; None
        on first contact)."""
        from spgemm_tpu_torch.ops import plancache  # noqa: PLC0415

        job.placement = placement.route(job.folder)
        job.group_key = plancache.chain_structure(placement.signature(job.folder))

    def _eligible(self, job: Job) -> list[_Slice]:
        """The healthy slices the job may run on: all of them, but for a job
        under mxu only the single-device ones while any is healthy (a wide
        slice's sharded fold is the exact one, not the field mode's)."""
        healthy = [s for s in self.slices if not s.degraded]
        if engine_backend(job.options.get("backend")) == "mxu":
            return [s for s in healthy if s.width == 1] or healthy
        return healthy

    def _preferred_names(self, job: Job) -> set[str]:
        """The eligible slices (_eligible) the job's placement class
        targets: `small` the narrowest width, `large` the widest, `default`
        (and a job with no record) the spec's default slices, else the
        narrowest.  Empty when no slice is healthy."""
        healthy = self._eligible(job)
        if not healthy:
            return set()
        cls = (job.placement or {}).get("class", "default")
        if cls == "large":
            pick = max(s.width for s in healthy)
            return {s.name for s in healthy if s.width == pick}
        if cls != "small":
            defaults = {s.name for s in healthy if s.spec.default}
            if defaults:
                return defaults
        pick = min(s.width for s in healthy)
        return {s.name for s in healthy if s.width == pick}

    def _devices_held(self, sl: _Slice) -> bool:
        """Whether another slice that holds a job shares a device with sl
        (`auto`'s full-mesh slice overlaps the singles)."""
        return any(other is not sl and other.current is not None
                   and other.spec.overlaps(sl.spec) for other in self.slices)

    def _accepts(self, sl: _Slice, job: Job) -> bool:
        """The executor's dispatch predicate, run under the queue's lock
        (never the daemon's: it reads the slices' handoff slots as they
        are).  Refused while another executor generation holds a live job
        on the slice (a reinstatement overlaps the retiring degraded
        executor for one poll; a terminal leftover claim is an abandoned
        executor's and is overwritten).  A degraded slice serves only while
        every slice is degraded.  Otherwise the job is taken where the
        slice is one of its preferred slices, and stolen (job.stolen) when
        every preferred slice is busy, degraded or has a device held, by a
        slice the job is eligible for (_eligible: never a wide one for a
        job under mxu while a single-device slice is healthy).
        True claims the slice (sl.current = job) under the queue's lock, so
        an overlapping slice deciding in the same round sees its devices
        held: the claim is the point of mutual exclusion."""
        cur = sl.current
        if cur is not None and cur.state not in TERMINAL:
            return False
        if sl.degraded:
            if any(not s.degraded for s in self.slices):
                return False
            job.stolen = False
            sl.current = job
            return True
        if self._devices_held(sl):
            return False
        preferred = self._preferred_names(job)
        if sl.name not in preferred:
            if sl not in self._eligible(job):
                return False
            for other in self.slices:
                if other.name in preferred and other.current is None \
                        and not self._devices_held(other):
                    return False  # a preferred slice is free: leave it the job
        job.stolen = sl.name not in preferred
        sl.current = job
        return True

    # ----------------------------------------------------------- executor --
    def _spawn_executor(self, sl: _Slice) -> None:
        """A new executor generation for the slice, on the card or, when the
        slice is degraded, on the host oracle: fixed for the thread's life
        (caller holds _lock, or is start())."""
        sl.gen += 1
        gen = sl.gen
        sl.thread = threading.Thread(target=self._executor_loop, args=(sl, gen, sl.degraded),
                                     name=f"spgemmd-executor-{sl.name}-{gen}", daemon=True)
        sl.thread.start()

    def _executor_loop(self, sl: _Slice, gen: int, degraded: bool) -> None:
        while not self._stop.is_set() and gen == sl.gen:
            # gen is checked inside accept too: a reinstatement bumps it while
            # the retiring executor waits in next()
            job = self.queue.next(timeout=0.2,
                                  accept=lambda j: gen == sl.gen and self._accepts(sl, j))
            if job is None:
                self._maybe_tune(sl, gen)
                continue
            if job.state != "queued":  # reaped while still queued
                if sl.current is job:
                    sl.current = None
                continue
            job.slice, job.devices = sl.name, sl.devices
            tcanary = self._tune_activate(job)
            with self._lock:
                # an oracle executor whose slice a live probe reinstated while
                # it took this job runs it on the card: the oracle only ever
                # serves a slice that is degraded now
                on_oracle = degraded and sl.degraded
                canary = sl.canary and not on_oracle
                if canary:
                    # the first job after a reinstatement auditions the card
                    sl.canary = False
                    sl.canary_job = job
                sl.jobs_total += 1
                sl.oracle_jobs += on_oracle
                sl.steals += job.stolen
            if canary:
                # a tightened deadline: a card still wedged costs one short job
                tight = job.timeout_s / 2 if job.timeout_s > 0 else self._wedge_grace_s
                if tight > 0:
                    job.timeout_s = tight
                obs_events.emit("slice_canary", slice=sl.name, job_id=job.id,
                                timeout_s=job.timeout_s)
            if tcanary:
                # the first job under a freshly promoted vector: a vector that
                # misbehaves costs one short job, and note_terminal reverts it
                tight = job.timeout_s / 2 if job.timeout_s > 0 else self._wedge_grace_s
                if tight > 0:
                    job.timeout_s = tight
            # a pickup on the card drains its batch mates; pickups of an oracle
            # executor and canaries never batch (an audition risks one job)
            mates = [] if degraded or canary or tcanary \
                else self._drain_batch_mates(sl, job)
            self._run_pickup(sl, job, mates, on_oracle)

    def _tune_activate(self, job: Job) -> bool:
        """The autotuner at pickup: the job's class, the overlay swapped to
        the class's vector (the base where it has none; ENGINE phase
        tune_apply when it changes), the estimator's account for the
        terminal diff.  True when this job is the class's tuned canary.
        No-ops under SPGEMM_TPU_TUNE=0 or for a class with nothing tuned."""
        from spgemm_tpu_torch.ops import plancache  # noqa: PLC0415

        job.tune_class = plancache.tune_class_key(job.group_key, self._tune_device_kind)
        overlay = tune_mod.TUNER.overlay_for(job.tune_class)
        if overlay != knobs.tuned_overlay():
            with ENGINE.phase("tune_apply"):
                knobs.set_tuned(overlay)
        job.est_base = obs_profile.est_stats()
        return tune_mod.TUNER.consume_canary(job.tune_class)

    def _run_pickup(self, sl: _Slice, head: Job, mates: list[Job], on_oracle: bool) -> None:
        """Run a pickup: the head alone (the runner, on the host oracle when
        on_oracle), or the head and its batch mates (the batch runner, on the
        card).  Every member keeps its own PhaseScope, all opened on this
        thread, so each sees the phases and the launches they shared; its own
        queue wait (recorded into its scope alone), journal record and
        terminal answer.  Only the head is sl.current, the watchdog's job:
        when it is reaped its chain ends at the next heartbeat and the mates
        fail with a structured error.  A pickup that raises fails every
        member with the error; nothing reruns it on the host.  Only the
        canary's own end settles an audition (a retired executor's late
        return proves nothing), and a job error on the card settles it too:
        it proves the executor responsive."""
        from spgemm_tpu_torch.ops import plancache, warmstore  # noqa: PLC0415

        # a mate reaped while queued was already finished by the watchdog
        jobs = [head] + [m for m in mates if m.state == "queued"]
        batched = len(jobs) > 1
        for m in jobs[1:]:
            m.slice, m.devices = sl.name, sl.devices
        if batched:
            with self._lock:
                sl.jobs_total += len(jobs) - 1  # the head was counted at pickup
            ENGINE.incr("serve_batches")
            ENGINE.incr("serve_batched_jobs", len(jobs))
            for j in jobs:
                j.batch_id = head.id
        for job in jobs:
            job.start()
        # a hang here is where a dead card hangs a job: after pickup
        failpoints.check("serve.executor")
        if head.stolen:
            ENGINE.incr("serve_steals")
        scopes = [ENGINE.scope() for _ in jobs]
        cache_base = plancache.baseline()
        # set before the head is sl.current's work: the watchdog reads them
        for job, scope in zip(jobs, scopes):
            job.scope, job.scope_degraded, job.cache_base = scope, on_oracle, cache_base
        sl.current = head
        # every span of the pickup (this thread's and its planner thread's)
        # carries the head's job id, its end-to-end trace context and the
        # slice; a batch's also its batch id
        tags = {"job_id": head.id, "trace_id": head.trace_id, "slice": sl.name,
                "batch_id": head.id if batched else None}
        try:
            with obs_trace.RECORDER.tagged(**tags):
                for job, scope in zip(jobs, scopes):
                    obs_events.emit("job_start", job_id=job.id, trace_id=job.trace_id,
                                    batch_id=job.batch_id, degraded=on_oracle,
                                    folder=job.folder, slice=sl.name, tenant=job.tenant)
                    # into the member's own scope: ENGINE.record would reach
                    # every scope this thread carries
                    scope.record("serve_queue_wait",
                                 max(0.0, (job.started_at or job.submitted_at) - job.submitted_at))
                    # the member's own memory window, seeded with the newest
                    # reading; the engine's samples land in the window of
                    # the thread's job tag: the head's
                    obs_profile.memory_job_begin(job.id)
                with ENGINE.phase("serve_execute"):
                    if batched:
                        self._batch_runner(jobs, degraded=False)
                    else:
                        self._runner(head, degraded=on_oracle)
        except JobAbandoned:
            # the watchdog finished the head; its chain ended at a heartbeat
            log.info("job %s abandoned mid-chain (%d in its pickup)", head.id, len(jobs))
            for job, scope in zip(jobs[1:], scopes[1:]):
                self._finish(job, scope, on_oracle, "failed", {
                    "code": protocol.E_JOB_ERROR,
                    "message": f"co-batched with job {head.id}, which was reaped "
                               "mid-chain; resubmit"})
            if batched:
                warmstore.flush()  # terminal events: persist what the batch warmed
        except Exception as e:  # noqa: BLE001 -- a job must not kill the loop
            log.warning("job %s failed (%d in its pickup): %r", head.id, len(jobs), e)
            for job, scope in zip(jobs, scopes):
                self._finish(job, scope, on_oracle, "failed",
                             {"code": protocol.E_JOB_ERROR, "message": repr(e)})
            if not on_oracle and sl.canary_job is head:
                self._canary_settle(sl)
            warmstore.flush()
        else:
            for job, scope in zip(jobs, scopes):
                self._finish(job, scope, on_oracle, "done")
            if not on_oracle and sl.canary_job is head:
                self._canary_settle(sl)
            warmstore.flush()
        finally:
            # an abandoned executor that comes back late closes its own jobs'
            # scopes, and clears the slot only if it is still its own
            for scope in scopes:
                scope.close()
            if sl.current is head:
                sl.current = None

    def _finish(self, job: Job, scope, on_oracle: bool, state: str,
                error: dict | None = None) -> None:
        """The executor's terminal transition of a job, with its detail, its
        journal record and its event; bookkeeping only if this transition
        won."""
        outcome = "done" if state == "done" else "error"
        if job.finish(state, error=error, detail=self._job_detail(scope, on_oracle, job),
                      on_commit=self._commit_terminal(job, state, outcome)):
            self._observe_terminal(job, outcome)
            if state == "done":
                obs_events.emit("job_done", job_id=job.id, trace_id=job.trace_id,
                                batch_id=job.batch_id)
            else:
                obs_events.emit("job_failed", job_id=job.id, trace_id=job.trace_id,
                                batch_id=job.batch_id, error=(error or {}).get("message"))

    # ----------------------------------------------------------- batching --
    def _drain_batch_mates(self, sl: _Slice, head: Job) -> list[Job]:
        """With the window armed (SPGEMM_TPU_SERVE_BATCH_WINDOW_S > 0), up
        to SPGEMM_TPU_SERVE_BATCH_K - 1 queued jobs of the head's group key,
        deadline, backend and round_size, through the queue's fair pass.
        No batch on a wide slice (the sharded multiply has no batched
        form), for a head without a group key (first contact), under
        SPGEMM_TPU_DELTA (retained results would splice across jobs), or
        with checkpoint_dir or failover (state of the job's own chain).  A
        window of 0 returns at once: the executor of one job at a time."""
        window_s = knobs.get("SPGEMM_TPU_SERVE_BATCH_WINDOW_S")
        if window_s <= 0:
            return []
        batch_k = knobs.get("SPGEMM_TPU_SERVE_BATCH_K")
        if batch_k <= 1 or sl.width > 1 or head.group_key is None \
                or knobs.get("SPGEMM_TPU_DELTA") \
                or head.options.get("checkpoint_dir") or head.options.get("failover"):
            return []

        def match(j: Job) -> bool:
            # under the queue lock: attribute reads only
            return (j.group_key == head.group_key and j.timeout_s == head.timeout_s
                    and not j.options.get("checkpoint_dir") and not j.options.get("failover")
                    and j.options.get("backend") == head.options.get("backend")
                    and j.options.get("round_size") == head.options.get("round_size"))

        mates = self.queue.drain_batch(batch_k - 1, window_s, match)
        with self._lock:
            _observe_locked(self._batch_size, 1 + len(mates))
        return mates

    @staticmethod
    def _job_detail(scope, degraded: bool, job: Job | None = None) -> dict:
        """A job's status detail: its own phases and ENGINE counters (the
        PhaseScope), its plan-cache counts since pickup, where it ran."""
        from spgemm_tpu_torch.ops import plancache  # noqa: PLC0415

        counters = scope.counter_snapshot()
        # the job's device memory high-water mark; omitted (never 0) where
        # the device did not report, as on the CPU
        hbm_peak = obs_profile.memory_job_peak(job.id if job is not None else None)
        renamed = {"plan_cache_hits": "plan_cache_hits",
                   "plan_cache_misses": "plan_cache_misses",
                   "delta_rows_recomputed": "delta_rows", "delta_rows_total": "total_rows"}
        return {"phases_s": scope.snapshot(), "degraded": degraded,
                "plan_cache": plancache.stats(since=job.cache_base if job else None),
                **({"hbm_peak_bytes": hbm_peak} if hbm_peak is not None else {}),
                **({"slice": job.slice, "device": job.device, "tenant": job.tenant}
                   if job is not None else {}),
                **{short: counters.get(name, 0) for name, short in renamed.items()},
                **{k: v for k, v in counters.items() if k not in renamed}}

    def _reap_detail(self, job: Job) -> dict | None:
        """A reaped job's detail, from its executor's live scope."""
        if job.scope is None:
            return None
        return self._job_detail(job.scope, job.scope_degraded, job)

    def _observe_terminal(self, job: Job, outcome: str) -> None:
        """Bookkeeping of a terminal transition this daemon committed: the
        tenant's in-flight slot, the outcome totals, the job-wall histogram
        (pickup, or submit for a job never picked up, to the end) and one
        record into the SLO engine's (tenant, slice) window.  The
        autotuner's feed ran earlier, in the transition's commit hook
        (_commit_terminal)."""
        self.queue.release(job)
        snap = job.snapshot()
        started = snap["started_at"] or snap["submitted_at"]
        wall = max(0.0, (snap["finished_at"] or time.time()) - started)
        with self._lock:
            self._terminal_totals[outcome] = self._terminal_totals.get(outcome, 0) + 1
            _observe_locked(self._job_wall, wall)
        # outside self._lock: the SLO engine has its own lock, and a burn
        # transition's event takes the event log's.  Queue wait is admission
        # to pickup (the whole wall of a job reaped before pickup).
        queue_wait = max(0.0, (snap["started_at"] or snap["finished_at"]
                               or snap["submitted_at"]) - snap["submitted_at"])
        obs_slo.SLO.observe(tenant=job.tenant, slice_name=job.slice or "unplaced",
                            wall_s=wall, queue_wait_s=queue_wait, error=outcome != "done",
                            trace_id=job.trace_id)

    def _commit_terminal(self, job: Job, state: str, outcome: str):
        """The commit hook of a terminal transition (Job.finish's on_commit):
        the journal record, then the autotuner's feed, both before any
        waiter wakes, so a client that saw a tuned canary fail reads the
        class reverted, in the tuner and in its warm-store record.  The hook
        runs under the job's lock, which so nests over the tuner's, the
        placement book's and obs/profile's: none of those is held while a
        job's lock is taken anywhere, so the nesting cannot deadlock.  The
        JAX daemon feeds its tuner after the wake (its locks never nest);
        this order is a deliberate difference (ROADMAP.md section 3)."""
        def commit() -> None:
            self._journal_append({"event": state, "id": job.id})
            self._tune_terminal(job, outcome)
        return commit

    def _tune_terminal(self, job: Job, outcome: str) -> None:
        """The autotuner's feed of a terminal job: the class sighting and
        its folder, a tuned canary's outcome, and the estimator's mean
        relative error over the job (obs/profile's account against the
        pickup's).  Nothing for a first-contact or never-picked-up job, nor
        for a batch's mates (no class)."""
        ck = job.tune_class
        if ck is None:
            return
        tune_mod.TUNER.note_job(ck, self._tune_device_kind)
        placement.note_class(ck, job.folder)
        tune_mod.TUNER.note_terminal(ck, outcome == "done")
        if job.est_base is not None:
            base = job.est_base.get("rel_error") or {}
            errs = []
            for qty, hist in obs_profile.est_stats()["rel_error"].items():
                prev = base.get(qty, {"sum": 0.0, "count": 0})
                dn = hist["count"] - prev["count"]
                if dn > 0:
                    errs.append((hist["sum"] - prev["sum"]) / dn)
            if errs:
                tune_mod.TUNER.note_est_accuracy(ck, sum(errs) / len(errs))

    def _flight_dump(self, name: str) -> str | None:
        """Dump the flight recorder to <socket>.flight/<name>.trace.json
        (trace_event JSON): the evidence of a reap, a wedge or a degrade.
        Keeps the newest FLIGHT_RETAIN dumps: this daemon's in write order,
        an earlier daemon's by mtime before them.  Only OSError is caught:
        a failed dump is a warning, never the watchdog's end."""
        path = os.path.join(self.flight_dir, f"{name}.trace.json")
        try:
            obs_trace.dump_json(path)
        except OSError as e:
            log.warning("flight dump %s failed: %r", path, e)
            return None
        try:
            with self._lock:
                if path in self._flight_order:
                    self._flight_order.remove(path)  # a re-dump is the newest
                self._flight_order.append(path)
                ours = list(self._flight_order)
            on_disk = {os.path.join(self.flight_dir, f) for f in os.listdir(self.flight_dir)
                       if f.endswith(".trace.json")}
            ordered = sorted(on_disk - set(ours), key=os.path.getmtime) \
                + [q for q in ours if q in on_disk]
            for stale in ordered[:max(0, len(ordered) - self.FLIGHT_RETAIN)]:
                os.unlink(stale)
                with self._lock:
                    if stale in self._flight_order:
                        self._flight_order.remove(stale)
        except OSError as e:
            log.warning("flight-dump pruning failed (dump %s is on disk): %r", path, e)
        log.info("flight recorder dumped to %s", path)
        return path

    # ----------------------------------------------------------- autotune --
    def _maybe_tune(self, sl: _Slice, gen: int) -> None:
        """The idle tick's autotuner hook: with trials armed
        (SPGEMM_TPU_TUNE_TRIAL_S > 0, SPGEMM_TPU_TUNE on), at most one leg,
        only while the whole pool is idle, the queue empty and the slice
        neither degraded nor auditioning; the cadence stamp is claimed under
        _lock.  A leg never touches the queue, a tenant's accounting or an
        SLO window."""
        if self._stop.is_set() or gen != sl.gen:
            return
        cadence = tune_mod.trial_cadence_s()
        if cadence <= 0 or not tune_mod.enabled():
            return
        now = time.monotonic()
        with self._lock:
            if sl.degraded or sl.canary:
                return
            if any(s.current is not None for s in self.slices):
                return
            if now - self._tune_last_trial < cadence:
                return
            self._tune_last_trial = now
        if self.queue.counts()["depth"] > 0:
            return
        tune_mod.run_trial_leg(self._tune_run_fn(sl, gen), placement.rep_folder,
                               extra={"SPGEMM_TPU_DELTA": "0"})

    def _tune_run_fn(self, sl: _Slice, gen: int):
        """A trial leg's runner: read the class's folder, reduce its chain
        on the slice's (first) device as a solo `exact` job on a
        single-device slice would, and return a digest of the result's
        coords and tiles (the tuner's parity spot-check; every slice's
        devices are of one kind, so the ranking holds for any slice).  The
        heartbeat it plants before the read and between multiplies raises
        TrialPreempted once a job is queued, the daemon stops or this
        executor generation retired."""
        def run(folder: str) -> str:
            from spgemm_tpu_torch import chain  # noqa: PLC0415 -- the engine loads lazily
            from spgemm_tpu_torch.utils import io_text  # noqa: PLC0415

            def beat() -> None:
                if self._stop.is_set() or gen != sl.gen or self.queue.counts()["depth"] > 0:
                    raise tune_mod.TrialPreempted(folder)

            beat()  # a job may have landed between the claim and here
            n, k = io_text.read_size(folder)
            mats = io_text.read_chain(folder, 0, n - 1, k)
            return result_digest(chain.chain_product(mats, device=sl.devices[0], heartbeat=beat))

        return run

    # ----------------------------------------------------------- watchdog --
    def _watchdog_loop(self) -> None:
        """Reap overdue jobs; detect a dead or wedged executor; re-probe a
        degraded slice."""
        while not self._stop.wait(0.05):
            for sl in self.slices:
                self._watch_slice(sl)
                self._maybe_recover(sl)

    def _watch_slice(self, sl: _Slice) -> None:
        job = sl.current
        ex = sl.thread
        if ex is not None and not ex.is_alive():
            # every running job of the slice, not only sl.current: a dying
            # thread's finally may have cleared the slot
            reason = f"executor thread for slice {sl.name} died"
            for orphan in self.queue.running():
                if orphan.slice != sl.name:
                    continue
                if orphan.finish("failed", error={"code": protocol.E_EXECUTOR_DIED,
                                                  "message": "executor thread died mid-job"},
                                 detail=self._reap_detail(orphan),
                                 on_commit=self._commit_terminal(orphan, "failed",
                                                                 "abandoned")):
                    reason += f" during job {orphan.id}"
                    self._observe_terminal(orphan, "abandoned")
                    obs_events.emit("job_failed", job_id=orphan.id, trace_id=orphan.trace_id,
                                    error="executor thread died mid-job")
                    self._flight_dump(orphan.id)
            self._degrade_slice(sl, reason)
            return
        if job is not None and sl.reaped is not job and job.overdue():
            if job.finish("failed", error={"code": protocol.E_JOB_TIMEOUT,
                                           "message": f"job exceeded its {job.timeout_s:g}s "
                                                      "deadline and was reaped"},
                          detail=self._reap_detail(job),
                          on_commit=self._commit_terminal(job, "failed", "timeout")):
                sl.reaped, sl.reaped_at = job, time.time()
                ENGINE.incr("serve_reaps")
                obs_trace.RECORDER.instant("serve_reap", job_id=job.id, trace_id=job.trace_id,
                                           slice=sl.name)
                obs_events.emit("watchdog_reap", job_id=job.id, trace_id=job.trace_id,
                                timeout_s=job.timeout_s, slice=sl.name)
                self._observe_terminal(job, "timeout")
                self._flight_dump(job.id)
        reaped = sl.reaped
        if reaped is not None and sl.current is reaped:
            hb = reaped.heartbeat_at or 0.0
            if hb > sl.reaped_at:
                # the job still beats: slow, not wedged; the grace restarts
                sl.reaped_at = hb
            elif time.time() - sl.reaped_at > self._wedge_grace_s:
                sl.reaped = None
                self._flight_dump(f"{reaped.id}.wedged")
                obs_events.emit("watchdog_wedge", job_id=reaped.id, trace_id=reaped.trace_id,
                                grace_s=self._wedge_grace_s, slice=sl.name)
                self._degrade_slice(sl, f"executor wedged on reaped job {reaped.id}")
        elif reaped is not None and sl.current is not reaped:
            sl.reaped = None  # the executor moved on: slow, not wedged
            # a canary outlived by its executor settles the audition
            self._canary_settle(sl)

    def _degrade_slice(self, sl: _Slice, reason: str) -> None:
        """Retire the slice's executor, record why, and probe the card from
        a subprocess (off-thread: the probe may take its whole time limit
        against a dead card).  Jobs stay queued until the probe's outcome
        decides what serves them (_recover_probe).  An oracle executor that
        dies or wedges is replaced on the oracle, with no probe."""
        if self._stop.is_set():
            return
        with self._lock:
            if sl.degraded:
                sl.degrade_reason = reason
                self._spawn_executor(sl)
                return
            sl.degraded = True
            sl.degrade_reason = reason
            # a failed audition ends with the probe like any other degrade
            sl.canary = False
            sl.canary_job = None
            sl.probing = True
            sl.gen += 1  # the retired executor takes no further job
            sl.thread = None
            self.degraded = all(s.degraded for s in self.slices)
            if self.degraded:
                self.degrade_reason = reason
        print(f"spgemmd: slice {sl.name} ({sl.device}) degraded: {reason}; probing the card "
              "(jobs wait for its outcome)", file=sys.stderr, flush=True)
        ENGINE.incr("serve_degrades")
        obs_trace.RECORDER.instant("serve_degrade", job_id=None, slice=sl.name)
        obs_events.emit("daemon_degrade", reason=reason, slice=sl.name)
        self._flight_dump("degrade")
        threading.Thread(target=self._recover_probe, args=(sl,),
                         name=f"spgemmd-probe-{sl.name}", daemon=True).start()

    def _probe_fn(self):
        if self._probe is not None:
            return self._probe
        from spgemm_tpu_torch.utils.backend_probe import probe_default_backend  # noqa: PLC0415
        return probe_default_backend

    def _probe_live(self, outcome: str) -> bool:
        """Whether a probe outcome shows the daemon's device working: the
        card computed (`ok`), or, for a daemon on the CPU, the probe ran."""
        return outcome == "ok" or (self.device == "cpu" and outcome == "cpu")

    # ----------------------------------------------------------- recovery --
    def _bump_backoff_locked(self, sl: _Slice) -> None:
        """Double the slice's re-probe backoff and re-arm its timer (caller
        holds _lock)."""
        sl.recover_backoff = min(max(sl.recover_backoff, self._recover_s) * 2,
                                 self.RECOVER_BACKOFF_MAX_S)
        sl.recover_next = time.time() + sl.recover_backoff

    def _maybe_recover(self, sl: _Slice) -> None:
        """With SPGEMM_TPU_SERVE_RECOVER_S on and the backoff of a slice on
        the oracle run out, launch one re-probe off-thread."""
        if self._recover_s <= 0 or self._stop.is_set():
            return
        with self._lock:
            if not sl.degraded or sl.probing or time.time() < sl.recover_next:
                return
            sl.probing = True
        threading.Thread(target=self._recover_probe, args=(sl,),
                         name=f"spgemmd-recover-{sl.name}", daemon=True).start()

    def _recover_probe(self, sl: _Slice) -> None:
        """One probe of a degraded slice's card.  Live: the slice is
        reinstated at once behind the canary gate, whatever
        SPGEMM_TPU_SERVE_RECOVER_S is.  Dead, right after a degrade: the
        slice goes to the host oracle, the only way a job reaches it
        mid-flight, and RECOVER_S sets when the card is probed again.  Dead
        on a re-probe: the backoff doubles."""
        try:
            outcome = self._probe_fn()()
        except Exception as e:  # noqa: BLE001 -- a crashing probe is a dead card
            outcome = f"probe-error: {e!r}"
        live = self._probe_live(outcome)
        with self._lock:
            sl.probing = False
            self._probe_outcome = outcome
            if self._stop.is_set() or not sl.degraded:
                return
            to_oracle = not live and sl.thread is None
            if live:
                sl.canary = True
                sl.canary_job = None
                sl.recoveries += 1
                sl.recovered_at = time.time()
                sl.degrade_reason = None
                sl.degraded = False
                self.degraded = all(s.degraded for s in self.slices)
                if not self.degraded:
                    self.degrade_reason = None
                # spawned under the lock, so a concurrent degrade cannot slip
                # between the flags and the executor
                self._spawn_executor(sl)
            elif to_oracle:
                sl.recover_backoff = self._recover_s
                sl.recover_next = time.time() + self._recover_s
                self._spawn_executor(sl)
            else:
                self._bump_backoff_locked(sl)
        if live:
            ENGINE.incr("serve_recoveries")
            obs_trace.RECORDER.instant("serve_recover", job_id=None, slice=sl.name)
            obs_events.emit("slice_recovered", slice=sl.name, outcome=outcome)
            log.warning("slice %s reinstated after a live probe (%s); its next job is the "
                        "canary", sl.name, outcome)
            return
        obs_events.emit("slice_recover_probe", slice=sl.name, outcome=outcome, live=False,
                        to_oracle=to_oracle)
        if to_oracle:
            print(f"spgemmd: slice {sl.name} ({sl.device}) serves on the host oracle: the "
                  f"card probe found it dead ({outcome})", file=sys.stderr, flush=True)
        else:
            log.info("slice %s recovery probe: %s (still degraded; next in %.1fs)",
                     sl.name, outcome, sl.recover_backoff)

    def _canary_settle(self, sl: _Slice) -> None:
        """A finished job on a canary slice passes the audition: full trust,
        backoff reset."""
        with self._lock:
            if sl.degraded or (not sl.canary and sl.canary_job is None):
                return
            sl.canary = False
            sl.canary_job = None
            sl.recover_backoff = 0.0
        obs_events.emit("slice_canary_passed", slice=sl.name)

    # ----------------------------------------------------------- protocol --
    def _accept_loop(self, listener: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # the listener closed at shutdown
            failpoints.check("serve.accept")
            with self._lock:
                admit = self._conn_count < self.MAX_CONNS
                if admit:
                    self._conn_count += 1
            if not admit:
                try:
                    conn.sendall(protocol.encode(protocol.error(
                        protocol.E_BUSY,
                        f"too many concurrent connections ({self.MAX_CONNS}); retry shortly")))
                except OSError:
                    pass
                conn.close()
                continue
            conn.settimeout(self.CONN_IDLE_TIMEOUT_S)
            threading.Thread(target=self._handle_conn, args=(conn,), name="spgemmd-conn",
                             daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            for line in protocol.read_lines(conn, max_line=protocol.MAX_LINE_BYTES):
                failpoints.check("serve.readline")
                if not line.strip():
                    continue
                try:
                    msg = protocol.parse_request(line)
                except protocol.ProtocolError as e:
                    resp = protocol.error(e.code, e.message)
                else:
                    try:
                        resp = self._dispatch(msg)
                    except Exception as e:  # noqa: BLE001 -- the daemon survives
                        log.warning("request handler failed: %r", e)
                        resp = protocol.error(protocol.E_INTERNAL, repr(e))
                conn.sendall(protocol.encode(resp))
        except protocol.ProtocolError as e:
            # an oversized line: answer once, then drop the connection
            try:
                conn.sendall(protocol.encode(protocol.error(e.code, e.message)))
            except OSError:
                pass
        except OSError:
            pass  # the peer went away, or idled out
        finally:
            conn.close()
            with self._lock:
                self._conn_count -= 1

    def _dispatch(self, msg: dict) -> dict:
        op = msg["op"]
        if op == "submit":
            return self._op_submit(msg)
        if op in ("status", "wait"):
            return self._job_answer(msg.get("id"), wait=op == "wait",
                                    timeout=msg.get("timeout"))
        if op == "stats":
            return self._op_stats()
        if op == "metrics":
            return self._op_metrics()
        if op == "trace":
            return self._op_trace()
        if op == "events":
            return self._op_events(msg)
        if op == "profile":
            return self._op_profile()
        if op == "slo":
            return self._op_slo()
        self._stop.set()  # shutdown: serve_forever (or the owner's stop()) tears down
        return protocol.ok(stopping=True)

    def _op_submit(self, msg: dict) -> dict:
        if self._stop.is_set():
            return protocol.error(protocol.E_SHUTTING_DOWN, "daemon is shutting down")
        folder = msg.get("folder")
        if not isinstance(folder, str) or not folder:
            return protocol.error(protocol.E_BAD_REQUEST, "submit requires a non-empty `folder`")
        options = msg.get("options") or {}
        if not isinstance(options, dict):
            return protocol.error(protocol.E_BAD_REQUEST, "`options` must be a JSON object")
        unknown = sorted(set(options) - set(SUBMIT_OPTIONS))
        if unknown:
            return protocol.error(protocol.E_BAD_REQUEST,
                                  f"unknown submit option(s) {', '.join(unknown)} (known: "
                                  f"{', '.join(SUBMIT_OPTIONS)})")
        tenant = msg.get("tenant", protocol.DEFAULT_TENANT)
        if not protocol.valid_tenant(tenant):
            return protocol.error(protocol.E_BAD_REQUEST,
                                  f"tenant must be 1-{protocol.TENANT_MAX_LEN} chars of "
                                  f"[A-Za-z0-9._:-], got {tenant!r}")
        trace_ctx = msg.get("trace")
        if trace_ctx is not None and not protocol.valid_trace(trace_ctx):
            return protocol.error(protocol.E_BAD_REQUEST,
                                  f"trace must be {protocol.TRACE_HEX_LEN} lowercase hex chars "
                                  f"(a 128-bit trace context), got {trace_ctx!r}")
        rs = options.get("round_size")
        if rs is not None:
            try:
                rs_ok = int(rs) >= 1
            except (TypeError, ValueError):
                rs_ok = False
            if not rs_ok:
                return protocol.error(protocol.E_BAD_REQUEST,
                                      f"round_size must be an integer >= 1, got {rs!r}")
        backend = options.get("backend")
        known = (*protocol.CHAIN_BACKENDS, *protocol.BACKEND_ALIASES)
        if backend is not None and backend not in known:
            return protocol.error(protocol.E_BAD_REQUEST,
                                  f"unknown backend {backend!r} (known: {', '.join(known)})")
        if not os.path.isfile(os.path.join(folder, "size")):
            return protocol.error(protocol.E_BAD_REQUEST,
                                  f"{folder!r} is not a chain input directory (no `size` file)")
        output = options.get("output") or os.path.join(folder, "matrix")
        # an explicit 0 means no deadline; only an absent option takes the default
        ts = options.get("timeout_s")
        try:
            timeout_s = float(self._job_timeout_s if ts is None else ts)
        except (TypeError, ValueError):
            return protocol.error(protocol.E_BAD_REQUEST, f"timeout_s must be a number, got {ts!r}")
        if timeout_s < 0:
            return protocol.error(protocol.E_BAD_REQUEST,
                                  f"timeout_s must be >= 0 (0 = no deadline), got {ts!r}")
        with self._lock:
            job_id = f"job-{self._next_id}"
            self._next_id += 1
        job = Job(job_id, folder, output, options, timeout_s=timeout_s, tenant=tenant,
                  trace_id=trace_ctx)
        self._route(job)
        # journaled before it is queued: its terminal record can never come
        # first, so a replay never runs a finished job again
        self._journal_append({"event": "submit", "id": job.id, "folder": folder,
                              "output": output, "options": options, "timeout_s": timeout_s,
                              "tenant": tenant, "trace": job.trace_id})
        try:
            depth = self.queue.submit(job)
        except QueueFull as e:
            self._journal_append({"event": "failed", "id": job.id})
            return protocol.error(protocol.E_QUEUE_FULL,
                                  f"queue full ({e.cap} jobs queued); retry later or raise "
                                  "SPGEMM_TPU_SERVE_QUEUE_CAP", id=None)
        except TenantCapExceeded as e:
            self._journal_append({"event": "failed", "id": job.id})
            return protocol.error(protocol.E_TENANT_CAP,
                                  f"tenant {e.tenant!r} already has {e.cap} jobs in flight; "
                                  "wait for one to finish or raise "
                                  "SPGEMM_TPU_SERVE_TENANT_INFLIGHT", id=None)
        obs_events.emit("job_submit", job_id=job.id, folder=folder, queued=depth, tenant=tenant,
                        trace_id=job.trace_id, placement=job.placement)
        return protocol.ok(id=job.id, state=job.state, queued=depth, trace=job.trace_id)

    def _job_answer(self, job_id, wait: bool = False, timeout=None) -> dict:
        job = self.queue.get(job_id) if isinstance(job_id, str) else None
        if job is None:
            return protocol.error(protocol.E_UNKNOWN_JOB, f"no such job: {job_id!r}")
        if wait:
            try:
                timeout = self.MAX_WAIT_SLICE_S if timeout is None \
                    else min(float(timeout), self.MAX_WAIT_SLICE_S)
            except (TypeError, ValueError):
                return protocol.error(protocol.E_BAD_REQUEST,
                                      f"timeout must be a number, got {timeout!r}")
            job.wait(timeout)
        return protocol.ok(job=job.snapshot())

    def _slice_rows(self) -> list[dict]:
        with self._lock:
            rows = []
            for sl in self.slices:
                cur = sl.current
                rows.append({"name": sl.name, "device": sl.device,
                             "devices": list(sl.spec.device_ids), "width": sl.spec.width,
                             "default": sl.spec.default, "degraded": sl.degraded,
                             "degrade_reason": sl.degrade_reason, "busy": cur is not None,
                             "current": cur.id if cur is not None else None,
                             "jobs_total": sl.jobs_total, "steals": sl.steals,
                             "oracle_jobs": sl.oracle_jobs,
                             "probing": sl.probing, "recoveries": sl.recoveries,
                             "recovered_at": sl.recovered_at,
                             "canary": sl.canary or sl.canary_job is not None,
                             "recover_backoff_s": sl.recover_backoff})
        return rows

    def _journal_stats(self) -> dict:
        try:
            journal_bytes = os.path.getsize(self.journal_path)
        except OSError:
            journal_bytes = 0
        with self._lock:
            return {"path": self.journal_path, "enabled": self._journal_enabled,
                    "bytes": journal_bytes, "compactions": self._journal_compactions,
                    "torn": self._journal_torn}

    def _op_stats(self) -> dict:
        from spgemm_tpu_torch.ops import delta, plancache, warmstore  # noqa: PLC0415

        try:
            armed = failpoints.armed()
        except ValueError as e:
            armed = {"error": str(e)}
        journal = self._journal_stats()
        slices = self._slice_rows()
        counters = ENGINE.counter_snapshot()
        with self._lock:
            degraded, degrade_reason = self.degraded, self.degrade_reason
            probe_outcome = self._probe_outcome
            terminal = dict(self._terminal_totals)
        return protocol.ok(
            daemon="spgemmd",
            uptime_s=round(time.time() - self._started_at, 3),
            device={"type": self.device, "name": self.device_name},
            degraded=degraded,
            degrade_reason=degrade_reason,
            backend_probe=probe_outcome,
            queue_cap=self._cap,
            job_timeout_s=self._job_timeout_s,
            jobs=self.queue.counts(),
            jobs_terminal=terminal,
            serve={name: counters.get(name, 0) for name in SERVE_COUNTERS},
            slices=slices,
            slices_degraded=sum(1 for s in slices if s["degraded"]),
            tenants=self.queue.tenants(),
            tenant_inflight_cap=self.queue.tenant_cap(),
            placement=placement.stats(),
            journal=journal,
            failpoints={"armed": armed, "triggered": failpoints.triggered()},
            trace=obs_trace.RECORDER.stats(),
            events=obs_events.LOG.stats(),
            profile=obs_profile.summary(),
            slo=obs_slo.SLO.report(),
            tune=tune_mod.TUNER.stats(),
            flight_dir=self.flight_dir,
            plan_cache=plancache.stats(),
            delta=delta.stats(),
            warm=warmstore.stats(),
            socket=self.socket_path,
        )

    def _op_metrics(self) -> dict:
        """The Prometheus text-format 0.0.4 scrape (obs/metrics.py): the
        engine's series (collect_engine), then the daemon's -- uptime,
        degrade, queue, connections, journal, the job-wall histogram, the
        batch-size histogram once an armed window has sampled, jobs by
        state and outcome, the slice's series, per-tenant queue depth, and
        the SLO engine's families."""
        samples = obs_metrics.collect_engine()
        with self._lock:
            degraded = self.degraded
            terminal = dict(self._terminal_totals)
            conns = self._conn_count
            wall = _hist_copy(self._job_wall)
            batch_hist = _hist_copy(self._batch_size)
        journal = self._journal_stats()
        counts = self.queue.counts()
        depth = counts.pop("depth")
        samples += [
            ("spgemmd_uptime_seconds", {}, round(time.time() - self._started_at, 3)),
            ("spgemmd_degraded", {}, int(degraded)),
            ("spgemmd_queue_depth", {}, depth),
            ("spgemmd_connections", {}, conns),
            ("spgemmd_journal_bytes", {}, journal["bytes"]),
            ("spgemmd_journal_compactions_total", {}, journal["compactions"]),
            ("spgemmd_journal_torn_total", {}, journal["torn"]),
            ("spgemmd_job_wall_seconds", {}, wall),
        ]
        # rendered only once an armed window sampled: a window-0 daemon's
        # scrape has no batch-size family at all
        if batch_hist["count"] > 0:
            samples.append(("spgemm_serve_batch_size", {}, batch_hist))
        samples += [("spgemmd_jobs", {"state": state}, n) for state, n in sorted(counts.items())]
        samples += [("spgemmd_jobs_terminal_total", {"outcome": outcome}, n)
                    for outcome, n in sorted(terminal.items())]
        for row in self._slice_rows():
            labels = {"slice": row["name"]}
            samples += [
                ("spgemm_slice_busy", labels, int(row["busy"])),
                ("spgemm_slice_degraded", labels, int(row["degraded"])),
                ("spgemm_slice_jobs_total", labels, row["jobs_total"]),
                ("spgemm_slice_steals_total", labels, row["steals"]),
                ("spgemm_slice_recoveries_total", labels, row["recoveries"]),
            ]
        # the SLO engine's tenant cap: the newest TENANT_RETAIN tenants keep
        # their own label, the rest add up in one `other` row
        tenant_rows = sorted(self.queue.tenants().items(),
                             key=lambda kv: kv[1].get("last_seen", 0.0), reverse=True)
        depths: dict[str, int] = {}
        for i, (tenant, row) in enumerate(tenant_rows):
            label = tenant if i < obs_slo.TENANT_RETAIN else "other"
            depths[label] = depths.get(label, 0) + row["queued"]
        samples += [("spgemmd_tenant_queue_depth", {"tenant": tenant}, n)
                    for tenant, n in sorted(depths.items())]
        samples += obs_slo.SLO.samples()
        # only once the tuner holds a class: a SPGEMM_TPU_TUNE=0 scrape, and
        # one of a daemon no job of a recorded structure reached, keep the
        # bytes they had before the tuner
        tstats = tune_mod.TUNER.stats()
        if tstats["classes"]:
            samples += [("spgemm_tune_overrides", {"state": state}, n)
                        for state, n in sorted(tstats["overrides"].items())]
            samples += [("spgemm_tune_win_ratio", {"class": row["class"]}, row["win"])
                        for row in tstats["classes"]
                        if row["state"] in ("canary", "live") and row["win"] is not None]
        return protocol.ok(content_type="text/plain; version=0.0.4; charset=utf-8",
                           text=obs_metrics.render(samples))

    def _op_trace(self) -> dict:
        """The flight recorder as trace_event JSON (what a flight dump holds)."""
        events = obs_trace.to_trace_events()
        return protocol.ok(spans=len(events), trace_events=events)

    def _op_events(self, msg: dict) -> dict:
        """The newest n records of the event ring (the JSONL file next to
        the journal holds the longer history) and the log's stats."""
        n = msg.get("n", 50)
        try:
            n = int(n)
        except (TypeError, ValueError):
            return protocol.error(protocol.E_BAD_REQUEST, f"n must be an integer, got {n!r}")
        return protocol.ok(events=obs_events.LOG.tail(n), log=obs_events.LOG.stats())

    def _op_profile(self) -> dict:
        """The profiling report (obs/profile.py): build records, the device
        memory watermark, estimator and delta accountability."""
        return protocol.ok(profile=obs_profile.report())

    def _op_slo(self) -> dict:
        """The SLO engine's report (obs/slo.py): objectives, per-tenant
        rolling quantiles, error ratio and queue-wait share, per-(tenant,
        slice) burn state."""
        return protocol.ok(slo=obs_slo.SLO.report())


def _observe_locked(hist: dict, value: float) -> None:
    """One sample into a {"buckets", "sum", "count"} histogram (cumulative
    buckets; the caller holds the lock that guards it)."""
    hist["sum"] += value
    hist["count"] += 1
    for le in hist["buckets"]:
        if value <= le:
            hist["buckets"][le] += 1


def _hist_copy(hist: dict) -> dict:
    return {"buckets": dict(hist["buckets"]), "sum": hist["sum"], "count": hist["count"]}


def _startup_probe() -> str:
    """The card's probe at start; an `error` is probed once more, as the
    CLI's --failover does (it may be transient)."""
    from spgemm_tpu_torch.utils import backend_probe  # noqa: PLC0415

    outcome = "error"
    for _ in range(2):
        outcome = backend_probe.probe_default_backend()
        if outcome != "error":
            break
    return outcome


def _load_engine() -> None:
    """Load before serving what each job would otherwise pay on its first
    call: the engine's modules and the native host library."""
    from spgemm_tpu_torch import chain  # noqa: F401, PLC0415 -- the engine's modules
    from spgemm_tpu_torch.utils import native  # noqa: PLC0415

    if native.enabled():
        native.lib()


def _load_kernels() -> None:
    """On a card the probe found working: every kernel library (built from
    csrc/ if it is not yet) and the CUDA context."""
    import torch  # noqa: PLC0415

    from spgemm_tpu_torch.ops import _build  # noqa: PLC0415

    for name in _build.build_all():
        _build.load(name)
    torch.cuda.init()


def main(argv: list[str] | None = None) -> int:
    """`serve`: run the daemon in the foreground.  Without --device cpu it
    needs a card: with none visible it exits 1 after one stderr line; with
    one that the probe finds dead it starts degraded, and says so."""
    p = argparse.ArgumentParser(
        prog="spgemm_tpu_torch serve",
        description="spgemmd: the resident chain-serving daemon (one process owns the "
                    "card; jobs reuse its warm plan cache, delta store and built kernels)",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="cross-job batching (off by default):\n"
               "  SPGEMM_TPU_SERVE_BATCH_WINDOW_S=S  > 0 arms it: a picked-up job waits up to S\n"
               "      seconds for queued jobs of the same chain structure, deadline,\n"
               "      backend and round_size, and they run as one batch (each round one\n"
               "      launch for all of them, each job's bytes its solo run's)\n"
               "  SPGEMM_TPU_SERVE_BATCH_K=K  jobs in a batch at most (default 8)\n"
               "  SPGEMM_TPU_DELTA=0  also needed: with delta recompute on (the default)\n"
               "      no batch forms\n"
               "A folder's first submit runs solo and records its structure; later\n"
               "submits of the same content may batch.")
    p.add_argument("--socket", default=None, metavar="PATH",
                   help="unix socket path (default: SPGEMM_TPU_SERVE_SOCKET or "
                        "<tmpdir>/spgemmd-<uid>.sock)")
    p.add_argument("--addr", default=None, metavar="ADDR",
                   help="TCP front-end, tcp:HOST:PORT (default: SPGEMM_TPU_SERVE_ADDR; "
                        "unset = the unix socket only)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where jobs run (default cuda; cpu runs the kernels' plain "
                        "versions)")
    p.add_argument("--slices", default=None, metavar="SPEC",
                   help="slice spec (SPGEMM_TPU_SERVE_SLICES): [COUNTx]WIDTH[*] terms "
                        "joined by '+', or auto; on cards it needs no more devices than "
                        "are visible (one H100: 1 or auto), on the CPU any spec runs")
    p.add_argument("--queue-cap", type=int, default=None,
                   help="override SPGEMM_TPU_SERVE_QUEUE_CAP")
    p.add_argument("--no-journal", action="store_true",
                   help="no on-disk job journal (queued jobs are lost on restart)")
    p.add_argument("--verbose", "-v", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        format="%(name)s %(message)s")
    import torch  # noqa: PLC0415 -- the daemon's process pays it once

    t0 = time.perf_counter()
    n_devices, device_name, dead = None, "cpu", None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("spgemmd: no CUDA device is visible; pass --device cpu to serve on the CPU",
                  file=sys.stderr)
            return 1
        n_devices = torch.cuda.device_count()
        try:  # a spec the cards cannot serve fails before the probe
            _pool(args.slices or knobs.get("SPGEMM_TPU_SERVE_SLICES"), n_devices, args.device)
        except mesh_mod.SliceSpecError as e:
            print(f"spgemmd: {e}", file=sys.stderr)
            return 1
        # the probe's subprocess runs while this process loads the engine
        with ThreadPoolExecutor(1) as pool:
            probe = pool.submit(_startup_probe)
            _load_engine()
            outcome = probe.result()
        if outcome == "ok":
            device_name = torch.cuda.get_device_name(0)
            _load_kernels()
        else:
            device_name = None
            dead = f"startup probe: card unusable (probe: {outcome})"
    else:
        _load_engine()
    log.info("probed and warmed up in %.3f s", time.perf_counter() - t0)
    try:
        daemon = Daemon(args.socket, queue_cap=args.queue_cap, journal=not args.no_journal,
                        slices=args.slices, n_devices=n_devices, device=args.device,
                        device_name=device_name, addr=args.addr)
    except ValueError as e:  # SliceSpecError included
        print(f"spgemmd: {e}", file=sys.stderr)
        return 1
    if dead is not None:
        # a card is visible but the probe finds it dead: a lost card, so the
        # daemon serves on the host oracle from the first job, and says so
        print(f"spgemmd: {dead}; serving on the host oracle (degraded)", file=sys.stderr,
              flush=True)
        ENGINE.incr("serve_degrades")
        daemon.degrade_at_start(dead, outcome)

    # the handler only sets the flag; serve_forever's finally runs the drain
    def _on_signal(signum, frame):  # noqa: ARG001 -- signal handler shape
        daemon._stop.set()

    for signum in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(signum, _on_signal)
        except (ValueError, OSError):
            pass
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        daemon.stop()
    except RuntimeError as e:
        print(f"spgemmd: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
