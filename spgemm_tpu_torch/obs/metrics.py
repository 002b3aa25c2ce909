"""Metrics registry and Prometheus text-format 0.0.4 renderer (the port's
copy of the JAX package's `obs/metrics.py`, with the profiling (obs/profile),
autotuner (tune/), SLO (obs/slo) and fleet router (fleet/router.py)
families).

The single source of truth for what the port may emit:

  * ENGINE_PHASES and ENGINE_COUNTERS: every name the port passes to
    `ENGINE.phase/record` and `ENGINE.incr` -- the port's own names, not
    the JAX package's (`upload`, `plan_exact`, `serve_load`, ... and the
    `launches_<kernel>` count each CUDA wrapper bumps where it launches).
    tests/test_torch_obs.py scans the package's source and fails on an
    undeclared literal.  Each phase is one `spgemm_phase_*` label value and
    one span name in the flight recorder;
  * the metric families: `render()` raises on an undeclared family or on a
    sample whose labels differ from the declaration.  A family the JAX
    package declares too keeps its HELP text verbatim, so both packages
    render the same text from the same samples -- the `spgemm_compile*`
    families too, although the port's records are library builds with no
    cost analysis (obs/profile.record_build).

Imports neither torch nor numpy: the client CLI and spgemmd's scrape path
read it.
"""

from __future__ import annotations

from dataclasses import dataclass

# Engine PHASE names (wall-seconds accumulators): the only names the port
# may pass to ENGINE.phase(...) / ENGINE.record(...).  Host time: a phase
# around an upload or a launch ends when the work is queued on the card.
ENGINE_PHASES: dict[str, str] = {
    "plan": "full symbolic plan (join, rounds, assembly permutation) of one "
            "multiply, on the plan-ahead worker or inline (ops/spgemm.plan)",
    "plan_wait": "how long dispatch blocked on the multiply's plan (chain.py)",
    "plan_exact": "an estimated plan's deferred exact join (SpgemmPlan.ensure_exact)",
    "join_fallback": "the exact join built inline on low estimator confidence",
    "upload": "a multiply's round indices and assembly permutation staged in "
              "pinned memory and queued to the card (ops/spgemm.execute)",
    "numeric_dispatch": "a multiply's kernel launches queued to the card",
    "dense_fold": "one dense-route round's segmented-fold launch "
                  "(SPGEMM_TPU_ACCUM_ROUTE)",
    "assembly": "result assembly gather on the card / out-of-core host landing",
    "stage_prep": "out-of-core staging: host gather and pack of one round",
    "dispatch": "out-of-core: one round's upload and launch",
    "delta_diff": "delta path: row digests, content diff and join reachability "
                  "(ops/delta)",
    "delta_splice": "delta path: recomputed rows spliced into a copy of the "
                    "retained previous result",
    "warm_load": "warm store: one on-disk plan or delta entry read (ops/warmstore)",
    "warm_flush": "warm store: persisting plans and delta entries, then the "
                  "budget prune (spgemmd terminal events, shutdown)",
    "serve_queue_wait": "spgemmd: submit to pickup (recorded into the job's "
                        "scope)",
    "serve_execute": "spgemmd: one pickup's executor span (a batch's members share "
                     "it)",
    "serve_load": "spgemmd: reading a job's text directory",
    "serve_price": "spgemmd: the placement price and chain structure book of a "
                   "job's content",
    "serve_chain": "spgemmd: a job's (or a batch's) chain reduction",
    "serve_write": "spgemmd: writing a job's result in the reference's text format",
    "ring_plan": "ring multiply: the rank-compacted schedule and its CSR lists "
                 "(parallel/ring.plan_ring, ring_cells)",
    "ring_hop": "ring multiply: one hop of every position's B slab, timed alone once "
                "per device list and slab shape, recorded on every call",
    "ring_fold": "ring multiply: the n steps' field-fold launches and hops queued",
    "tune_trial": "autotuner: one timed trial leg (one knob vector of the per-class "
                  "enumeration) run on an idle slice (tune/)",
    "tune_apply": "autotuner: activating a class's tuned override at job pickup, and "
                  "persisting a fresh winner into the warm store's tune tier",
}

# Engine event COUNTER names: the only names the port may pass to
# ENGINE.incr(...).  Each becomes one spgemm_engine_events_total label value.
ENGINE_COUNTERS: dict[str, str] = {
    "launches_numeric_round": "kernel 1 launches, mod (csrc/numeric_round.cu)",
    "launches_numeric_round_no_mod": "kernel 1 launches, no_mod",
    "launches_numeric_round_mxu": "kernel 2 launches (csrc/numeric_round_mxu.cu)",
    "launches_dense_fold": "segmented-fold launches (csrc/numeric_round_dense.cu)",
    "launches_splice": "delta splice launches (csrc/splice.cu)",
    "launches_bsmm": "kernel 3 launches (csrc/bsmm.cu)",
    "launches_bsmm_resident": "kernel 4 launches (csrc/bsmm.cu, resident weights)",
    "launches_bsmm_wgrad": "kernel 5 launches (csrc/bsmm_grad.cu, the FFN weight gradient)",
    "launches_field_fold": "field-mode fold launches (csrc/field_fold.cu, F1: inner sharding)",
    "launches_field_fold_scatter": "field-mode fold-and-scatter launches (csrc/field_fold.cu, "
                                   "F3: a ring step's list at one position)",
    "launches_field_add": "field-mode add launches (csrc/field_fold.cu, F2: the all-reduce)",
    "ring_steps": "ring multiply steps (n a multiply over n positions)",
    "route_dense": "rounds dispatched on the dense accumulator route",
    "rowshard_round": "shards of a round dispatched by the output-sharded multiply "
                      "(parallel/rowshard.py): one kernel-1 fold each",
    "plan_cache_hits": "structure-keyed plan cache hits",
    "plan_cache_misses": "structure-keyed plan cache misses",
    "plan_cache_evictions": "structure-keyed plan cache LRU evictions",
    "ooc_rounds": "out-of-core rounds staged",
    "ooc_upload_bytes": "out-of-core bytes uploaded",
    "delta_rows_recomputed": "output tile-rows re-folded by delta-enabled multiplies "
                             "(a full fallback counts every row)",
    "delta_rows_total": "output tile-rows seen by delta-enabled multiplies",
    "delta_full_fallbacks": "delta-enabled multiplies that took the full path",
    "est_hits": "estimator-routed plans (exact join deferred)",
    "est_fallbacks": "estimator fallbacks to the inline exact join",
    "est_route_mismatch": "estimated plans whose predicted accumulator route "
                          "differed from the exact plan's",
    "warm_hits": "warm store entries read and served",
    "warm_misses": "warm store lookups with no entry on disk",
    "warm_corrupt": "warm entries skipped as corrupt or version-skewed (counted "
                    "cold fallbacks)",
    "serve_reaps": "spgemmd watchdog reaps (deadline exceeded)",
    "serve_degrades": "spgemmd slice degrades (executor wedged or dead)",
    "serve_recoveries": "spgemmd slices reinstated after a live card probe",
    "serve_steals": "spgemmd pool work steals: jobs taken by an idle slice outside "
                    "their preferred slice class (every preferred slice was busy or "
                    "degraded)",
    "serve_batches": "spgemmd cross-job batches run (two or more jobs)",
    "serve_batched_jobs": "jobs that rode a cross-job batch",
    "compiles": "kernel and host library builds or reuses recorded at first load "
                "(obs/profile.record_build)",
    "tune_trials": "autotuner trial legs run on idle slices (one knob vector each; "
                   "preempted or overlay-skewed legs count too: they spent the idle "
                   "time even when the measurement was discarded)",
    "tune_reverts": "autotuner override reverts: a canary failure or a trial-time "
                    "parity mismatch dropped the class's tuned vector and backed off "
                    "its re-trial",
}


@dataclass(frozen=True)
class Metric:
    """One declared metric family.

    kind: 'counter' | 'gauge' | 'histogram'.  Histogram samples are fed
    as {"buckets": {le: cumulative_count}, "sum": s, "count": n}.
    labels: the exact label names every sample of the family must carry.
    module: the producing module (package-relative), for docs.
    """

    name: str
    kind: str
    doc: str
    module: str
    labels: tuple[str, ...] = ()


# in the JAX package's order; the HELP texts are its own
_METRICS = (
    Metric("spgemm_phase_seconds_total", "counter",
           "Wall seconds accumulated per engine phase (the ENGINE "
           "registry's totals; phase names are declared in "
           "obs/metrics.ENGINE_PHASES).",
           "utils/timers.py", labels=("phase",)),
    Metric("spgemm_phase_entries_total", "counter",
           "Times each engine phase was entered.",
           "utils/timers.py", labels=("phase",)),
    Metric("spgemm_engine_events_total", "counter",
           "Engine event counters (ENGINE.incr names, declared in "
           "obs/metrics.ENGINE_COUNTERS: dispatches, ring_steps, "
           "plan_cache_hits/misses, ...).",
           "utils/timers.py", labels=("event",)),
    Metric("spgemm_plan_cache_hits_total", "counter",
           "Structure-keyed plan cache hits since process start.",
           "ops/plancache.py"),
    Metric("spgemm_plan_cache_misses_total", "counter",
           "Structure-keyed plan cache misses since process start.",
           "ops/plancache.py"),
    Metric("spgemm_plan_cache_evictions_total", "counter",
           "Structure-keyed plan cache LRU evictions since process "
           "start.",
           "ops/plancache.py"),
    Metric("spgemm_plan_cache_entries", "gauge",
           "Plans currently retained in the LRU.",
           "ops/plancache.py"),
    Metric("spgemm_plan_cache_capacity", "gauge",
           "Configured plan-cache LRU capacity "
           "(SPGEMM_TPU_PLAN_CACHE_CAP).",
           "ops/plancache.py"),
    Metric("spgemm_warm_hits_total", "counter",
           "Warm-start store hits since process start (plan + delta "
           "entries served from disk).",
           "ops/warmstore.py"),
    Metric("spgemm_warm_misses_total", "counter",
           "Warm-start store misses since process start.",
           "ops/warmstore.py"),
    Metric("spgemm_warm_corrupt_total", "counter",
           "Warm entries skipped as corrupt/version-skewed/knob-vector-"
           "mismatched (counted cold fallbacks).",
           "ops/warmstore.py"),
    Metric("spgemm_warm_entries", "gauge",
           "Entries currently persisted in the warm dir, by kind "
           "(plan, delta).",
           "ops/warmstore.py", labels=("kind",)),
    Metric("spgemm_warm_bytes", "gauge",
           "On-disk bytes of warm plan/delta entries (the xla "
           "compilation-cache subdir is excluded).",
           "ops/warmstore.py"),
    Metric("spgemm_trace_spans", "gauge",
           "Spans currently retained in the flight-recorder ring.",
           "obs/trace.py"),
    Metric("spgemm_trace_spans_emitted_total", "counter",
           "Spans emitted into the flight recorder since process start.",
           "obs/trace.py"),
    Metric("spgemm_trace_spans_dropped_total", "counter",
           "Spans evicted from the ring (oldest-first past "
           "SPGEMM_TPU_OBS_RING_CAP).",
           "obs/trace.py"),
    Metric("spgemmd_uptime_seconds", "gauge",
           "Seconds since the serving daemon started.",
           "serve/daemon.py"),
    Metric("spgemmd_degraded", "gauge",
           "1 when the WHOLE pool is on the CPU failover path (every "
           "slice wedged/dead; with one slice, exactly the pre-pool "
           "daemon flag), else 0.  Per-slice degrade state is "
           "spgemm_slice_degraded.",
           "serve/daemon.py"),
    Metric("spgemm_slice_busy", "gauge",
           "1 while the slice's executor holds a job, else 0 -- the "
           "device-pool utilization signal, per slice.",
           "serve/daemon.py", labels=("slice",)),
    Metric("spgemm_slice_degraded", "gauge",
           "1 when this slice wedged/died and runs the CPU failover "
           "executor (excluded from placement while any healthy slice "
           "remains), else 0.",
           "serve/daemon.py", labels=("slice",)),
    Metric("spgemm_slice_jobs_total", "counter",
           "Jobs picked up by this slice's executor since daemon start "
           "(steals included).",
           "serve/daemon.py", labels=("slice",)),
    Metric("spgemm_slice_steals_total", "counter",
           "Jobs this slice STOLE (its class was not the job's preferred "
           "placement, but every preferred slice was busy/degraded).",
           "serve/daemon.py", labels=("slice",)),
    Metric("spgemm_slice_recoveries_total", "counter",
           "Times this degraded slice was reinstated into placement by "
           "the self-healing recovery loop (SPGEMM_TPU_SERVE_RECOVER_S "
           "re-probe came back live; the first job after each "
           "reinstatement runs under the canary gate).",
           "serve/daemon.py", labels=("slice",)),
    Metric("spgemmd_tenant_queue_depth", "gauge",
           "Jobs queued per fair-queuing tenant (tenants with no queued "
           "or in-flight jobs are retired from the series).  Label "
           "cardinality is bounded: the top-K tenants by recency keep "
           "their own label, the rest aggregate into one `other` row.",
           "serve/daemon.py", labels=("tenant",)),
    Metric("spgemmd_queue_depth", "gauge",
           "Jobs currently waiting in the admission FIFO.",
           "serve/daemon.py"),
    Metric("spgemmd_connections", "gauge",
           "Concurrent client connections held open.",
           "serve/daemon.py"),
    Metric("spgemmd_jobs", "gauge",
           "Jobs in the live index by state (terminal states bounded by "
           "JobQueue.RETAIN_TERMINAL).",
           "serve/daemon.py", labels=("state",)),
    Metric("spgemmd_jobs_terminal_total", "counter",
           "Daemon-lifetime terminal job outcomes: done, error (runner "
           "raised), timeout (watchdog reap -- a later wedge declaration "
           "does not re-count the job; alert on spgemmd_degraded / "
           "serve_degrades for wedges), abandoned (executor thread died "
           "mid-job), drained (reaped by a graceful shutdown past "
           "DRAIN_GRACE_S -- routine on rollouts, never an executor-"
           "death signal).",
           "serve/daemon.py", labels=("outcome",)),
    Metric("spgemmd_journal_bytes", "gauge",
           "On-disk size of the job journal next to the socket.",
           "serve/daemon.py"),
    Metric("spgemmd_journal_compactions_total", "counter",
           "Journal compactions since daemon start (startup replay "
           "included).",
           "serve/daemon.py"),
    Metric("spgemmd_journal_torn_total", "counter",
           "Journal tears detected during replay or compaction "
           "(CRC32/length frame mismatch -- the mid-write-kill "
           "signature): one count per truncation at the first bad "
           "record, never a crash.  Everything after the tear is "
           "unattributable and dropped with it, so this counts tears, "
           "not dropped records.",
           "serve/daemon.py"),
    # ---- fleet layer (fleet/router.py: the router's own scrape; each
    # backend's series ride the aggregated passthrough with an injected
    # backend= label, not this registry) ----
    Metric("spgemm_router_backend_up", "gauge",
           "1 while the backend answers its stats poll healthy "
           "(undegraded), 0 while it is down or degraded -- the "
           "fleet-level analogue of spgemm_slice_degraded (a down "
           "backend is excluded from placement the same way).",
           "fleet/router.py", labels=("backend",)),
    Metric("spgemm_router_backend_queue_depth", "gauge",
           "Queued jobs last reported by each backend's stats poll "
           "(the router's load signal for least-loaded placement).",
           "fleet/router.py", labels=("backend",)),
    Metric("spgemm_router_jobs_total", "counter",
           "Submits the router placed per backend (failover re-submits "
           "count on the backend that finally accepted).",
           "fleet/router.py", labels=("backend",)),
    Metric("spgemm_router_failovers_total", "counter",
           "Jobs re-submitted once to a healthy peer after their "
           "backend died mid-job (the idempotent-by-fingerprint "
           "failover; a job that cannot fail over gets a structured "
           "backend-lost error instead).",
           "fleet/router.py"),
    Metric("spgemm_failpoints_triggered_total", "counter",
           "Chaos failpoint triggers per registered injection point "
           "(utils/failpoints.py registry, armed via "
           "SPGEMM_TPU_FAILPOINTS; zero series when unarmed).",
           "utils/failpoints.py", labels=("point",)),
    Metric("spgemmd_job_wall_seconds", "histogram",
           "Per-job wall time start-to-terminal (reaped jobs included).",
           "serve/daemon.py"),
    Metric("spgemm_serve_batch_size", "histogram",
           "Jobs per executor pickup while the cross-job batching window "
           "was armed (SPGEMM_TPU_SERVE_BATCH_WINDOW_S > 0): size 1 = a "
           "batchable head found no mates inside the window, >= 2 = one "
           "fused dispatch served the whole batch.  No samples while the "
           "window is 0 (the pre-batch scrape, byte-identical).",
           "serve/daemon.py"),
    # ---- deep profiling layer (obs/profile.py, obs/events.py) ----
    Metric("spgemm_compiles_total", "counter",
           "Engine jit compiles recorded per site (obs/profile.ProfiledJit "
           "wraps the XLA numeric round, assembly gather, delta splice, "
           "ring/rowshard entrypoints) -- the cold-jit tax the "
           "persistent-warm-start roadmap item targets.",
           "obs/profile.py", labels=("site",)),
    Metric("spgemm_compile_seconds", "histogram",
           "Compile wall per recorded engine jit compile (lower + "
           "backend compile, per site).",
           "obs/profile.py", labels=("site",)),
    Metric("spgemm_compile_flops_total", "counter",
           "Cumulative XLA cost_analysis FLOPs of the executables "
           "compiled per site.",
           "obs/profile.py", labels=("site",)),
    Metric("spgemm_compile_bytes_total", "counter",
           "Cumulative XLA cost_analysis bytes-accessed of the "
           "executables compiled per site.",
           "obs/profile.py", labels=("site",)),
    Metric("spgemm_compile_temp_bytes", "gauge",
           "Largest memory_analysis temp-buffer footprint among the "
           "executables compiled per site.",
           "obs/profile.py", labels=("site",)),
    Metric("spgemm_phase_seconds", "histogram",
           "Per-entry engine phase latency distribution, fed from "
           "completed flight-recorder spans (phase names declared in "
           "obs/metrics.ENGINE_PHASES) -- scrape-side phase latency "
           "without a trace dump.",
           "obs/profile.py", labels=("phase",)),
    Metric("spgemm_est_rel_error", "histogram",
           "Sampled-estimator relative error, scored when the deferred "
           "exact join lands (SpgemmPlan.ensure_exact): |predicted - "
           "exact| / exact per quantity (keys, pairs, fanout).  A "
           "drifting estimator is an alert here, not a silent mis-plan.",
           "obs/profile.py", labels=("quantity",)),
    Metric("spgemm_delta_dirty_fraction", "histogram",
           "Predicted-dirty fraction per delta-enabled multiply "
           "(dirty output rows / total rows; a counted full fallback "
           "observes 1.0) -- the per-multiply distribution behind the "
           "aggregate delta_rows_* counters: how incremental the "
           "submit stream actually is.",
           "obs/profile.py"),
    Metric("spgemm_delta_mispredictions_total", "counter",
           "Delta multiplies whose executed row count diverged from "
           "the predicted dirty set (the engine executes exactly what "
           "it predicts, so any nonzero here is an engine bug -- "
           "alert, don't graph).",
           "obs/profile.py"),
    Metric("spgemm_hbm_bytes_in_use", "gauge",
           "Device bytes in use at the newest engine memory_stats() "
           "sample (dispatch/assembly boundaries; omitted on backends "
           "without the API, e.g. CPU).",
           "obs/profile.py"),
    Metric("spgemm_hbm_peak_bytes", "gauge",
           "Peak device bytes in use over all engine memory_stats() "
           "samples since process start -- the observable form of "
           "SPGEMM_TPU_DELTA_RETAIN's entries-not-bytes retention bound.",
           "obs/profile.py"),
    Metric("spgemm_hbm_samples_total", "counter",
           "Engine memory_stats() samples recorded (0 and omitted "
           "gauges = backend never reported).",
           "obs/profile.py"),
    Metric("spgemm_events_emitted_total", "counter",
           "Structured events emitted into the event log "
           "(obs/events.py: job lifecycle, watchdog transitions, "
           "est/delta fallbacks, compile records).",
           "obs/events.py"),
    Metric("spgemm_events_dropped_total", "counter",
           "Events evicted from the bounded in-process event ring.",
           "obs/events.py"),
    Metric("spgemm_events_rotations_total", "counter",
           "On-disk event-log rotations (file grew past "
           "SPGEMM_TPU_OBS_EVENTS_MAX_KB and rolled to <path>.1).",
           "obs/events.py"),
    Metric("spgemm_events_bytes", "gauge",
           "Current on-disk size of the active event-log file (0 when "
           "no file sink is configured).",
           "obs/events.py"),
    # ---- autotuner (tune/) ----
    Metric("spgemm_tune_overrides", "gauge",
           "Structure classes currently holding a tuned knob override, "
           "by rollout state (canary = first post-promotion job still "
           "pending under the tightened deadline, live = canary passed, "
           "reverted = canary failed or parity mismatched -- held in "
           "backoff before re-trial).  No series while the tuner holds "
           "no class state (the SPGEMM_TPU_TUNE=0 scrape is "
           "byte-identical to the pre-tuner daemon).",
           "serve/daemon.py", labels=("state",)),
    Metric("spgemm_tune_win_ratio", "gauge",
           "Measured speedup (incumbent wall / winner wall) of each "
           "class's tuned override, labeled by the structure class key; "
           "only promoted overrides render (>= SPGEMM_TPU_TUNE_MIN_WIN "
           "by construction).",
           "serve/daemon.py", labels=("class",)),
    # ---- SLO engine (obs/slo.py) ----
    Metric("spgemm_slo_latency_seconds", "gauge",
           "Rolling-window per-tenant job latency quantile (p50/p95/p99 "
           "from the SLO engine's fixed-bucket digest, merged over the "
           "tenant's slices; window = SPGEMM_TPU_SLO_WINDOW_S).  Tenant "
           "label cardinality is bounded at the source (top-K by "
           "recency, evictions counted).",
           "obs/slo.py", labels=("tenant", "quantile")),
    Metric("spgemm_slo_error_ratio", "gauge",
           "Rolling-window per-tenant error ratio (failed jobs / total "
           "jobs in the SLO window).",
           "obs/slo.py", labels=("tenant",)),
    Metric("spgemm_slo_queue_wait_share", "gauge",
           "Rolling-window per-tenant queue-wait share: queued seconds "
           "/ (queued + execute) seconds -- whether a slow tenant is "
           "waiting on the pool or on its own jobs.",
           "obs/slo.py", labels=("tenant",)),
    Metric("spgemm_slo_burn_active", "gauge",
           "1 while the (tenant, slice) window is burning its error "
           "budget in BOTH burn windows (fast = window/12, slow = full "
           "window; objectives from SPGEMM_TPU_SLO_TARGET_S / "
           "SPGEMM_TPU_SLO_ERROR_PCT) -- the transition emitted a "
           "structured slo_burn event whose trace_id resolves via "
           "`cli trace-dump --merge` to the newest bad job's stitched "
           "trace; 0 (or the series absent) otherwise.",
           "obs/slo.py", labels=("slice", "tenant")),
    Metric("spgemm_slo_tenants_evicted_total", "counter",
           "Tenants evicted from the SLO engine's top-K-by-recency "
           "window set (their rolling windows dropped) -- the "
           "cardinality bound that keeps a tenant-id-per-request "
           "client from growing the engine or the scrape without "
           "bound.",
           "obs/slo.py"),
)

REGISTRY: dict[str, Metric] = {m.name: m for m in _METRICS}

# spgemmd_job_wall_seconds bucket upper bounds (seconds); +Inf implicit
JOB_WALL_BUCKETS = (0.1, 1.0, 10.0, 60.0, 600.0, 3600.0)

# spgemm_serve_batch_size bucket upper bounds (jobs per armed-window
# pickup); +Inf implicit
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16)


# ---------------------------------------------------------- text format --
def escape_help(text: str) -> str:
    """Prometheus 0.0.4 HELP escaping: backslash and newline."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label(value: str) -> str:
    """Prometheus 0.0.4 label-value escaping: backslash, quote, newline."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return f"{float(v):.10g}"


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render(samples: list[tuple]) -> str:
    """Prometheus text-format 0.0.4 for `samples`: (family, labels, value)
    tuples, histogram values as {"buckets", "sum", "count"} dicts.

    Families render in REGISTRY order with one HELP/TYPE header each; an
    undeclared family name raises ValueError (declaring is the price of
    emitting -- the same contract as the knob registry), as does a sample
    whose label names differ from the declaration."""
    by_family: dict[str, list[tuple[dict, object]]] = {}
    for family, labels, value in samples:
        m = REGISTRY.get(family)
        if m is None:
            raise ValueError(
                f"undeclared metric {family!r}: register it in "
                "spgemm_tpu_torch/obs/metrics.py (no ad-hoc series names)")
        if tuple(sorted(labels)) != tuple(sorted(m.labels)):
            raise ValueError(
                f"metric {family!r} declares labels {m.labels}, sample "
                f"carries {tuple(sorted(labels))}")
        by_family.setdefault(family, []).append((dict(labels), value))
    lines: list[str] = []
    for m in _METRICS:
        rows = by_family.get(m.name)
        if rows is None:
            continue
        lines.append(f"# HELP {m.name} {escape_help(m.doc)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for labels, value in sorted(rows,
                                    key=lambda r: sorted(r[0].items())):
            if m.kind == "histogram":
                buckets = value["buckets"]
                for le in sorted(buckets):
                    lab = _fmt_labels({**labels, "le": f"{le:g}"})
                    lines.append(f"{m.name}_bucket{lab} "
                                 f"{_fmt_value(buckets[le])}")
                inf_lab = _fmt_labels({**labels, "le": "+Inf"})
                lines.append(f"{m.name}_bucket{inf_lab} "
                             f"{_fmt_value(value['count'])}")
                lines.append(f"{m.name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(value['sum'])}")
                lines.append(f"{m.name}_count{_fmt_labels(labels)} "
                             f"{_fmt_value(value['count'])}")
            else:
                lines.append(f"{m.name}{_fmt_labels(labels)} "
                             f"{_fmt_value(value)}")
    return "\n".join(lines) + "\n"


# ----------------------------------------------------- engine collection --
def collect_engine() -> list[tuple]:
    """Samples for the process-wide engine state: ENGINE phase totals and
    counters, plan-cache and warm-store stats, flight-recorder ring health,
    failpoint triggers, then the profiling accounts and event-log health
    (_collect_profile).  The daemon adds its serving and SLO series.
    Imports neither torch nor numpy."""
    from spgemm_tpu_torch.obs import trace  # noqa: PLC0415
    from spgemm_tpu_torch.ops import plancache, warmstore  # noqa: PLC0415
    from spgemm_tpu_torch.utils import failpoints, knobs  # noqa: PLC0415
    from spgemm_tpu_torch.utils.timers import ENGINE  # noqa: PLC0415

    samples: list[tuple] = []
    totals = ENGINE.snapshot()
    counts = ENGINE.count_snapshot()
    for name in sorted(totals):
        samples.append(("spgemm_phase_seconds_total", {"phase": name}, totals[name]))
        samples.append(("spgemm_phase_entries_total", {"phase": name}, counts.get(name, 0)))
    for name, n in sorted(ENGINE.counter_snapshot().items()):
        samples.append(("spgemm_engine_events_total", {"event": name}, n))
    cache = plancache.stats()
    samples += [
        ("spgemm_plan_cache_hits_total", {}, cache["hits"]),
        ("spgemm_plan_cache_misses_total", {}, cache["misses"]),
        ("spgemm_plan_cache_evictions_total", {}, cache["evictions"]),
        ("spgemm_plan_cache_entries", {}, cache["entries"]),
    ]
    try:
        samples.append(("spgemm_plan_cache_capacity", {},
                        knobs.get("SPGEMM_TPU_PLAN_CACHE_CAP")))
    except ValueError:
        pass  # an invalid cap knob: skip the row, keep the scrape
    try:
        warm = warmstore.stats()
    except ValueError:
        warm = None  # an invalid warm knob: skip the rows, keep the scrape
    if warm is not None:
        samples += [
            ("spgemm_warm_hits_total", {}, warm["plan_hits"] + warm["delta_hits"]),
            ("spgemm_warm_misses_total", {}, warm["plan_misses"] + warm["delta_misses"]),
            ("spgemm_warm_corrupt_total", {}, warm["corrupt"]),
            ("spgemm_warm_entries", {"kind": "plan"}, warm["plans"]),
            ("spgemm_warm_entries", {"kind": "delta"}, warm["deltas"]),
            ("spgemm_warm_bytes", {}, warm["bytes"]),
        ]
        # only once an override persisted: a scrape without one keeps the
        # bytes it had before the tuner
        if warm["tunes"]:
            samples.append(("spgemm_warm_entries", {"kind": "tune"}, warm["tunes"]))
    ring = trace.RECORDER.stats()
    samples += [
        ("spgemm_trace_spans", {}, ring["spans"]),
        ("spgemm_trace_spans_emitted_total", {}, ring["emitted"]),
        ("spgemm_trace_spans_dropped_total", {}, ring["dropped"]),
    ]
    samples += [("spgemm_failpoints_triggered_total", {"point": point}, n)
                for point, n in sorted(failpoints.triggered().items())]
    samples += _collect_profile()
    return samples


def _collect_profile() -> list[tuple]:
    """The profiling accounts (obs/profile.py) and event-log health: builds
    per site, phase latency histograms, prediction accountability, the
    device memory watermark (omitted when the device never reported, as on
    the CPU), the event counters.  The JAX package's _collect_profile."""
    from spgemm_tpu_torch.obs import events, profile  # noqa: PLC0415

    samples: list[tuple] = []
    for site, agg in profile.compile_stats().items():
        labels = {"site": site}
        samples += [
            ("spgemm_compiles_total", labels, agg["count"]),
            ("spgemm_compile_seconds", labels, agg["seconds"]),
            ("spgemm_compile_flops_total", labels, agg["flops_total"]),
            ("spgemm_compile_bytes_total", labels, agg["bytes_total"]),
            ("spgemm_compile_temp_bytes", labels, agg["temp_bytes_max"]),
        ]
    for phase, hist in profile.phase_stats().items():
        samples.append(("spgemm_phase_seconds", {"phase": phase}, hist))
    est = profile.est_stats()
    for quantity, hist in est["rel_error"].items():
        samples.append(("spgemm_est_rel_error", {"quantity": quantity}, hist))
    # always rendered (a zero-count histogram, a zero counter), so an alert
    # rule never has to tell "absent" from "zero"
    dlt = profile.delta_stats()
    samples.append(("spgemm_delta_dirty_fraction", {}, dlt["dirty_fraction"]))
    samples.append(("spgemm_delta_mispredictions_total", {}, dlt["mispredictions"]))
    mem = profile.memory_stats()
    samples.append(("spgemm_hbm_samples_total", {}, mem["samples"]))
    if mem["available"]:
        samples += [
            ("spgemm_hbm_bytes_in_use", {}, mem["bytes_in_use"]),
            ("spgemm_hbm_peak_bytes", {}, mem["peak_bytes"]),
        ]
    ev = events.LOG.stats()
    samples += [
        ("spgemm_events_emitted_total", {}, ev["emitted"]),
        ("spgemm_events_dropped_total", {}, ev["dropped"]),
        ("spgemm_events_rotations_total", {}, ev["rotations"]),
        ("spgemm_events_bytes", {}, ev["bytes"]),
    ]
    return samples


# -------------------------------------------------------- generated docs --
def metrics_table_md() -> str:
    """The metrics table as markdown (families, then the declared ENGINE
    phase and counter names)."""
    lines = [
        "| metric | type | labels | produced in | what it measures |",
        "|---|---|---|---|---|",
    ]

    def md(cell: str) -> str:
        return cell.replace("|", "\\|")

    for m in _METRICS:
        labels = ", ".join(f"`{label}`" for label in m.labels) or "—"
        lines.append(f"| `{m.name}` | {m.kind} | {labels} | `{m.module}` "
                     f"| {md(m.doc)} |")
    lines.append("")
    lines.append("Declared `phase` label values (ENGINE phase names): "
                 + ", ".join(f"`{n}`" for n in ENGINE_PHASES) + ".")
    lines.append("")
    lines.append("Declared `event` label values (ENGINE counter names): "
                 + ", ".join(f"`{n}`" for n in ENGINE_COUNTERS) + ".")
    return "\n".join(lines)
