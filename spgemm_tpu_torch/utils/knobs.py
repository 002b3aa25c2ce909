"""Registry of the `SPGEMM_TPU_*` environment knobs the port reads (the
port's copy of the JAX package's `utils/knobs.py`, cut to those knobs).

Each knob keeps the JAX package's name, kind and parsing: an empty or unset
value means the default (None where the knob has none, False for a flag),
surrounding whitespace is stripped, and an invalid value raises ValueError
naming the knob.  Reads are lazy: the environment is consulted at each
`get()`, so tests may set a value mid-process.

Resolution is env > tuned > default: the autotuner (tune/) activates a
structure class's winning vector by replacing the process-wide tuned
overlay (`set_tuned`), and an exported value always beats a tuned one.
`base_get` ignores the overlay.  The port has no jit-static knobs; the knobs
its tuner searches carry `tuned=True`, and `base_tuned_vector()` (their env >
default values) is what the warm store's tune tier validates against.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class Knob:
    """One registered knob.

    kind: 'enum' | 'int' | 'float' | 'bool01' | 'flag' | 'path' | 'str'; a
      flag is true when set to a non-empty string, a bool01 is 0 or 1, a path
      or a str is the value as given (its consumer parses a str).
    default: the default in string form, or None: get() then returns None
      (False for a flag) and the consuming module owns the fallback.
    minimum: inclusive lower bound of an int or a float.
    doc: what the knob does, and the module that reads it.
    tuned: the autotuner's trial legs search it (tune/tuner.trial_vectors).
    """

    name: str
    kind: str
    doc: str
    default: str | None = None
    choices: tuple[str, ...] | None = None
    minimum: float | None = None
    tuned: bool = False


_KNOBS = (
    Knob("SPGEMM_TPU_PLAN_AHEAD", "int",
         "Chain plan-ahead depth: up to N upcoming pairs of a pass are planned "
         "by a host worker thread while the main thread dispatches the current "
         "pair; 0 = inline planning (bit-identical either way).  Read by chain.py.",
         default="2", minimum=0, tuned=True),
    Knob("SPGEMM_TPU_OOC_DEPTH", "int",
         "Out-of-core pipeline depth: 1 = synchronous, each round landed before "
         "the next is staged; >= 2 = staging, device and landing stages overlap "
         "with at most N rounds on the card.  Read by ops/spgemm.py.",
         default="2", minimum=1),
    Knob("SPGEMM_TPU_PLAN_CACHE", "bool01",
         "Structure-keyed plan memoization: 1 = a multiply whose operand "
         "structures and plan parameters were planned before reuses that plan, "
         "0 = plan every multiply (bit-identical either way).  Read by "
         "ops/plancache.py.",
         default="1"),
    Knob("SPGEMM_TPU_PLAN_CACHE_CAP", "int",
         "Plan-cache LRU capacity in plans (a plan holds its padded pair index "
         "arrays, about 8 bytes per tile pair).  Read by ops/plancache.py.",
         default="32", minimum=1),
    Knob("SPGEMM_TPU_DELTA", "bool01",
         "Delta recompute: 1 = a multiply whose structure was multiplied before "
         "diffs per-tile-row content digests (or the producer's dirty tag) "
         "against the previous submit, re-folds only the output tile-rows the "
         "changed input rows reach and splices them into the retained previous "
         "result; 0 = always the full multiply (bit-identical either way).  The "
         "run-once CLI pins it to 0 unless exported.  Read by ops/delta.py.",
         default="1"),
    Knob("SPGEMM_TPU_DELTA_RETAIN", "int",
         "Delta store capacity in entries (LRU, one per multiply structure); "
         "each holds its previous result on the card.  Read by ops/delta.py.",
         default="16", minimum=1),
    Knob("SPGEMM_TPU_PLAN_ESTIMATE", "bool01",
         "Sampled structure estimator on a plan-cache miss: 1 = a confident "
         "estimate returns the plan at once with the exact join deferred to "
         "SpgemmPlan.ensure_exact (the chain's plan-ahead worker, or execute); "
         "0 = the exact join inline (bit-identical either way).  Default 0, "
         "unlike the JAX package's 1: no consumer in the port overlaps the "
         "deferred join with device work yet.  Read by ops/estimate.py.",
         default="0"),
    Knob("SPGEMM_TPU_EST_SAMPLE_ROWS", "int",
         "Estimator row-sample budget: distinct A tile-rows sampled, evenly "
         "spaced; structures with this many rows or fewer skip estimation.  "
         "Read by ops/estimate.py.",
         default="48", minimum=1),
    Knob("SPGEMM_TPU_EST_CONFIDENCE", "float",
         "Estimator confidence threshold: an estimate below it takes the exact "
         "join inline (est_fallbacks); above 1 forces that everywhere.  Read by "
         "ops/estimate.py.",
         default="0.5", minimum=0),
    Knob("SPGEMM_TPU_WARM", "bool01",
         "Persistent warm store: 1 = exact plans and the delta store's retained "
         "results are written to SPGEMM_TPU_WARM_DIR and read back lazily by a "
         "later process; 0 = no persistence (bit-identical either way).  Read "
         "by ops/warmstore.py.",
         default="1"),
    Knob("SPGEMM_TPU_WARM_DIR", "path",
         "Warm store directory (unset: no persistence).  One live process owns "
         "it (a flock); another runs cold.  Read by ops/warmstore.py."),
    Knob("SPGEMM_TPU_WARM_MAX_MB", "int",
         "Warm store budget in MiB: after each flush the oldest entries are "
         "pruned until the store fits.  Read by ops/warmstore.py.",
         default="256", minimum=1),
    Knob("SPGEMM_TPU_PROBE_TIMEOUT", "float",
         "Seconds the CUDA liveness probe's subprocess may take (a card that "
         "hangs never raises).  Read by utils/backend_probe.py.",
         default="150", minimum=0),
    Knob("SPGEMM_TPU_NO_NATIVE", "flag",
         "Use the numpy text reader/writer and join instead of the native host "
         "library (never build or load it).  Read by utils/native.py."),
    Knob("SPGEMM_TPU_HYBRID_GATE", "enum",
         "Hybrid speed-gate policy: auto = measured per-shape crossover, proof "
         "= route on the exactness proof alone (unset: auto on CUDA, proof on "
         "the CPU).  Read by ops/crossover.py.",
         choices=("auto", "proof")),
    Knob("SPGEMM_TPU_ACCUM_ROUTE", "enum",
         "Accumulator route of the exact fold: ladder = every key's pair list "
         "padded to its fanout class, folded by kernel 1; dense = each class "
         "chunk as one contiguous pair stream plus a row per slot, folded by "
         "the segmented-fold kernel; auto = classes of fanout >= "
         "DENSE_MIN_CLASS carry both layouts and the gate (ops/crossover."
         "dense_wins) picks per round.  Bit-identical on every input.  The mxu "
         "backend and out-of-core always plan ladder.  Read by ops/symbolic.py "
         "and ops/spgemm.py.",
         default="auto", choices=("auto", "ladder", "dense"), tuned=True),
    Knob("SPGEMM_TPU_RING_OVERLAP", "bool01",
         "Double-buffered ring rotation: 1 = the copy of slab t+1 to the next "
         "position is issued before the fold over slab t, 0 = serialized "
         "fold-then-copy; bit-identical (the fold order never changes).  Read by "
         "parallel/ring.py.",
         default="1"),
    Knob("SPGEMM_TPU_RING_HOP_PROBE", "bool01",
         "One-hop copy probe before the ring fold, timed once per device list, "
         "route and slab shape and recorded as ENGINE ring_hop; 0 skips the "
         "probe when the phase registry is not consumed.  Read by "
         "parallel/ring.py.",
         default="1"),
    Knob("SPGEMM_TPU_DCN_CHUNK_MB", "float",
         "Multi-process partial-exchange chunk budget (MiB per rank): bounds the "
         "transient exchange buffer at P x chunk; 0 = one padded round as wide as "
         "the largest partial, behind a loud warning.  Every rank must set the "
         "same value.  "
         "Read by parallel/multihost.py.",
         default="64", minimum=0),
    Knob("SPGEMM_TPU_DCN_HEARTBEAT_S", "int",
         "Multi-process partner-loss window, seconds: a rank waiting at the "
         "partial exchange fails the run once a missing partner's heartbeat "
         "(a counter on the rendezvous store) stands still this long, however "
         "long a beating partner's sub-chain runs; it is also the gloo group's "
         "timeout, so it bounds joining the group and, once every rank is at "
         "the exchange, each collective's wait (a partner killed there is seen "
         "at once).  Unset: 100 s, jax's default window, not gloo's 30 "
         "minutes.  Read by parallel/multihost.py.",
         minimum=1),
    Knob("SPGEMM_TPU_CROSSOVER_CACHE", "path",
         "Crossover-measurement cache directory (unset: "
         "~/.cache/spgemm_tpu_torch).  Read by ops/crossover.py."),
    Knob("SPGEMM_TPU_SERVE_SOCKET", "path",
         "spgemmd unix-domain socket path (unset: <tmpdir>/spgemmd-<uid>.sock); "
         "the job journal lives next to it at <socket>.journal.  Read by "
         "serve/protocol.py."),
    Knob("SPGEMM_TPU_SERVE_ADDR", "str",
         "spgemmd TCP front-end address, tcp:HOST:PORT (port 0 binds an "
         "ephemeral port): the daemon listens there beside the unix socket with "
         "the same protocol, and clients that inherit the export dial it by "
         "default.  Unset = unix socket only.  A malformed spec fails startup.  "
         "Read by serve/protocol.py and serve/daemon.py."),
    Knob("SPGEMM_TPU_ROUTER_BACKENDS", "str",
         "spgemm-router backend list: comma-joined wire addresses (tcp:HOST:PORT or "
         "unix socket paths) of the spgemmd daemons the fleet router fronts "
         "(`cli route --backends` overrides).  Each is polled for health, queue "
         "depth and its price-book gossip; a dead or degraded backend leaves "
         "placement.  Empty with no --backends fails router startup.  Read by "
         "fleet/router.py."),
    Knob("SPGEMM_TPU_ROUTER_POLL_S", "float",
         "spgemm-router poll cadence, seconds: each cycle reads every backend's "
         "stats op (queue depth, slices, degraded flag, price-book sample) off "
         "the request path; a backend that fails its poll is down until a later "
         "poll answers.  Read by fleet/router.py.",
         default="2", minimum=0.1),
    Knob("SPGEMM_TPU_SERVE_SLICES", "str",
         "spgemmd device-pool slice spec (parallel/mesh.slice_pool): terms "
         "[COUNTx]WIDTH[*] joined by '+', or 'auto'.  One executor per slice; a "
         "slice wider than one device runs the output-sharded multiply "
         "(parallel/rowshard.py).  On cards a spec needing more devices than are "
         "visible fails daemon startup (one card: '1' or 'auto'); on the CPU "
         "every slice position is the CPU.  Read by serve/daemon.py.",
         default="1"),
    Knob("SPGEMM_TPU_SERVE_TENANT_INFLIGHT", "int",
         "spgemmd per-tenant in-flight cap (queued + running jobs per tenant): a "
         "submit past it is rejected with a structured tenant-cap error.  Unset = "
         "no per-tenant cap; SPGEMM_TPU_SERVE_QUEUE_CAP applies on top.  Read by "
         "serve/queue.py.",
         minimum=1),
    Knob("SPGEMM_TPU_SERVE_QUEUE_CAP", "int",
         "spgemmd admission cap: a submit arriving with this many jobs already "
         "queued is rejected with a structured queue-full error.  Read by "
         "serve/daemon.py.",
         default="64", minimum=1),
    Knob("SPGEMM_TPU_SERVE_BATCH_K", "int",
         "spgemmd cross-job batch width: with the batching window armed "
         "(SPGEMM_TPU_SERVE_BATCH_WINDOW_S > 0) an executor that picks up a job "
         "drains up to this many jobs in all that share its recorded chain "
         "structure, deadline, backend and round_size, and runs them as one batch: "
         "each multiply planned once and each round one launch over the jobs' "
         "stacked indices (ops/spgemm.execute_batched), every job's bytes its "
         "solo run's.  1 = no batching.  Read by serve/daemon.py.",
         default="8", minimum=1),
    Knob("SPGEMM_TPU_SERVE_BATCH_WINDOW_S", "float",
         "spgemmd cross-job batching window, seconds: after picking up a job "
         "that may batch, the executor waits up to this long for batch mates "
         "(tenant fairness and the tenant caps decide the members first; jobs "
         "already queued join at once).  Batching also needs SPGEMM_TPU_DELTA=0, "
         "since delta's retained results would splice across jobs.  0 = no "
         "batching, the executor of one job at a time.  Read by serve/daemon.py.",
         default="0", minimum=0),
    Knob("SPGEMM_TPU_SERVE_JOB_TIMEOUT", "float",
         "spgemmd per-job deadline, seconds: a job running past it is reaped with "
         "a structured job-timeout error, and an executor still stuck on it after "
         "SPGEMM_TPU_SERVE_WEDGE_GRACE_S counts as wedged (the slice degrades); "
         "0 = no deadline.  Read by serve/daemon.py.",
         default="0", minimum=0),
    Knob("SPGEMM_TPU_SERVE_RECOVER_S", "float",
         "spgemmd re-probe cadence, seconds: a degraded slice is probed again "
         "(utils/backend_probe, off-thread) this long after degrading, with "
         "exponential backoff after failed attempts; a live probe reinstates the "
         "slice behind a canary job with a tightened deadline.  0 = never "
         "re-probe.  Read by serve/daemon.py.",
         default="0", minimum=0),
    Knob("SPGEMM_TPU_SERVE_WEDGE_GRACE_S", "float",
         "spgemmd slow-vs-wedged window, seconds: after a reap the watchdog waits "
         "this long for the job's next heartbeat (one per finished multiply) "
         "before it declares the executor wedged and degrades the slice.  Must "
         "exceed the longest single multiply.  Read by serve/daemon.py.",
         default="60", minimum=0),
    Knob("SPGEMM_TPU_OBS_TRACE", "bool01",
         "Span flight recorder: 1 = every ENGINE phase enter and exit emits a span "
         "into the bounded in-process ring, 0 = no spans (the timers still "
         "accumulate; the whole-engine A/B pair for the recorder's cost).  Read by "
         "obs/trace.py.",
         default="1"),
    Knob("SPGEMM_TPU_OBS_RING_CAP", "int",
         "Flight-recorder capacity in spans: the ring keeps the newest N and "
         "evicts (and counts) the oldest.  Read by obs/trace.py.",
         default="4096", minimum=1),
    Knob("SPGEMM_TPU_OBS_EVENTS", "bool01",
         "Structured event log: 1 = engine and daemon events (job lifecycle, "
         "watchdog reap, wedge and degrade, estimator and delta fallbacks with "
         "their reasons) go into a bounded in-process ring and, under spgemmd, "
         "into <socket>.events.jsonl; 0 = no events anywhere.  Read by "
         "obs/events.py.",
         default="1"),
    Knob("SPGEMM_TPU_OBS_EVENTS_MAX_KB", "int",
         "Event-log rotation threshold in KiB: past it the JSONL file rotates to "
         "<path>.1 (one generation: at most about twice this on disk).  Read by "
         "obs/events.py.",
         default="256", minimum=1),
    Knob("SPGEMM_TPU_SLO_TARGET_S", "float",
         "Per-job latency objective, seconds (obs/slo.py SLO engine): a terminal "
         "job slower than this (or failed) is a bad event against the tenant's "
         "error budget, and multi-window burn-rate evaluation runs over every "
         "rolling (tenant, slice) window -- a window whose bad fraction exceeds "
         "the SPGEMM_TPU_SLO_ERROR_PCT budget in both the fast (window/12) and "
         "slow (full window) views emits a slo_burn event carrying the newest "
         "bad job's trace context and flips spgemm_slo_burn_active{tenant=,"
         "slice=}.  Unset = accounting-only: the latency quantile, error-ratio "
         "and queue-wait-share series still render, burn evaluation never runs.  "
         "Read by obs/slo.py.",
         minimum=0),
    Knob("SPGEMM_TPU_SLO_ERROR_PCT", "float",
         "SLO error budget, percent of jobs the rolling window may spend as bad "
         "events (failed, or slower than SPGEMM_TPU_SLO_TARGET_S) before the "
         "window counts as burning: burn rate = bad fraction / (this/100), "
         "breach at >= 1 in both burn windows.  Only consulted while "
         "SPGEMM_TPU_SLO_TARGET_S is set.  Read by obs/slo.py.",
         default="1", minimum=0),
    Knob("SPGEMM_TPU_SLO_WINDOW_S", "float",
         "SLO rolling-window length, seconds: per-(tenant, slice) job records "
         "older than this age out of the quantile, error and burn accounting "
         "(the fast burn window is 1/12 of it).  Window memory stays bounded "
         "regardless (RECORD_RETAIN records per window, TENANT_RETAIN tenants "
         "by recency; an evicted tenant's windows are dropped and counted on "
         "spgemm_slo_tenants_evicted_total).  Read by obs/slo.py.",
         default="3600", minimum=1),
    Knob("SPGEMM_TPU_TUNE", "bool01",
         "Autotuner master switch (tune/): 1 = spgemmd loads persisted tuned "
         "overrides from the warm store at start, applies each structure class's "
         "winning knob vector at job pickup behind the canary gate (the first job "
         "under a fresh vector runs a tightened deadline; a canary failure reverts "
         "the override and backs off), and adapts the estimator's per-class "
         "sampling budget from its observed relative error; 0 = no override is "
         "ever applied or loaded and no trial runs, the daemon as it was before "
         "the tuner.  Every searched knob is bit-identical A/B, so tuning changes "
         "wall time only, never bits.  Read by tune/tuner.py.",
         default="1"),
    Knob("SPGEMM_TPU_TUNE_TRIAL_S", "float",
         "Idle trial cadence, seconds: an executor whose whole pool is idle (an "
         "empty queue, no slice busy) this long after the previous trial leg runs "
         "ONE timed trial leg (one knob vector of the class's deterministic "
         "enumeration) on the class's representative folder, and returns to the "
         "job poll between legs, so a real job preempts a leg at its next "
         "multiply boundary.  0 = no trials (the default: persisted overrides "
         "still apply under SPGEMM_TPU_TUNE=1).  Read by serve/daemon.py.",
         default="0", minimum=0),
    Knob("SPGEMM_TPU_TUNE_MIN_WIN", "float",
         "Least measured speedup (incumbent wall / candidate wall) for the "
         "autotuner to promote a trial winner to a tuned override; below it the "
         "class keeps its incumbent vector (settled).  Keeps measurement noise "
         "from becoming canary churn.  Read by tune/tuner.py.",
         default="1.1", minimum=1),
    Knob("SPGEMM_TPU_FAILPOINTS", "str",
         "Failpoint arming spec (utils/failpoints.py): comma-joined "
         "name[:prob][:count] terms naming registered injection sites; prob "
         "defaults to 1, count to unlimited.  Unset = every failpoint inert.  An "
         "unknown name or a malformed term raises.  Read by utils/failpoints.py."),
)

REGISTRY: dict[str, Knob] = {kb.name: kb for kb in _KNOBS}


class _TunedOverlay:
    """The process-wide tuned overlay (tune/).  The tuner activates a class's
    vector by replacing it whole; every value it may hold is bit-identical
    A/B, so a thread that reads a just-swapped overlay (the chain's planner
    thread reads the route) changes wall time only.  The generation counter
    lets a timed trial leg see that the overlay was swapped under it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: dict[str, str] = {}  # spgemm-lint: guarded-by(_lock)
        self._gen = 0                      # spgemm-lint: guarded-by(_lock)

    def replace(self, mapping: dict[str, str]) -> None:
        validated: dict[str, str] = {}
        for name, raw in mapping.items():
            kb = REGISTRY[name]  # registering is the price of tuning
            if kb.kind == "flag":
                raise ValueError(f"{name} is a flag and has no value to tune")
            _parse(kb, str(raw))  # an invalid tuned value raises here
            validated[name] = str(raw)
        with self._lock:
            if validated != self._values:
                self._values = validated
                self._gen += 1

    def lookup(self, name: str) -> str | None:
        with self._lock:
            return self._values.get(name)

    def snapshot(self) -> dict[str, str]:
        with self._lock:
            return dict(self._values)

    def generation(self) -> int:
        with self._lock:
            return self._gen


_OVERLAY = _TunedOverlay()


def set_tuned(mapping: dict[str, str]) -> None:
    """Replace the tuned overlay with `mapping` ({knob name: string value});
    {} clears it.  Each value is validated at once."""
    _OVERLAY.replace(mapping)


def clear_tuned() -> None:
    """Drop every tuned override."""
    _OVERLAY.replace({})


def tuned_overlay() -> dict[str, str]:
    """A copy of the live tuned overlay ({} when none is active)."""
    return _OVERLAY.snapshot()


def tuned_generation() -> int:
    """The overlay's swap counter: a timed trial leg reads it before and
    after its measurement and discards the leg when it moved."""
    return _OVERLAY.generation()


def _parse(kb: Knob, raw: str):
    if kb.kind == "bool01":
        if raw not in ("0", "1"):
            raise ValueError(f"{kb.name} must be 0 or 1, got {raw!r}")
        return raw == "1"
    if kb.kind == "enum":
        if raw not in kb.choices:
            raise ValueError(f"{kb.name} must be one of {'|'.join(kb.choices)}, got {raw!r}")
        return raw
    if kb.kind in ("int", "float"):
        what = "an integer" if kb.kind == "int" else "a number"
        try:
            val = int(raw) if kb.kind == "int" else float(raw)
        except ValueError:
            val = None
        if val is None or (kb.minimum is not None and val < kb.minimum):
            bound = f" >= {kb.minimum:g}" if kb.minimum is not None else ""
            raise ValueError(f"{kb.name} must be {what}{bound}, got {raw!r}")
        return val
    if kb.kind in ("path", "str"):
        return raw
    raise AssertionError(f"unknown knob kind {kb.kind!r}")  # registry bug


def _resolve(name: str, use_tuned: bool):
    kb = REGISTRY[name]
    raw = os.environ.get(name)
    if kb.kind == "flag":
        return bool(raw)
    raw = (raw or "").strip()
    if not raw and use_tuned:
        raw = _OVERLAY.lookup(name) or ""
    raw = raw or kb.default
    return None if raw is None else _parse(kb, raw)


def get(name: str):
    """Typed, validated value of a registered knob: a non-empty environment
    value, else a live tuned override, else the default.  Unregistered names
    raise KeyError."""
    return _resolve(name, use_tuned=True)


def base_get(name: str):
    """get() with the tuned overlay ignored: env > default.  The tune tier
    validates its entries against this form; against the overlaid one it
    would be circular, since loading an override changes the overlay."""
    return _resolve(name, use_tuned=False)


def base_tuned_vector() -> tuple:
    """(name, base value) of every knob the tuner searches, in registry
    order: the signature of a persisted tuned override.  An exported value
    that changed across a restart makes every persisted override a counted
    cold fallback, since it was measured on another base."""
    return tuple((kb.name, str(base_get(kb.name))) for kb in _KNOBS if kb.tuned)


def source(name: str) -> str:
    """'env' where the environment gives the knob a non-empty value, 'tuned'
    where a live tuned override covers it, else 'default'."""
    kb = REGISTRY[name]
    raw = os.environ.get(name)
    if kb.kind == "flag":
        return "env" if raw else "default"
    if raw is not None and raw.strip():
        return "env"
    return "tuned" if _OVERLAY.lookup(name) is not None else "default"


def _display(val) -> str:
    if val is None:
        return "(unset)"
    if isinstance(val, bool):
        return "1" if val else "0"
    if isinstance(val, float):
        return f"{val:g}"
    return str(val)


def snapshot() -> list[dict]:
    """Every knob's state for `cli knobs`: name, current value, default,
    source, kind, whether the tuner searches it, doc.  An invalid env value
    does not abort the listing: its row shows the raw value and an `error`,
    while get() at the consuming site stays strict."""
    rows = []
    for kb in _KNOBS:
        try:
            value, error = _display(get(kb.name)), None
        except ValueError as e:
            value, error = f"INVALID {os.environ.get(kb.name, '')!r}", str(e)
        rows.append({
            "name": kb.name, "value": value,
            "default": _display(False if kb.kind == "flag" and kb.default is None
                                else kb.default),
            "source": source(kb.name), "kind": kb.kind, "tuned_search": kb.tuned,
            "doc": kb.doc, **({"error": error} if error else {}),
        })
    return rows


def pin_unless_exported(name: str, value: str):
    """Set knob `name` to `value` in the environment unless the caller
    exported it (an explicit value always wins).  Returns a callable that
    undoes the pin (a no-op when nothing was pinned), for try/finally."""
    kb = REGISTRY[name]
    if kb.kind == "flag":
        raise ValueError(f"{name} is a flag and has no value to pin")
    _parse(kb, value)  # a pin must be a value the knob takes
    if source(name) == "env":
        return lambda: None
    os.environ[name] = value

    def restore() -> None:
        os.environ.pop(name, None)

    return restore


def _values_col(kb: Knob) -> str:
    if kb.choices:
        return "|".join(kb.choices)
    if kb.kind == "bool01":
        return "0|1"
    if kb.kind == "flag":
        return "set/unset"
    if kb.minimum is not None:
        return f"{kb.kind} >= {kb.minimum:g}"
    return kb.kind


def knob_table_md() -> str:
    """The generated knob table of spgemm_tpu_torch/ARCHITECTURE.md.  The
    linter's DOC rule diffs this text against the committed block between
    the `<!-- knob-table:begin -->` / `<!-- knob-table:end -->` markers."""
    lines = [
        "| knob | values | default | tuned | what it does |",
        "|---|---|---|---|---|",
    ]

    def md(cell: str) -> str:  # literal pipes would split the table cell
        return cell.replace("|", "\\|")

    for kb in _KNOBS:
        default = "(unset)" if kb.default is None else f"`{kb.default}`"
        lines.append(
            f"| `{kb.name}` | {md(_values_col(kb))} | {default} "
            f"| {'yes' if kb.tuned else 'no'} | {md(kb.doc)} |")
    return "\n".join(lines)


def cli_epilog() -> str:
    """argparse epilog for the CLI: the registry's knob list, so `--help`
    can never drift from the code (the DOC rule checks coverage)."""
    lines = ["environment knobs (see `spgemm_tpu_torch.cli knobs` for live "
             "values; central registry: spgemm_tpu_torch/utils/knobs.py):"]
    for kb in _KNOBS:
        default = "unset" if kb.default is None else kb.default
        lines.append(f"  {kb.name}={_values_col(kb)} (default {default}): "
                     f"{kb.doc}")
    return "\n".join(lines)
