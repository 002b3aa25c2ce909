"""Registry of the `SPGEMM_TPU_*` environment knobs the port reads (the
port's copy of the JAX package's `utils/knobs.py`, cut to those knobs).

Each knob keeps the JAX package's name, kind and parsing: an empty or unset
value means the default (None where the knob has none, False for a flag),
surrounding whitespace is stripped, and an invalid value raises ValueError
naming the knob.  Reads are lazy: the environment is consulted at each
`get()`, so tests may set a value mid-process.
"""

from __future__ import annotations

import os
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
    """

    name: str
    kind: str
    doc: str
    default: str | None = None
    choices: tuple[str, ...] | None = None
    minimum: float | None = None


_KNOBS = (
    Knob("SPGEMM_TPU_PLAN_AHEAD", "int",
         "Chain plan-ahead depth: up to N upcoming pairs of a pass are planned "
         "by a host worker thread while the main thread dispatches the current "
         "pair; 0 = inline planning (bit-identical either way).  Read by chain.py.",
         default="2", minimum=0),
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
         default="auto", choices=("auto", "ladder", "dense")),
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
    Knob("SPGEMM_TPU_SERVE_SLICES", "str",
         "spgemmd device-pool slice spec (parallel/mesh.slice_pool): terms "
         "[COUNTx]WIDTH[*] joined by '+', or 'auto'.  The port serves one "
         "single-device slice: '1', or 'auto' with one visible card.  A wide "
         "slice, more slices, or more devices than are visible fail daemon "
         "startup.  Read by serve/daemon.py.",
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
    Knob("SPGEMM_TPU_FAILPOINTS", "str",
         "Failpoint arming spec (utils/failpoints.py): comma-joined "
         "name[:prob][:count] terms naming registered injection sites; prob "
         "defaults to 1, count to unlimited.  Unset = every failpoint inert.  An "
         "unknown name or a malformed term raises.  Read by utils/failpoints.py."),
)

REGISTRY: dict[str, Knob] = {kb.name: kb for kb in _KNOBS}


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


def get(name: str):
    """Typed, validated value of a registered knob: a non-empty environment
    value, else the default.  Unregistered names raise KeyError."""
    kb = REGISTRY[name]
    raw = os.environ.get(name)
    if kb.kind == "flag":
        return bool(raw)
    raw = (raw or "").strip() or kb.default
    return None if raw is None else _parse(kb, raw)


def source(name: str) -> str:
    """'env' where the environment gives the knob a non-empty value, else
    'default'."""
    kb = REGISTRY[name]
    raw = os.environ.get(name)
    if kb.kind == "flag":
        return "env" if raw else "default"
    return "env" if raw is not None and raw.strip() else "default"


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
