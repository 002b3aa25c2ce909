"""SLO engine: rolling service-level objectives over the serving surface
(the port's copy of the JAX package's `obs/slo.py`, whole: the same
constants, burn logic and report, so both packages judge the same record
stream alike).

Every terminal job the daemon commits feeds one record here (tenant,
slice, wall seconds, queue wait, error flag, trace context).  Records
land in bounded per-(tenant, slice) rolling windows (a ring of at most
``RECORD_RETAIN`` records each, aged out past ``SPGEMM_TPU_SLO_WINDOW_S``
-- never an unbounded sample list), from which the engine computes, per
tenant:

  * streaming latency quantiles (p50/p95/p99) via a fixed-bucket digest
    (``LATENCY_BUCKETS``; digests merge across a tenant's slices by
    adding counts, so per-tenant quantiles cost nothing extra);
  * the error ratio (failed / total jobs in the window);
  * the queue-wait share (queued seconds / total latency seconds --
    "is the tenant slow because the pool is busy or because jobs are?").

Declared objectives drive multi-window burn-rate evaluation (the Google
SRE workbook shape): ``SPGEMM_TPU_SLO_TARGET_S`` makes any job slower
than the target (or failed) a *bad* event, ``SPGEMM_TPU_SLO_ERROR_PCT``
is the budget (the bad fraction the window may spend), and a window
whose bad fraction exceeds the budget in BOTH the fast (window/12) and
slow (full window) views is *burning* -- the two-window AND is what
keeps one slow job from paging and a real regression from hiding.  A
burn transition emits a structured ``slo_burn`` event carrying the
newest bad job's trace context (so the alert resolves to one openable
stitched trace, ``cli trace-dump --merge``), flips the
``spgemm_slo_burn_active{tenant=,slice=}`` gauge, and clears with an
``slo_burn_clear`` when the window recovers.  Objectives unset
(``SPGEMM_TPU_SLO_TARGET_S`` absent) = accounting-only: quantile/error
series still render, burn evaluation never runs.

Tenant cardinality is bounded at the source: at most ``TENANT_RETAIN``
distinct tenants hold windows (top-K by recency); an evicted tenant's
windows are dropped and counted (``spgemm_slo_tenants_evicted_total``),
so a tenant-id-per-request client cannot grow the engine or the scrape
without bound.  The daemon applies the same cap to its
``spgemmd_tenant_queue_depth`` series (top-K + one ``other`` aggregate).

Imports neither torch nor numpy, like the rest of ``obs/``; keyed off the
master knob (``SPGEMM_TPU_OBS_TRACE=0`` = the whole engine inert --
``observe`` returns before touching any state).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from spgemm_tpu_torch.utils import knobs

# reported quantiles (Prometheus summary-style `quantile` label values)
QUANTILES = (0.5, 0.95, 0.99)

# fixed latency digest bucket upper bounds, seconds: a quantile is the
# first bound whose cumulative count covers the rank (coarse on purpose
# -- the digest is O(len) per window, never a sample list)
LATENCY_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.25, 1.0, 5.0, 30.0,
                   120.0, 600.0, 3600.0)

# the fast burn window is this fraction of the full objective window
# (SRE-workbook multi-window: 1h slow + 5m fast at the default 3600 s)
FAST_WINDOW_DIV = 12

# a window burns when bad_fraction/budget reaches this in BOTH windows
BURN_THRESHOLD = 1.0

# distinct tenants holding windows (top-K by recency; evictions counted)
# -- also the daemon's scrape-label cap for per-tenant series
TENANT_RETAIN = 32

# per-(tenant, slice) window ring bound (records, before age-out)
RECORD_RETAIN = 512


def enabled() -> bool:
    """The master knob (SPGEMM_TPU_OBS_TRACE): the SLO engine records
    and judges only while the observability stack is on -- one A/B flag
    prices the whole layer, overhead-free at 0."""
    return knobs.get("SPGEMM_TPU_OBS_TRACE")


def objectives() -> dict:
    """The declared objectives, read per call like every knob: target
    latency (None = accounting-only, no burn evaluation), error budget
    percent, and the rolling window seconds."""
    target = knobs.get("SPGEMM_TPU_SLO_TARGET_S")
    return {
        "target_s": target,
        "error_pct": knobs.get("SPGEMM_TPU_SLO_ERROR_PCT"),
        "window_s": knobs.get("SPGEMM_TPU_SLO_WINDOW_S"),
        "enabled": target is not None,
    }


class _Window:
    """One (tenant, slice) rolling window: bounded record ring + the
    live burn state.  Mutated only under the engine's lock."""

    __slots__ = ("records", "burn_active", "burn")

    def __init__(self):
        # (ts, wall_s, queue_wait_s, bad, error, trace_id) tuples,
        # oldest first; bounded by RECORD_RETAIN and aged past window_s
        self.records: deque = deque()
        self.burn_active = False
        self.burn: dict | None = None  # newest evaluation detail


def _quantile(digest: list[int], count: int, maximum: float,
              q: float) -> float:
    """The q-quantile from cumulative fixed-bucket counts: the first
    bucket bound whose cumulative count covers rank q*count (the
    observed maximum for the overflow bucket)."""
    if count <= 0:
        return 0.0
    rank = q * count
    for i, le in enumerate(LATENCY_BUCKETS):
        if digest[i] >= rank:
            return le
    return maximum


class SloEngine:
    """The process-wide SLO accountant: spgemmd feeds one record per
    committed terminal job (``observe``), scrapes/CLIs read
    ``samples``/``report``.  All state is engine-lock-guarded; burn
    transition events are emitted OUTSIDE the lock (the event log has
    its own lock and the two must never nest)."""

    def __init__(self):
        self._lock = threading.Lock()
        # (tenant, slice) -> _Window
        self._windows: "OrderedDict[tuple, _Window]" = OrderedDict()  # spgemm-lint: guarded-by(_lock)
        self._tenants: "OrderedDict[str, float]" = OrderedDict()  # spgemm-lint: guarded-by(_lock)
        self._evicted = 0   # spgemm-lint: guarded-by(_lock)
        self._records = 0   # spgemm-lint: guarded-by(_lock)

    # ------------------------------------------------------------ ingest --
    def observe(self, tenant: str, slice_name: str, wall_s: float,
                queue_wait_s: float, error: bool,
                trace_id: str | None = None,
                now: float | None = None) -> None:
        """One terminal job record.  Ages/evicts, then re-evaluates the
        window's burn state; a transition emits slo_burn/slo_burn_clear
        after the lock releases."""
        if not enabled():
            return
        obj = objectives()
        now = time.time() if now is None else now
        bad = bool(error) or (obj["target_s"] is not None
                              and wall_s > obj["target_s"])
        transitions: list[tuple[str, dict]] = []
        with self._lock:
            key = (tenant, slice_name)
            w = self._windows.get(key)
            if w is None:
                w = self._windows[key] = _Window()
            w.records.append((now, float(wall_s), float(queue_wait_s),
                              bad, bool(error), trace_id))
            while len(w.records) > RECORD_RETAIN:
                w.records.popleft()
            self._records += 1
            self._tenants[tenant] = now
            self._tenants.move_to_end(tenant)
            while len(self._tenants) > TENANT_RETAIN:
                old, _ = self._tenants.popitem(last=False)
                for k in [k for k in self._windows if k[0] == old]:
                    # an evicted window that was BURNING must close its
                    # alert lifecycle: a consumer pairing slo_burn with
                    # slo_burn_clear would otherwise hold a phantom open
                    # alert forever while the gauge series just vanishes
                    if self._windows[k].burn_active:
                        transitions.append(("slo_burn_clear", {
                            "tenant": k[0], "slice": k[1],
                            "reason": "tenant-evicted"}))
                    del self._windows[k]
                self._evicted += 1
            transitions += self._evaluate_locked(key, w, obj, now)
        self._emit(transitions)

    # -------------------------------------------------------- evaluation --
    def _evaluate_locked(self, key: tuple, w: _Window, obj: dict,
                         now: float) -> list[tuple[str, dict]]:
        """Multi-window burn-rate for one window (caller holds _lock);
        returns the transition events to emit after the lock releases.
        Ages out records past the objective window as a side effect."""
        window = obj["window_s"]
        while w.records and now - w.records[0][0] > window:
            w.records.popleft()
        if not obj["enabled"]:
            transitions = []
            if w.burn_active:
                transitions.append(("slo_burn_clear", {
                    "tenant": key[0], "slice": key[1],
                    "reason": "objectives-unset"}))
            w.burn_active = False
            w.burn = None
            return transitions
        fast_window = window / FAST_WINDOW_DIV
        # the budget floor keeps the burn ratio finite at a 0% budget
        # (any bad event then burns "infinitely" fast)
        budget = max(obj["error_pct"] / 100.0, 1e-9)
        slow_n = slow_bad = fast_n = fast_bad = 0
        newest_bad_trace = None
        for ts, _wall, _qw, bad, _err, trace_id in w.records:
            slow_n += 1
            slow_bad += bad
            if now - ts <= fast_window:
                fast_n += 1
                fast_bad += bad
            if bad and trace_id:
                newest_bad_trace = trace_id
        slow_burn = (slow_bad / slow_n) / budget if slow_n else 0.0
        fast_burn = (fast_bad / fast_n) / budget if fast_n else 0.0
        active = (slow_bad > 0 and slow_burn >= BURN_THRESHOLD
                  and fast_burn >= BURN_THRESHOLD)
        was = w.burn_active
        w.burn_active = active
        w.burn = {"fast_burn": round(fast_burn, 4),
                  "slow_burn": round(slow_burn, 4),
                  "bad": slow_bad, "jobs": slow_n,
                  "trace_id": newest_bad_trace}
        if active and not was:
            return [("slo_burn", {
                "tenant": key[0], "slice": key[1],
                "fast_burn": round(fast_burn, 4),
                "slow_burn": round(slow_burn, 4),
                "bad": slow_bad, "jobs": slow_n,
                "trace_id": newest_bad_trace,
                "target_s": obj["target_s"],
                "error_pct": obj["error_pct"],
                "window_s": window})]
        if was and not active:
            return [("slo_burn_clear", {"tenant": key[0],
                                        "slice": key[1]})]
        return []

    @staticmethod
    def _emit(transitions: list[tuple[str, dict]]) -> None:
        from spgemm_tpu_torch.obs import events  # noqa: PLC0415 -- events imports trace, trace feeds profile; keep slo leaf-light

        # the transition list only ever carries the two burn kinds;
        # re-spell them literally so the EVT registry rule can audit
        # the emit sites (a computed kind is unauditable by design)
        for kind, fields in transitions:
            if kind == "slo_burn":
                events.emit("slo_burn", **fields)
            else:
                events.emit("slo_burn_clear", **fields)

    def _reevaluate_all_locked(self, now: float) -> list[tuple[str, dict]]:
        """Slide every window to `now` (a burn with no new records must
        still clear when its bad records age out)."""
        obj = objectives()
        transitions: list[tuple[str, dict]] = []
        for key, w in self._windows.items():
            transitions += self._evaluate_locked(key, w, obj, now)
        return transitions

    # --------------------------------------------------------- inspection --
    def report(self, now: float | None = None) -> dict:
        """The `cli slo [--json]` / stats payload: objectives, per-tenant
        window accounts (quantiles merged over the tenant's slices,
        error ratio, queue-wait share), per-window burn state, and the
        cardinality-bound eviction count."""
        obj = objectives()
        now = time.time() if now is None else now
        with self._lock:
            transitions = self._reevaluate_all_locked(now)
            tenants: dict[str, dict] = {}
            burns: list[dict] = []
            for (tenant, slice_name), w in self._windows.items():
                agg = tenants.get(tenant)
                if agg is None:
                    agg = tenants[tenant] = {
                        "digest": [0] * len(LATENCY_BUCKETS), "max": 0.0,
                        "jobs": 0, "errors": 0, "wall_s": 0.0,
                        "queue_wait_s": 0.0}
                for _ts, wall, qw, _bad, err, _tr in w.records:
                    agg["jobs"] += 1
                    agg["errors"] += err
                    agg["wall_s"] += wall
                    agg["queue_wait_s"] += qw
                    agg["max"] = max(agg["max"], wall)
                    for i, le in enumerate(LATENCY_BUCKETS):
                        if wall <= le:
                            agg["digest"][i] += 1
                burns.append({"tenant": tenant, "slice": slice_name,
                              "active": w.burn_active,
                              **(w.burn or {})})
            evicted = self._evicted
            records = self._records
        self._emit(transitions)
        rows = {}
        for tenant, agg in sorted(tenants.items()):
            if not agg["jobs"]:
                continue
            total_s = agg["wall_s"] + agg["queue_wait_s"]
            rows[tenant] = {
                "jobs": agg["jobs"],
                "errors": agg["errors"],
                "error_ratio": round(agg["errors"] / agg["jobs"], 6),
                "queue_wait_share": round(
                    agg["queue_wait_s"] / total_s, 6) if total_s else 0.0,
                "latency_s": {f"p{int(q * 100)}": _quantile(
                    agg["digest"], agg["jobs"], agg["max"], q)
                    for q in QUANTILES},
            }
        return {"enabled": enabled(), "objectives": obj, "tenants": rows,
                "burn": burns,
                "burn_active": sum(1 for b in burns if b["active"]),
                "tenants_evicted": evicted, "records": records}

    def samples(self, now: float | None = None) -> list[tuple]:
        """Metric samples for the daemon scrape (families declared in
        obs/metrics.py): per-tenant quantile/error/queue-share gauges,
        per-(tenant, slice) burn gauges, the eviction counter.  Tenant
        label cardinality is bounded by TENANT_RETAIN at the source."""
        rep = self.report(now)
        samples: list[tuple] = []
        for tenant, row in rep["tenants"].items():
            for q in QUANTILES:
                samples.append(("spgemm_slo_latency_seconds",
                                {"tenant": tenant, "quantile": f"{q:g}"},
                                row["latency_s"][f"p{int(q * 100)}"]))
            samples.append(("spgemm_slo_error_ratio", {"tenant": tenant},
                            row["error_ratio"]))
            samples.append(("spgemm_slo_queue_wait_share",
                            {"tenant": tenant},
                            row["queue_wait_share"]))
        for b in rep["burn"]:
            samples.append(("spgemm_slo_burn_active",
                            {"tenant": b["tenant"], "slice": b["slice"]},
                            int(b["active"])))
        samples.append(("spgemm_slo_tenants_evicted_total", {},
                        rep["tenants_evicted"]))
        return samples

    def clear(self) -> None:
        """Drop every window and zero the counters (tests, harnesses)."""
        with self._lock:
            self._windows.clear()
            self._tenants.clear()
            self._evicted = 0
            self._records = 0


# The process-wide engine: spgemmd feeds it from the terminal-event path
# and serves the `slo` op / scrape families from it.
SLO = SloEngine()
