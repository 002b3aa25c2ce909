"""The autotuner: a per-structure-class search over the port's knobs that move
wall time and never bits (the port's copy of the JAX package's
`tune/tuner.py`).

The search set is the port's own (trial_vectors):

  * SPGEMM_TPU_ACCUM_ROUTE: each of auto|ladder|dense other than the base.
    The route is read where a plan is made (ops/spgemm.plan, ops/symbolic.
    plan_rounds, on the chain's planner thread too) and every route folds
    each key's pairs in the same order, so the bytes never change;
  * SPGEMM_TPU_PLAN_AHEAD: flipped between the base and 0 (inline).  It
    moves planning off the dispatching thread, never a fold.

and these stay out: SPGEMM_TPU_HYBRID_GATE (legs run `exact`, as the JAX
daemon's trial runner does), SPGEMM_TPU_OOC_DEPTH (daemon jobs do not run
out-of-core), SPGEMM_TPU_SERVE_BATCH_WINDOW_S (a solo leg cannot time a
batch), SPGEMM_TPU_PLAN_ESTIMATE (the estimator's budget is adapted by the
class's `est` override, not by a trial leg) and SPGEMM_TPU_RING_OVERLAP (a
trial leg runs the unsharded main path, where the knob moves nothing).  The
JAX package's set (ACCUM_ROUTE, ROUND_BATCH, MXU_R, RING_OVERLAP) also names
two knobs the port does not have.

Every leg's result digest must equal the baseline leg's (the parity
spot-check); a mismatch would be an engine bug and parks the class.

Lifecycle per (structure class, device kind):

    idle -> trialing -> canary -> live
                \\-> settled (no vector beat SPGEMM_TPU_TUNE_MIN_WIN)
    canary failure / parity mismatch -> reverted (+ exponential backoff,
    re-trialed after the backoff expires)

Scheduling is the daemon's: spgemmd calls `run_trial_leg` from an executor's
idle tick, at most one leg a tick, only while the whole pool is idle.  A
real job that arrives mid-leg aborts it at the next heartbeat
(TrialPreempted); legs never touch the queue, tenant accounting or the SLO
windows.  Trial execution is the daemon's `run_fn(folder) -> digest`
callback (the wall is clocked here) and persistence an injected store (the
warm store's tune tier), so this module imports neither torch nor numpy.
The overlay a promoted vector activates is knobs.set_tuned: process-wide
and replaced whole.
"""

from __future__ import annotations

import threading
import time

from spgemm_tpu_torch.obs import events
from spgemm_tpu_torch.utils import failpoints, knobs
from spgemm_tpu_torch.utils.timers import ENGINE

# The route's values; each but the base is one leg.
_ROUTE_CHOICES = ("auto", "ladder", "dense")

# Revert backoff: the first canary or parity failure parks the class this
# long; every later one doubles it, up to the cap.
BACKOFF0_S = 60.0
BACKOFF_CAP_S = 3600.0

# Estimator adaptation: after EST_MIN_JOBS scored jobs, a class whose mean
# relative error stays under EST_TIGHT halves its row-sample budget (floored
# at EST_ROWS_FLOOR and the registry's minimum), and a class whose mean
# exceeds EST_MISS raises its confidence threshold by EST_CONF_STEP (capped
# at 1.0: past it the exact join runs everywhere, which is the intent for a
# class the estimator keeps misjudging).
EST_MIN_JOBS = 4
EST_TIGHT = 0.05
EST_MISS = 0.5
EST_CONF_STEP = 0.2
EST_ROWS_FLOOR = 8


class TrialPreempted(Exception):
    """Raised by the daemon's trial run_fn (from the heartbeat it plants
    between multiplies) when a real job arrived mid-leg: the leg is
    discarded and the executor returns to the queue."""


def enabled() -> bool:
    """The tuner's master switch (SPGEMM_TPU_TUNE)."""
    return bool(knobs.get("SPGEMM_TPU_TUNE"))


def trial_cadence_s() -> float:
    """The idle-trial cadence (SPGEMM_TPU_TUNE_TRIAL_S; 0 = no trials)."""
    return float(knobs.get("SPGEMM_TPU_TUNE_TRIAL_S") or 0)


def min_win() -> float:
    """The promotion threshold (SPGEMM_TPU_TUNE_MIN_WIN)."""
    return float(knobs.get("SPGEMM_TPU_TUNE_MIN_WIN") or 1.1)


def trial_vectors() -> list[dict[str, str]]:
    """The deterministic trial plan of a class: leg 0 the base vector (the
    empty overlay, the incumbent), then one-knob deviations from the base
    (coordinate search, not the cross product).  The same on the card and
    the CPU: both knobs act on each."""
    legs: list[dict[str, str]] = [{}]
    base_route = str(knobs.base_get("SPGEMM_TPU_ACCUM_ROUTE"))
    for route in _ROUTE_CHOICES:
        if route != base_route:
            legs.append({"SPGEMM_TPU_ACCUM_ROUTE": route})
    ahead = knobs.REGISTRY["SPGEMM_TPU_PLAN_AHEAD"]
    legs.append({ahead.name: "0" if knobs.base_get(ahead.name) else ahead.default})
    return legs


class _ClassState:
    """One structure class's record; every field is owned by the Tuner's
    lock (the object never leaves the Tuner)."""

    def __init__(self, class_key: str, device_kind: str):
        self.class_key = class_key
        self.device_kind = device_kind
        self.state = "idle"  # idle|trialing|settled|canary|live|reverted
        self.pending: list[dict[str, str]] | None = None
        self.results: list[tuple[dict[str, str], float]] = []
        self.baseline_s: float | None = None
        self.baseline_digest = None
        self.override: dict[str, str] | None = None
        self.win: float | None = None
        self.backoff_s = 0.0
        self.retry_at = 0.0          # monotonic: no re-trial before this
        self.canary_inflight = False
        self.est_n = 0
        self.est_sum = 0.0
        self.est_override: dict[str, str] = {}

    def row(self) -> dict:
        """The status row (cli tune, spgemmd stats)."""
        return {
            "class": self.class_key,
            "device_kind": self.device_kind,
            "state": self.state,
            "knobs": dict(self.override or {}),
            "est": dict(self.est_override),
            "win": self.win,
            "backoff_s": self.backoff_s,
        }


class Tuner:
    """The state machine: class registry, trial planning, promotion, canary
    accounting, estimator adaptation, persistence.  Thread-safe: executors
    feed it from their idle ticks and terminal paths at once.  A leg runs
    outside the lock; only bookkeeping holds it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._classes: dict[str, _ClassState] = {}  # spgemm-lint: guarded-by(_lock)
        self._persist = None                        # spgemm-lint: guarded-by(_lock)
        self._trials = 0                            # spgemm-lint: guarded-by(_lock)
        self._reverts = 0                           # spgemm-lint: guarded-by(_lock)

    # -------------------------------------------------------------- wiring --
    def persist_with(self, fn) -> None:
        """Install the record store (warmstore.save_tune's shape:
        fn(class_key, record) -> bool); None disables persistence."""
        with self._lock:
            self._persist = fn

    def load(self, records: dict[str, dict]) -> int:
        """Seed classes from the warm store's tune tier (daemon start);
        returns the records adopted.  A record that was canary when its
        daemon died stays canary: the first job after the restart audits it
        again.  A reverted record keeps its backoff, re-anchored to this
        process's clock from the stored horizon."""
        now = time.monotonic()
        wall = time.time()
        n = 0
        with self._lock:
            for class_key, rec in sorted(records.items()):
                st = self._classes.get(class_key)
                if st is None:
                    st = _ClassState(class_key, str(rec.get("device_kind", "")))
                    self._classes[class_key] = st
                state = rec.get("state")
                if state in ("canary", "live"):
                    ov = {str(k): str(v) for k, v in (rec.get("knobs") or {}).items()
                          if k in knobs.REGISTRY}
                    if not ov:
                        continue
                    st.state = state
                    st.override = ov
                    st.win = rec.get("win")
                elif state == "reverted":
                    st.state = "reverted"
                    st.backoff_s = float(rec.get("backoff_s") or BACKOFF0_S)
                    st.retry_at = now + max(0.0, float(rec.get("not_before", 0.0)) - wall)
                else:
                    continue
                st.est_override = {str(k): str(v) for k, v in (rec.get("est") or {}).items()
                                   if k in knobs.REGISTRY}
                n += 1
        return n

    def _persist_locked(self, st: _ClassState) -> None:
        fn = self._persist
        if fn is None:
            return
        rec = {"class_key": st.class_key, "device_kind": st.device_kind,
               "state": st.state, "knobs": dict(st.override or {}),
               "est": dict(st.est_override), "win": st.win,
               "backoff_s": st.backoff_s,
               "not_before": time.time() + max(0.0, st.retry_at - time.monotonic())}
        try:
            fn(st.class_key, rec)
        except Exception:  # noqa: BLE001 -- a failing store never takes the serving path down; the override just does not survive a restart
            pass

    # ------------------------------------------------------------ job feed --
    def note_job(self, class_key: str | None, device_kind: str) -> None:
        """A sighting of a class (the daemon's terminal path): the first
        creates it idle; trials start once the class book can answer for
        it."""
        if not class_key or not enabled():
            return
        with self._lock:
            if class_key not in self._classes:
                self._classes[class_key] = _ClassState(class_key, device_kind)

    def overlay_for(self, class_key: str | None) -> dict[str, str]:
        """The overlay the class's jobs run under: the promoted vector
        (canary or live) over the estimator adaptation; {} when nothing is
        tuned or tuning is off."""
        if not class_key or not enabled():
            return {}
        with self._lock:
            st = self._classes.get(class_key)
            if st is None:
                return {}
            ov = dict(st.est_override)
            if st.state in ("canary", "live") and st.override:
                ov.update(st.override)
            return ov

    def consume_canary(self, class_key: str | None) -> bool:
        """True exactly once per canary attempt: the caller (the daemon's
        pickup) tightens the job's deadline and reports its outcome through
        note_terminal."""
        if not class_key or not enabled():
            return False
        with self._lock:
            st = self._classes.get(class_key)
            if st is None or st.state != "canary" or st.canary_inflight:
                return False
            st.canary_inflight = True
            return True

    def note_terminal(self, class_key: str | None, ok: bool) -> None:
        """The outcome of a job of the class: settles a canary in flight,
        live on success, reverted with backoff on failure."""
        if not class_key:
            return
        with self._lock:
            st = self._classes.get(class_key)
            if st is None or not st.canary_inflight:
                return
            st.canary_inflight = False
            if ok:
                st.state = "live"
                self._persist_locked(st)
                events.emit("tune_canary_passed", class_key=class_key, win=st.win,
                            knobs=dict(st.override or {}))
            else:
                self._revert_locked(st, "canary-failed")

    def _revert_locked(self, st: _ClassState, reason: str) -> None:
        st.state = "reverted"
        st.override = None
        st.win = None
        st.pending = None
        st.results = []
        st.baseline_s = None
        st.baseline_digest = None
        st.backoff_s = min(BACKOFF_CAP_S, (st.backoff_s * 2) if st.backoff_s else BACKOFF0_S)
        st.retry_at = time.monotonic() + st.backoff_s
        self._reverts += 1
        ENGINE.incr("tune_reverts")
        self._persist_locked(st)
        events.emit("tune_revert", class_key=st.class_key, reason=reason,
                    backoff_s=st.backoff_s)

    # ------------------------------------------------------ estimator loop --
    def note_est_accuracy(self, class_key: str | None, mean_rel_err: float,
                          n: int = 1) -> None:
        """One job's observed estimator accuracy (its mean relative error
        over the quantities obs/profile scored): tight classes shrink
        SPGEMM_TPU_EST_SAMPLE_ROWS, misfiring ones raise
        SPGEMM_TPU_EST_CONFIDENCE, both within the registry's ranges and
        carried by the class's overlay."""
        if not class_key or not enabled() or n <= 0:
            return
        with self._lock:
            st = self._classes.get(class_key)
            if st is None:
                return
            st.est_n += n
            st.est_sum += float(mean_rel_err) * n
            if st.est_n < EST_MIN_JOBS:
                return
            mean = st.est_sum / st.est_n
            st.est_n = 0
            st.est_sum = 0.0
            if mean < EST_TIGHT:
                kb = knobs.REGISTRY["SPGEMM_TPU_EST_SAMPLE_ROWS"]
                cur = int(st.est_override.get(kb.name, knobs.base_get(kb.name)))
                new = max(max(int(kb.minimum or 1), EST_ROWS_FLOOR), cur // 2)
                if new != cur:
                    st.est_override[kb.name] = str(new)
                    self._persist_locked(st)
            elif mean > EST_MISS:
                name = "SPGEMM_TPU_EST_CONFIDENCE"
                cur = float(st.est_override.get(name, knobs.base_get(name)))
                new = min(1.0, cur + EST_CONF_STEP)
                if new != cur:
                    st.est_override[name] = f"{new:g}"
                    self._persist_locked(st)

    # ---------------------------------------------------------- trial lane --
    def next_leg(self, folder_of) -> tuple[str, str, dict[str, str]] | None:
        """Claim the next due leg: (class_key, folder, vector), or None.
        `folder_of(class_key)` gives the class's representative folder
        (serve/placement.rep_folder); a class it cannot answer for is
        skipped.  Classes are visited in sorted order; a reverted class
        trials again once its backoff ran out."""
        if not enabled():
            return None
        now = time.monotonic()
        with self._lock:
            for class_key in sorted(self._classes):
                st = self._classes[class_key]
                if st.state == "reverted" and now >= st.retry_at:
                    st.state = "idle"
                if st.state not in ("idle", "trialing"):
                    continue
                folder = folder_of(class_key)
                if folder is None:
                    continue
                if st.pending is None:
                    st.state = "trialing"
                    st.pending = trial_vectors()
                    st.results = []
                if not st.pending:
                    continue
                return class_key, folder, st.pending[0]
        return None

    def record_leg(self, class_key: str, vector: dict[str, str], seconds: float,
                   digest) -> None:
        """Commit one timed leg.  The baseline leg (empty vector) pins the
        parity digest; a later leg whose digest differs parks the class.
        The last leg decides: the fastest candidate goes to canary if it
        beat the baseline by SPGEMM_TPU_TUNE_MIN_WIN, else the class
        settles untuned."""
        with self._lock:
            st = self._classes.get(class_key)
            if st is None or st.state != "trialing" or not st.pending \
                    or st.pending[0] != vector:
                return  # a stale leg (a revert or reload raced it): discarded
            st.pending.pop(0)
            if not vector:
                st.baseline_s = seconds
                st.baseline_digest = digest
            elif st.baseline_digest is not None and digest != st.baseline_digest:
                self._revert_locked(st, "parity-mismatch")
                return
            else:
                st.results.append((dict(vector), seconds))
            if st.pending:
                return
            st.pending = None
            self._decide_locked(st)

    def record_preempted(self, class_key: str, vector: dict[str, str], reason: str) -> None:
        """A leg was aborted (a real job arrived, the failpoint, an overlay
        swap mid-measurement, an error): its measurement is discarded and
        the class is left as it was, so the same leg runs at the next idle
        window."""
        events.emit("tune_trial_preempted", class_key=class_key, knobs=dict(vector),
                    reason=reason)

    def _decide_locked(self, st: _ClassState) -> None:
        if st.baseline_s is None or not st.results:
            st.state = "settled"
            return
        best_vec, best_s = min(st.results, key=lambda r: r[1])
        win = (st.baseline_s / best_s) if best_s > 0 else 0.0
        if win >= min_win():
            st.override = best_vec
            st.win = round(win, 3)
            st.state = "canary"
            st.canary_inflight = False
            with ENGINE.phase("tune_apply"):
                self._persist_locked(st)
            events.emit("tune_apply", class_key=st.class_key, knobs=best_vec, win=st.win,
                        baseline_s=round(st.baseline_s, 6), best_s=round(best_s, 6))
        else:
            st.state = "settled"
            st.win = round(win, 3)

    # ------------------------------------------------------------- surface --
    def stats(self) -> dict:
        """The stats block (spgemmd stats, cli tune): per-class rows and the
        counts the scrape renders."""
        with self._lock:
            rows = [self._classes[k].row() for k in sorted(self._classes)]
            trials, reverts = self._trials, self._reverts
        states: dict[str, int] = {}
        for r in rows:
            if r["state"] in ("canary", "live", "reverted"):
                states[r["state"]] = states.get(r["state"], 0) + 1
        return {"enabled": enabled(), "classes": rows, "overrides": states,
                "trials": trials, "reverts": reverts}

    def _count_trial(self) -> None:
        with self._lock:
            self._trials += 1

    def clear(self) -> None:
        """Drop every class (tests; `cli tune --clear` clears the store, and
        a daemon's memory follows at its next start)."""
        with self._lock:
            self._classes.clear()
            self._trials = 0
            self._reverts = 0


TUNER = Tuner()


def run_trial_leg(run_fn, folder_of, tuner: Tuner | None = None,
                  extra: dict | None = None) -> bool:
    """Run at most one trial leg (the daemon's idle-tick entry): claim the
    next due (class, folder, vector), activate the candidate overlay, run
    `run_fn(folder) -> digest` under it, clock its wall, restore the earlier
    overlay and commit the measurement.  True iff a leg ran, well or not.

    `extra` pins measurement-context knobs onto every leg's overlay, the
    baseline's too, without joining a persisted vector (the daemon passes
    {"SPGEMM_TPU_DELTA": "0"}: a repeat leg answered from the delta store's
    retained result would time a splice, not the candidate).

    A leg is discarded, with the class untouched, when run_fn raises
    TrialPreempted (a real job arrived), when the overlay's generation moved
    during it (another activation swapped the overlay mid-measurement), when
    the armed `tune.trial` failpoint fires, or when it raises anything else.
    The `tune_trial` event carries, beside the JAX package's fields, the
    leg's digest and its ENGINE phases and counters (its PhaseScope: plan
    seconds, kernel launches)."""
    t = tuner if tuner is not None else TUNER
    leg = t.next_leg(folder_of)
    if leg is None:
        return False
    class_key, folder, vector = leg
    prev = knobs.tuned_overlay()
    with ENGINE.phase("tune_trial"):
        ENGINE.incr("tune_trials")
        t._count_trial()
        try:
            failpoints.check("tune.trial")
            overlay = dict(prev)
            overlay.update(extra or {})
            overlay.update(vector)
            knobs.set_tuned(overlay)
            gen0 = knobs.tuned_generation()
            with ENGINE.scope() as scope:
                t0 = time.perf_counter()
                digest = run_fn(folder)
                dt = time.perf_counter() - t0
            skewed = knobs.tuned_generation() != gen0
        except TrialPreempted:
            t.record_preempted(class_key, vector, "preempted")
            return True
        except failpoints.FailpointTriggered:
            t.record_preempted(class_key, vector, "failpoint")
            return True
        except Exception as e:  # noqa: BLE001 -- a dying leg never takes the executor's idle tick down; the class retries next window
            t.record_preempted(class_key, vector, f"error:{type(e).__name__}")
            return True
        finally:
            knobs.set_tuned(prev)
        if skewed:
            t.record_preempted(class_key, vector, "overlay-swapped")
            return True
        events.emit("tune_trial", class_key=class_key, knobs=dict(vector),
                    seconds=round(dt, 6), digest=str(digest), phases_s=scope.snapshot(),
                    counters=scope.counter_snapshot())
        t.record_leg(class_key, vector, dt, digest)
    return True
