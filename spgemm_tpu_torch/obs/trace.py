"""Span flight recorder: the engine's in-process black box (the port's copy
of the JAX package's `obs/trace.py`, in its trace_event format).

Every `utils/timers.PhaseTimers` phase enter and exit emits a span here --
name, monotonic timestamp, duration, thread, parent span, and the job and
trace tags active on the emitting thread -- into a bounded ring
(`SPGEMM_TPU_OBS_RING_CAP`, default 4096 spans; the oldest are evicted and
counted).  spgemmd dumps the ring next to its journal on every reap, wedge
and degrade (<socket>.flight/), serves it as the `trace` op, and
`spgemm_tpu_torch.cli trace-dump` writes or merges it.

Spans are host time.  CUDA launches and copies are asynchronous, so a span
around an upload or a launch closes when the work is queued, not when the
card finishes it; kernel time is read with CUDA events (chip_smoke.py), and
no span synchronizes the card.

`SPGEMM_TPU_OBS_TRACE=0` turns span emission off (the timers still
accumulate): the A/B pair that measures the recorder's cost.

The ring is guarded by a lock; each thread's open-span stack and tag map
live in a threading.local.  Parenting is lexical per thread: the span open
on a thread when another begins is its parent, so a numeric_dispatch span
nests under the serve_execute span of the job that dispatched it.  The
planner thread adopts the job's tags through ENGINE.attributed(), so its
plan spans carry the job id too.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

from spgemm_tpu_torch.obs import profile
from spgemm_tpu_torch.utils import knobs

# one monotonic origin per process: every span timestamp is microseconds
# since this module loaded, so spans from any thread share one timeline
_BASE = time.perf_counter()


def enabled() -> bool:
    """SPGEMM_TPU_OBS_TRACE=0|1 (default 1): span emission on/off.  Read
    lazily per span, like every knob -- tests and A/B harnesses flip it
    mid-process."""
    return knobs.get("SPGEMM_TPU_OBS_TRACE")


def ring_cap() -> int:
    """SPGEMM_TPU_OBS_RING_CAP (default 4096): spans retained."""
    return knobs.get("SPGEMM_TPU_OBS_RING_CAP")


class FlightRecorder:
    """Bounded in-process span ring + per-thread span stacks and tags.

    begin()/end() bracket a phase (the PhaseTimers integration); point()
    records an externally-timed span ending now (timers.record); instant()
    records a zero-duration marker (degrade/reap transitions).  All are
    no-ops while the knob is off -- a disabled recorder costs one env read
    per phase."""

    def __init__(self):
        self._spans: deque = deque()  # spgemm-lint: guarded-by(_lock)
        self._dropped = 0             # spgemm-lint: guarded-by(_lock)
        self._emitted = 0             # spgemm-lint: guarded-by(_lock)
        self._next_id = 1             # spgemm-lint: guarded-by(_lock)
        self._lock = threading.Lock()
        self._tls = threading.local()  # open-span stack + tags, thread-affine

    # ------------------------------------------------------ thread state --
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_tags(self) -> dict:
        """The emitting thread's active job/trace tags (a copy)."""
        return dict(getattr(self._tls, "tags", ()) or {})

    @contextlib.contextmanager
    def tagged(self, **tags):
        """Attach tags (job_id/trace_id/...) to every span emitted by this
        thread inside the block; None values are dropped.  Nests: inner
        blocks layer over -- and on exit restore -- the outer map."""
        prev = getattr(self._tls, "tags", None)
        merged = dict(prev or {})
        merged.update({k: v for k, v in tags.items() if v is not None})
        self._tls.tags = merged
        try:
            yield
        finally:
            self._tls.tags = prev

    # --------------------------------------------------------- emission --
    def _new_id(self) -> int:
        """Span ids are assigned at OPEN time: a child span commits before
        its still-open parent, so the parent id the child records must be
        the id the parent will eventually commit under."""
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        return span_id

    def begin(self, name: str):
        """Open a span on this thread; returns the token end() consumes
        (None while disabled -- end(None) is a no-op)."""
        if not enabled():
            return None
        stack = self._stack()
        parent = stack[-1][0] if stack else None
        token = (self._new_id(), name, time.perf_counter(), parent)
        stack.append(token)
        return token

    def end(self, token) -> None:
        """Close the span `token` opened and ring-commit it."""
        if token is None:
            return
        now = time.perf_counter()
        stack = self._stack()
        span_id, name, t0, parent = token
        # unwind to our own entry: a knob flip mid-phase (or an abandoned
        # begin) can leave younger entries above it on this thread's stack
        while stack:
            if stack.pop()[0] == span_id:
                break
        self._commit(span_id, name, t0, now - t0, parent, "X")

    def point(self, name: str, seconds: float) -> None:
        """A span whose endpoints the caller timed itself (timers.record):
        ends now, lasted `seconds`, parented under this thread's open
        span."""
        if not enabled():
            return
        stack = self._stack()
        parent = stack[-1][0] if stack else None
        self._commit(self._new_id(), name, time.perf_counter() - seconds,
                     seconds, parent, "X")

    def instant(self, name: str, **tags) -> None:
        """Zero-duration marker (reap/wedge/degrade transitions)."""
        if not enabled():
            return
        stack = self._stack()
        parent = stack[-1][0] if stack else None
        with self.tagged(**tags):
            self._commit(self._new_id(), name, time.perf_counter(), 0.0,
                         parent, "i")

    def _commit(self, span_id: int, name: str, t0: float, dur_s: float,
                parent, ph: str) -> None:
        thread = threading.current_thread()
        span = {
            "id": span_id,
            "name": name,
            "ph": ph,
            "ts": round((t0 - _BASE) * 1e6, 3),     # us on the shared origin
            "dur": round(max(dur_s, 0.0) * 1e6, 3),  # us
            "tid": thread.ident,
            "thread": thread.name,
            "parent": parent,
        }
        tags = self.current_tags()
        if tags:
            span["tags"] = tags
        if ph == "X":
            # scrape-side phase latency: every completed span feeds the
            # per-phase histogram (_commit runs only while emission is on,
            # so the master knob gates it already)
            profile.observe_phase(name, dur_s)
        cap = ring_cap()
        with self._lock:
            self._spans.append(span)
            self._emitted += 1
            while len(self._spans) > cap:
                self._spans.popleft()
                self._dropped += 1

    # -------------------------------------------------------- inspection --
    def snapshot(self) -> list[dict]:
        """Retained spans, oldest first (copies -- safe to serialize)."""
        with self._lock:
            return [dict(s) for s in self._spans]

    def stats(self) -> dict:
        """Ring health for metrics: retained/emitted/dropped + config."""
        with self._lock:
            retained = len(self._spans)
            emitted = self._emitted
            dropped = self._dropped
        return {"spans": retained, "emitted": emitted, "dropped": dropped,
                "capacity": ring_cap(), "enabled": enabled()}

    def clear(self) -> None:
        """Drop every span and zero the counters (tests, harnesses)."""
        with self._lock:
            self._spans.clear()
            self._dropped = 0
            self._emitted = 0


# The process-wide recorder: every PhaseTimers instance emits here, the
# daemon snapshots it, the CLI dumps it.
RECORDER = FlightRecorder()


# ------------------------------------------------------- Perfetto export --
# metadata event carrying the process's wall-clock origin: the span `ts`
# axis is microseconds since this module's monotonic _BASE, which differs
# per process -- the anchor lets the merge tool put per-process dumps on
# one shared timeline (clock skew across hosts notwithstanding)
CLOCK_ORIGIN_META = "spgemm_clock_origin"


def wall_origin_us() -> float:
    """The wall-clock time (epoch microseconds) corresponding to this
    process's span-timestamp origin (_BASE)."""
    return (time.time() - (time.perf_counter() - _BASE)) * 1e6


def to_trace_events(spans: list[dict] | None = None,
                    process_name: str | None = None) -> list[dict]:
    """Chrome/Perfetto trace_event JSON array for the given spans (default:
    the live ring).  Complete events ('X') carry ts+dur; instants stay
    'i'; metadata events name the process and every thread in the viewer
    and anchor the timeline to wall clock (CLOCK_ORIGIN_META) so
    `cli trace-dump --merge` can stitch per-process dumps."""
    import sys  # noqa: PLC0415 -- only for the default process label

    if spans is None:
        spans = RECORDER.snapshot()
    pid = os.getpid()
    events: list[dict] = []
    named_tids: dict[int, str] = {}
    for s in spans:
        tid = s.get("tid") or 0
        if tid not in named_tids:
            named_tids[tid] = s.get("thread", f"thread-{tid}")
        args = dict(s.get("tags") or {})
        args["span_id"] = s.get("id")
        if s.get("parent") is not None:
            args["parent"] = s["parent"]
        ev = {"name": s["name"], "cat": "spgemm", "ph": s.get("ph", "X"),
              "ts": s["ts"], "pid": pid, "tid": tid, "args": args}
        if ev["ph"] == "X":
            ev["dur"] = s.get("dur", 0.0)
        events.append(ev)
    if process_name is None:
        process_name = (os.path.basename(sys.argv[0] or "python")
                        + f":{pid}")
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": process_name}},
            {"name": CLOCK_ORIGIN_META, "ph": "M", "pid": pid, "tid": 0,
             "args": {"wall_origin_us": round(wall_origin_us(), 3)}}]
    meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
              "args": {"name": name}}
             for tid, name in sorted(named_tids.items())]
    return meta + events


def dump_json(path: str, spans: list[dict] | None = None,
              process_name: str | None = None) -> str:
    """Write the trace_event array to `path` (parent dirs created) and
    return the path -- the one serializer behind `cli trace-dump` and the
    daemon's postmortem flight dumps."""
    events = to_trace_events(spans, process_name=process_name)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(events, f, separators=(",", ":"))
    os.replace(tmp, path)  # a reader never sees a torn dump
    return path


# ------------------------------------------------------- trace stitching --
def filter_trace(events: list[dict], trace_id: str) -> list[dict]:
    """The events whose `trace_id` tag equals `trace_id`, plus the
    metadata tracks (process/thread names, clock anchors) still backing
    a surviving event -- one job's trace id resolves to exactly one flame
    view, not a ring's worth of unrelated jobs."""
    keep = [ev for ev in events
            if ev.get("ph") == "M"
            or (ev.get("args") or {}).get("trace_id") == trace_id]
    live = {(ev.get("pid"), ev.get("tid")) for ev in keep
            if ev.get("ph") != "M"}
    live_pids = {pid for pid, _tid in live}
    out = []
    for ev in keep:
        if ev.get("ph") == "M":
            if ev.get("pid") not in live_pids:
                continue
            if ev.get("name") == "thread_name" \
                    and (ev.get("pid"), ev.get("tid")) not in live:
                continue
        out.append(ev)
    return out


def merge_trace_files(paths: list[str],
                      trace_id: str | None = None) -> list[dict]:
    """Stitch per-process/per-rank trace dumps into ONE Perfetto
    trace_event array (`cli trace-dump --merge <dir>`):

      * every file keeps its own process track -- colliding pids (two
        dumps of one restarted daemon) are remapped to fresh ids, and a
        file without a `process_name` metadata event gets one from its
        filename, so the viewer shows distinct labeled tracks;
      * timelines align on each dump's CLOCK_ORIGIN_META wall-clock
        anchor (span `ts` axes are per-process monotonic origins):
        every file's events shift onto the earliest anchor's axis; a
        legacy dump without an anchor merges unshifted;
      * `trace_id` filters to one trace's events (filter_trace), so a
        job's trace context opens as a single flame view from client
        submit to its kernel launches.

    Raises ValueError on a file that is not a trace_event array."""
    loaded: list[tuple[str, list[dict], float | None]] = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            events = json.load(f)
        if not isinstance(events, list):
            raise ValueError(f"{path} is not a trace_event JSON array")
        origin = None
        for ev in events:
            if ev.get("ph") == "M" and ev.get("name") == CLOCK_ORIGIN_META:
                anchor = (ev.get("args") or {}).get("wall_origin_us")
                if isinstance(anchor, (int, float)):
                    origin = float(anchor)
                break
        loaded.append((path, events, origin))
    anchors = [origin for _, _, origin in loaded if origin is not None]
    base = min(anchors) if anchors else 0.0
    claimed: dict[int, str] = {}  # merged pid -> owning file
    merged_meta: list[dict] = []
    merged_events: list[dict] = []
    for path, events, origin in loaded:
        shift = (origin - base) if origin is not None else 0.0
        remap: dict[int, int] = {}
        used: set[int] = set()  # merged pids this file already occupies
        named: set[int] = set()
        for ev in events:
            if ev.get("ph") == "M" and ev.get("name") == CLOCK_ORIGIN_META:
                continue  # internal anchor: consumed by the shift above
            pid = ev.get("pid", 0)
            new = remap.get(pid)
            if new is None:
                new = pid
                while claimed.get(new, path) != path or new in used:
                    new += 1  # collision: walk to a fresh process id
                claimed[new] = path
                used.add(new)
                remap[pid] = new
            ev = dict(ev)
            ev["pid"] = new
            if "ts" in ev:
                ev["ts"] = round(ev["ts"] + shift, 3)
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    named.add(new)
                merged_meta.append(ev)
            else:
                merged_events.append(ev)
        label = os.path.basename(path)
        for suffix in (".trace.json", ".json"):
            if label.endswith(suffix):
                label = label[: -len(suffix)]
                break
        for pid in set(remap.values()) - named:
            merged_meta.append({"name": "process_name", "ph": "M",
                                "pid": pid, "tid": 0,
                                "args": {"name": label}})
    merged_events.sort(key=lambda ev: ev.get("ts", 0.0))
    merged = merged_meta + merged_events
    if trace_id is not None:
        merged = filter_trace(merged, trace_id)
    return merged
