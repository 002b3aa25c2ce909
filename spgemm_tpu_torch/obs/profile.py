"""Profiling accounts: what the engine cost and whether its predictions
held (the port's copy of the JAX package's `obs/profile.py`).

Four accounts, as in the JAX package:

  * **Build accounting** -- the port has no jit and no AOT surface: its
    kernels are shared libraries built at first use (csrc/*.cu by nvcc,
    ops/_build.py; native/*.cpp by g++, utils/native.py).  The first load
    of each library in a process lands one record (`record_build`): the
    wall of the build or reuse plus the dlopen, whether it was compiled now
    or reused from build/, and the ptxas report per kernel (registers,
    spill bytes, shared bytes) that nvcc keeps beside the library.  A build
    record has no cost analysis: its `flops`, `bytes_accessed` and `*_bytes`
    fields are 0.  The records go through `record_compile`, the JAX
    package's path, so the `compiles` counter, the `compile` event and the
    `spgemm_compile*` families are the JAX package's.
  * **Memory watermark** -- the engine pushes the CUDA caching allocator's
    view (its allocated bytes now and at peak, as `torch.cuda.memory_allocated`
    / `max_memory_allocated` report them) at its multiply boundaries (`observe_memory`); on the CPU it pushes None and
    every gauge is omitted.  The allocator's view is not the whole card's:
    it leaves out the CUDA context, the allocator's cached free blocks and
    any other process.  Each reading also lands in the window of the
    emitting thread's `job_id` span tag (`memory_job_begin` /
    `memory_job_peak`), so a wedged executor's late samples stay with its
    own job.
  * **Prediction accountability** -- when an estimated plan's deferred
    exact join lands, the sampled estimate is scored against it
    (`observe_estimate`); every delta-enabled multiply scores its
    predicted-dirty rows against the rows it executed (`observe_delta`).
  * **Phase latency histograms** -- every completed flight-recorder span of
    a declared ENGINE phase feeds a per-phase histogram (`observe_phase`).

The layer records only while SPGEMM_TPU_OBS_TRACE is on, as the JAX
package's.  Accounting never swallows a kernel's build, load or launch
failure: a failed build raises before anything is recorded.  Imports
neither torch nor numpy: the engine pushes plain numbers in.
"""

from __future__ import annotations

import re
import threading
import time
from collections import OrderedDict

from spgemm_tpu_torch.obs.metrics import ENGINE_PHASES
from spgemm_tpu_torch.utils import knobs


def enabled() -> bool:
    """The master knob (SPGEMM_TPU_OBS_TRACE): the accounts record only
    while span emission is on."""
    return knobs.get("SPGEMM_TPU_OBS_TRACE")


# ------------------------------------------------------------ histograms --
COMPILE_BUCKETS = (0.01, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0)
REL_ERR_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0)
FRACTION_BUCKETS = (0.0, 0.01, 0.05, 0.1, 0.25, 0.5, 0.9)
PHASE_BUCKETS = (0.0001, 0.001, 0.01, 0.1, 1.0, 10.0, 60.0)


class Hist:
    """Fixed-bucket histogram in the sample shape obs/metrics.render takes
    ({"buckets": {le: cumulative}, "sum", "count"}).  Not self-locked:
    every instance is mutated under the module's _LOCK."""

    def __init__(self, buckets: tuple):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe_locked(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, le in enumerate(self.buckets):
            if value <= le:
                self.counts[i] += 1

    def snapshot_locked(self) -> dict:
        # counts[i] is already cumulative: observe bumps every bucket whose
        # bound admits the value
        return {"buckets": dict(zip(self.buckets, self.counts)),
                "sum": round(self.sum, 6), "count": self.count}


# --------------------------------------------------------------- the book --
# build records kept for `cli profile` (the aggregates are unbounded
# counters; the record list is a bounded ring)
COMPILE_RETAIN = 256

_LOCK = threading.Lock()
_COMPILES: list[dict] = []          # spgemm-lint: guarded-by(_LOCK)
_COMPILE_DROPPED = 0                # spgemm-lint: guarded-by(_LOCK)
_SITES: dict[str, dict] = {}        # spgemm-lint: guarded-by(_LOCK)
_MEM = {"available": False, "samples": 0, "bytes_in_use": 0,
        "peak_bytes": 0}            # spgemm-lint: guarded-by(_LOCK)
# per-job high-water marks keyed by the emitting thread's job_id span tag
# (LRU-bounded), so a wedged executor's late samples land in its own job's
# window, never its replacement's
_MEM_JOBS: "OrderedDict[str, int]" = OrderedDict()  # spgemm-lint: guarded-by(_LOCK)
MEM_JOB_RETAIN = 64
_EST: dict[str, Hist] = {}          # spgemm-lint: guarded-by(_LOCK)
_EST_COUNT = 0                      # spgemm-lint: guarded-by(_LOCK)
_DELTA = {"hist": Hist(FRACTION_BUCKETS), "predicted": 0, "executed": 0,
          "mispredictions": 0}      # spgemm-lint: guarded-by(_LOCK)
_PHASES: dict[str, Hist] = {}       # spgemm-lint: guarded-by(_LOCK)


def clear() -> None:
    """Zero every account (tests, A/B harnesses)."""
    global _COMPILE_DROPPED, _EST_COUNT
    with _LOCK:
        _COMPILES.clear()
        _COMPILE_DROPPED = 0
        _SITES.clear()
        _MEM.update(available=False, samples=0, bytes_in_use=0, peak_bytes=0)
        _MEM_JOBS.clear()
        _EST.clear()
        _EST_COUNT = 0
        _DELTA["hist"] = Hist(FRACTION_BUCKETS)
        _DELTA["predicted"] = _DELTA["executed"] = 0
        _DELTA["mispredictions"] = 0
        _PHASES.clear()


# ------------------------------------------------------- build accounting --
def record_compile(site: str, wall_s: float, signature, cost: dict, memory: dict,
                   **extra) -> None:
    """Land one record: the bounded record list, the per-site aggregates,
    the `compiles` ENGINE counter (so a job's detail shows which job paid
    for a build) and a `compile` event.  extra: fields of the record beyond
    the JAX package's (a build's `built` and `ptxas`)."""
    global _COMPILE_DROPPED
    rec = {
        "site": site,
        "wall_s": round(wall_s, 6),
        "signature": repr(signature),
        "flops": cost.get("flops", 0.0),
        "bytes_accessed": cost.get("bytes accessed", 0.0),
        **{k: memory.get(k, 0) for k in ("argument_bytes", "output_bytes",
                                         "temp_bytes", "code_bytes")},
        **extra,
        "ts": round(time.time(), 3),
    }
    with _LOCK:
        _COMPILES.append(rec)
        while len(_COMPILES) > COMPILE_RETAIN:
            _COMPILES.pop(0)
            _COMPILE_DROPPED += 1
        agg = _SITES.get(site)
        if agg is None:
            agg = _SITES[site] = {"count": 0, "seconds": Hist(COMPILE_BUCKETS),
                                  "flops_total": 0.0, "bytes_total": 0.0,
                                  "temp_bytes_max": 0}
        agg["count"] += 1
        agg["seconds"].observe_locked(wall_s)
        agg["flops_total"] += rec["flops"]
        agg["bytes_total"] += rec["bytes_accessed"]
        agg["temp_bytes_max"] = max(agg["temp_bytes_max"], rec["temp_bytes"])
    # lazy: timers -> trace -> profile is the import chain
    from spgemm_tpu_torch.utils.timers import ENGINE  # noqa: PLC0415
    ENGINE.incr("compiles")
    from spgemm_tpu_torch.obs import events  # noqa: PLC0415
    events.emit("compile", site=site, wall_s=rec["wall_s"], flops=rec["flops"],
                temp_bytes=rec["temp_bytes"], built=extra.get("built"))


def record_build(site: str, wall_s: float, built: bool, signature,
                 ptxas: dict | None) -> None:
    """One library's first load in this process: `site` the source's stem
    (a csrc/<site>.cu, or `native` for the g++ host library), the wall of
    the build or reuse plus the dlopen, `built` True when it was compiled
    now and False when reused from build/, `signature` the library's file
    name (its hash covers sources, flags and toolchain), `ptxas` the
    per-kernel registers, spill and shared bytes (None for a host
    library).  No cost analysis exists for a build, so the record's
    flops, bytes_accessed and *_bytes are 0."""
    if not enabled():
        return
    record_compile(site, wall_s, signature, {}, {}, built=bool(built), ptxas=ptxas)


def parse_ptxas(log: str) -> dict:
    """nvcc's `-Xptxas -v` report as {kernel entry: {"registers",
    "spill_stores", "spill_loads", "smem_bytes"}} (entries mangled as ptxas
    names them)."""
    out = {}
    for chunk in log.split("Compiling entry function")[1:]:
        name = re.match(r"\s*'([^']+)'", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        if name and regs:
            out[name.group(1)] = {"registers": int(regs.group(1)),
                                  "spill_stores": int(spill.group(1)) if spill else 0,
                                  "spill_loads": int(spill.group(2)) if spill else 0,
                                  "smem_bytes": int(smem.group(1)) if smem else 0}
    return out


# ------------------------------------------------------- memory watermark --
def _bump_job_peak_locked(job_id: str, in_use: int) -> None:
    _MEM_JOBS[job_id] = max(_MEM_JOBS.get(job_id, 0), in_use)
    _MEM_JOBS.move_to_end(job_id)
    while len(_MEM_JOBS) > MEM_JOB_RETAIN:
        _MEM_JOBS.popitem(last=False)


def observe_memory(stats: dict | None) -> None:
    """One device memory reading ({"bytes_in_use", "peak_bytes_in_use"}),
    pushed by the engine at its multiply boundaries.  None (the CPU) leaves
    every gauge unavailable.  The reading also lands in the window of the
    emitting thread's job_id span tag, if it has one."""
    if not enabled():
        return
    if not isinstance(stats, dict) or "bytes_in_use" not in stats:
        return
    from spgemm_tpu_torch.obs import trace  # noqa: PLC0415 -- trace imports profile back
    job_id = trace.RECORDER.current_tags().get("job_id")
    in_use = int(stats["bytes_in_use"])
    peak = max(int(stats.get("peak_bytes_in_use", 0)), in_use)
    with _LOCK:
        _MEM["available"] = True
        _MEM["samples"] += 1
        _MEM["bytes_in_use"] = in_use
        _MEM["peak_bytes"] = max(_MEM["peak_bytes"], peak)
        if job_id is not None:
            _bump_job_peak_locked(str(job_id), in_use)


def memory_job_begin(job_id: str) -> None:
    """Open (or reset) job_id's high-water window, seeded with the newest
    reading, so results retained before the job count toward its peak.  A
    no-op while the device has never reported."""
    with _LOCK:
        if _MEM["available"]:
            _MEM_JOBS.pop(str(job_id), None)
            _bump_job_peak_locked(str(job_id), _MEM["bytes_in_use"])


def memory_job_peak(job_id: str | None) -> int | None:
    """The peak reading in job_id's window, or None when the device never
    reported for it (the detail key is then omitted, not zero).  Reading
    does not close the window."""
    if job_id is None:
        return None
    with _LOCK:
        return _MEM_JOBS.get(str(job_id))


def memory_stats() -> dict:
    with _LOCK:
        return dict(_MEM)


# ------------------------------------------------ prediction accountability --
def _rel_err(predicted: float, actual: float) -> float:
    return abs(float(predicted) - float(actual)) / max(float(actual), 1.0)


def observe_estimate(est_keys: float, est_pairs: float, est_fanout: float,
                     actual_keys: float, actual_pairs: float,
                     actual_fanout: float) -> None:
    """Score one sampled structure estimate against the exact join it
    predicted (called when an estimated plan's deferred join lands)."""
    global _EST_COUNT
    if not enabled():
        return
    errors = {"keys": _rel_err(est_keys, actual_keys),
              "pairs": _rel_err(est_pairs, actual_pairs),
              "fanout": _rel_err(est_fanout, actual_fanout)}
    with _LOCK:
        _EST_COUNT += 1
        for quantity, err in errors.items():
            hist = _EST.get(quantity)
            if hist is None:
                hist = _EST[quantity] = Hist(REL_ERR_BUCKETS)
            hist.observe_locked(err)


def observe_delta(predicted_rows: int, executed_rows: int, total_rows: int) -> None:
    """Account one delta-enabled multiply: the predicted-dirty fraction
    (a full fallback observes 1.0) into the histogram, predicted and
    executed rows into totals, and a misprediction where they differ (the
    engine executes exactly the rows it predicts, so one is an engine
    fault)."""
    if not enabled():
        return
    frac = min(1.0, int(predicted_rows) / max(int(total_rows), 1))
    with _LOCK:
        _DELTA["hist"].observe_locked(frac)
        _DELTA["predicted"] += int(predicted_rows)
        _DELTA["executed"] += int(executed_rows)
        if int(executed_rows) != int(predicted_rows):
            _DELTA["mispredictions"] += 1


# -------------------------------------------------- phase latency histogram --
def observe_phase(name: str, dur_s: float) -> None:
    """One completed span's duration (fed by the flight recorder on commit,
    which already gates on the master knob).  Only the port's declared
    ENGINE phases are admitted: spans of ad-hoc PhaseTimers (the run-once
    CLI's own phases) must not mint undeclared label values."""
    if name not in ENGINE_PHASES:
        return
    with _LOCK:
        hist = _PHASES.get(name)
        if hist is None:
            hist = _PHASES[name] = Hist(PHASE_BUCKETS)
        hist.observe_locked(dur_s)


# ------------------------------------------------------------- inspection --
def compile_stats() -> dict:
    """Per-site build aggregates (histograms in the metrics sample shape)."""
    with _LOCK:
        return {site: {"count": agg["count"],
                       "seconds": agg["seconds"].snapshot_locked(),
                       "flops_total": agg["flops_total"],
                       "bytes_total": agg["bytes_total"],
                       "temp_bytes_max": agg["temp_bytes_max"]}
                for site, agg in sorted(_SITES.items())}


def est_stats() -> dict:
    with _LOCK:
        return {"count": _EST_COUNT,
                "rel_error": {q: h.snapshot_locked() for q, h in sorted(_EST.items())}}


def delta_stats() -> dict:
    with _LOCK:
        return {"count": _DELTA["hist"].count,
                "predicted_rows": _DELTA["predicted"],
                "executed_rows": _DELTA["executed"],
                "mispredictions": _DELTA["mispredictions"],
                "dirty_fraction": _DELTA["hist"].snapshot_locked()}


def phase_stats() -> dict:
    with _LOCK:
        return {name: h.snapshot_locked() for name, h in sorted(_PHASES.items())}


def report() -> dict:
    """The `profile` op's payload (`cli profile --json`): the bounded
    record list and every aggregate account."""
    from spgemm_tpu_torch.obs import events  # noqa: PLC0415
    with _LOCK:
        compiles = [dict(r) for r in _COMPILES]
        dropped = _COMPILE_DROPPED
    return {
        "enabled": enabled(),
        "compiles": compiles,
        "compiles_dropped": dropped,
        "compile_sites": compile_stats(),
        "memory": memory_stats(),
        "estimator": est_stats(),
        "delta": delta_stats(),
        "events": events.LOG.stats(),
    }


def summary() -> dict:
    """The one-line digest (`stats`): build count and wall, the estimator's
    mean relative errors, the delta path's mean dirty fraction and
    mispredictions, the device peak."""
    with _LOCK:
        n_compiles = sum(agg["count"] for agg in _SITES.values())
        compile_s = sum(agg["seconds"].sum for agg in _SITES.values())
        est = {q: round(h.sum / h.count, 4) for q, h in sorted(_EST.items()) if h.count}
        est_n = _EST_COUNT
        d = _DELTA["hist"]
        delta_frac = round(d.sum / d.count, 4) if d.count else None
        delta_n = d.count
        mispredict = _DELTA["mispredictions"]
        mem = _MEM["peak_bytes"] if _MEM["available"] else None
    return {"compiles": n_compiles, "compile_s": round(compile_s, 4),
            "est_observations": est_n, "est_mean_rel_error": est,
            "delta_observations": delta_n,
            "delta_mean_dirty_fraction": delta_frac,
            "delta_mispredictions": mispredict,
            "hbm_peak_bytes": mem}
