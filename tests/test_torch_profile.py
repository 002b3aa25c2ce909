"""The port's profiling accounts (spgemm_tpu_torch/obs/profile.py) against
the JAX package's (spgemm_tpu/obs/profile.py), on the CPU: the same
estimate, delta, phase and memory sequences (made from numpy seeds, job
tags on each package's own recorder) fed into both modules give equal
stats, summary(), report() apart from the build records, and the same
rendered families; a build record renders as the JAX package's compile
record of the same wall.  Then the port's own pushes: a build record per
library at first load (the g++ host library for real, a kernel library
through a stubbed build), none for a failed build, which raises; the
recorder feeds only declared phases; a CPU chain with the estimator on,
sized past its row-sample budget, scores as many plans as the JAX chain;
the delta account of an edit sequence equals the dirty rows counted from
the edit; the memory gauges are omitted on the CPU, and the card's reading
comes from the allocator without a sync.  Tolerance: exact equality."""

import contextlib
import io
import json
import shutil

import numpy as np
import pytest
import torch

from spgemm_tpu.obs import events as jax_events
from spgemm_tpu.obs import metrics as jax_metrics
from spgemm_tpu.obs import profile as jax_profile
from spgemm_tpu.obs import trace as jax_trace
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.obs import events, metrics, profile, trace
from spgemm_tpu_torch.ops import _build, delta, plancache
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.utils import native
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import banded_block_sparse
from spgemm_tpu_torch.utils.timers import ENGINE, PhaseTimers

ACCOUNT_KEYS = ("enabled", "memory", "estimator", "delta", "events")  # report() minus builds


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("SPGEMM_TPU_OBS_TRACE", "SPGEMM_TPU_OBS_EVENTS", "SPGEMM_TPU_DELTA",
                 "SPGEMM_TPU_PLAN_ESTIMATE", "SPGEMM_TPU_EST_SAMPLE_ROWS",
                 "SPGEMM_TPU_EST_CONFIDENCE"):
        monkeypatch.delenv(name, raising=False)
    for mod in (profile, jax_profile, delta, plancache):
        mod.clear()
    for log in (events.LOG, jax_events.LOG):
        log.clear()
    for rec in (trace.RECORDER, jax_trace.RECORDER):
        rec.clear()
    yield
    for mod in (profile, jax_profile, delta, plancache):
        mod.clear()
    for log in (events.LOG, jax_events.LOG):
        log.clear()


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def test_the_buckets_are_the_jax_packages():
    for name in ("COMPILE_BUCKETS", "REL_ERR_BUCKETS", "FRACTION_BUCKETS", "PHASE_BUCKETS",
                 "COMPILE_RETAIN", "MEM_JOB_RETAIN"):
        assert getattr(profile, name) == getattr(jax_profile, name), name


# --------------------------------------------------- the same sequences --
SHARED_PHASES = sorted(set(metrics.ENGINE_PHASES) & set(jax_metrics.ENGINE_PHASES))


def _sequence(seed: int) -> list:
    """A mixed stream of account observations: estimates, delta multiplies,
    phase durations (shared names and one undeclared), memory readings
    with and without a job tag, job windows opened."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(300):
        kind = int(rng.integers(5))
        if kind == 0:
            actual = rng.integers(0, 5000, 3)
            est = actual * rng.lognormal(0.0, 0.4, 3)
            ops.append(("estimate", *map(float, est), *map(int, actual)))
        elif kind == 1:
            total = int(rng.integers(0, 400))
            pred = int(rng.integers(0, total + 1))
            ops.append(("delta", pred, total if rng.random() < 0.1 else pred, total))
        elif kind == 2:
            name = SHARED_PHASES[int(rng.integers(len(SHARED_PHASES)))] \
                if rng.random() < 0.9 else "driver_local_phase"
            ops.append(("phase", name, float(rng.exponential(0.05))))
        elif kind == 3:
            job = f"job-{int(rng.integers(80))}" if rng.random() < 0.8 else None
            in_use = int(rng.integers(0, 1 << 34))
            stats = {"bytes_in_use": in_use}
            if rng.random() < 0.7:
                stats["peak_bytes_in_use"] = in_use + int(rng.integers(0, 1 << 30))
            ops.append(("memory", job, stats if rng.random() < 0.95 else None))
        else:
            ops.append(("begin", f"job-{int(rng.integers(80))}"))
    return ops


def _feed(mod, recorder, ops) -> None:
    for op in ops:
        if op[0] == "estimate":
            mod.observe_estimate(*op[1:])
        elif op[0] == "delta":
            mod.observe_delta(*op[1:])
        elif op[0] == "phase":
            mod.observe_phase(op[1], op[2])
        elif op[0] == "memory":
            with recorder.tagged(job_id=op[1]):
                mod.observe_memory(op[2])
        else:
            mod.memory_job_begin(op[1])


def _accounts(mod, metrics_mod) -> dict:
    rep = mod.report()
    return {"report": {k: rep[k] for k in ACCOUNT_KEYS},
            "stats": (mod.est_stats(), mod.delta_stats(), mod.phase_stats(),
                      mod.memory_stats()),
            "summary": mod.summary(),
            "windows": [mod.memory_job_peak(f"job-{i}") for i in range(80)],
            "text": metrics_mod.render(metrics_mod._collect_profile())}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_same_sequences_give_the_jax_accounts(seed):
    ops = _sequence(seed)
    _feed(profile, trace.RECORDER, ops)
    _feed(jax_profile, jax_trace.RECORDER, ops)
    ours, theirs = _accounts(profile, metrics), _accounts(jax_profile, jax_metrics)
    assert ours == theirs
    assert ours["stats"][0]["count"] > 0 and ours["stats"][1]["mispredictions"] > 0
    assert ours["stats"][3]["available"] and any(w is not None for w in ours["windows"])
    assert "driver_local_phase" not in ours["stats"][2]


def test_a_late_sample_stays_in_its_own_jobs_window():
    """A wedged executor's late reading, tagged with its old job, moves
    that job's window and not the replacement's, in both packages."""
    for mod, rec in ((profile, trace.RECORDER), (jax_profile, jax_trace.RECORDER)):
        mod.observe_memory({"bytes_in_use": 100, "peak_bytes_in_use": 120})
        mod.memory_job_begin("job-b")
        with rec.tagged(job_id="job-b"):
            mod.observe_memory({"bytes_in_use": 500, "peak_bytes_in_use": 600})
        with rec.tagged(job_id="job-a"):
            mod.observe_memory({"bytes_in_use": 9000})
        assert (mod.memory_job_peak("job-b"), mod.memory_job_peak("job-a")) == (500, 9000)
    assert profile.memory_stats() == jax_profile.memory_stats()


def test_a_build_record_renders_as_the_jax_compile_record():
    """record_build lands through record_compile's path: the per-site
    aggregates and the spgemm_compile* families equal the JAX package's
    for a record of the same wall with no cost analysis."""
    for site, wall in (("numeric_round", 0.031), ("native", 2.5), ("numeric_round", 0.002)):
        profile.record_build(site, wall, True, f"lib{site}-0123.so", None)
        jax_profile.record_compile(site, wall, f"lib{site}-0123.so", {}, {})
    assert profile.compile_stats() == jax_profile.compile_stats()
    assert profile.summary() == jax_profile.summary()

    def families(text):
        return [ln for ln in text.splitlines() if "spgemm_compile" in ln]

    assert families(metrics.render(metrics._collect_profile())) == \
        families(jax_metrics.render(jax_metrics._collect_profile()))
    rec = profile.report()["compiles"][0]
    assert {k: rec[k] for k in ("site", "wall_s", "built", "ptxas", "flops", "bytes_accessed",
                                "argument_bytes", "output_bytes", "temp_bytes",
                                "code_bytes")} == {
        "site": "numeric_round", "wall_s": 0.031, "built": True, "ptxas": None, "flops": 0.0,
        "bytes_accessed": 0.0, "argument_bytes": 0, "output_bytes": 0, "temp_bytes": 0,
        "code_bytes": 0}
    assert [e["site"] for e in events.LOG.tail(10) if e["kind"] == "compile"] == \
        ["numeric_round", "native", "numeric_round"]


# ------------------------------------------------------------ the builds --
def test_a_build_record_lands_for_native(monkeypatch):
    monkeypatch.setattr(native, "_libs", {})  # this process's first load again
    before = ENGINE.counter_snapshot().get("compiles", 0)
    native.lib()
    native.lib()  # loaded: no second record
    (rec,) = profile.report()["compiles"]
    assert rec["site"] == "native" and isinstance(rec["built"], bool) and rec["wall_s"] > 0
    assert rec["signature"] == repr(native.build().name) and rec["ptxas"] is None
    assert profile.compile_stats()["native"]["count"] == 1
    assert ENGINE.counter_snapshot()["compiles"] == before + 1
    (ev,) = [e for e in events.LOG.tail(10) if e["kind"] == "compile"]
    assert ev["site"] == "native" and ev["built"] == rec["built"]


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z21numeric_round_kernelILb0EEvPKlS1_' for 'sm_90a'
ptxas info    : Function properties for _Z21numeric_round_kernelILb0EEvPKlS1_
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 16384 bytes smem
ptxas info    : Compiling entry function '_Z21numeric_round_kernelILb1EEvPKlS1_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
"""


def test_a_kernel_librarys_first_load_records_its_ptxas_report(tmp_path, monkeypatch):
    """A kernel library (here the host library under a kernel's name, with
    a ptxas report beside it: no nvcc on the CPU) records the wall, whether
    nvcc ran, and each kernel's registers, spills and shared bytes."""
    lib = tmp_path / "libnumeric_round-feedface.so"
    shutil.copy(native.build(), lib)
    lib.with_suffix(".log").write_text(PTXAS_LOG)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_build", lambda name: (lib, False))
    _build.load("numeric_round")
    _build.load("numeric_round")
    (rec,) = profile.report()["compiles"]
    assert (rec["site"], rec["built"], rec["signature"]) == \
        ("numeric_round", False, repr(lib.name))
    assert rec["ptxas"] == {
        "_Z21numeric_round_kernelILb0EEvPKlS1_": {"registers": 168, "spill_stores": 8,
                                                  "spill_loads": 4, "smem_bytes": 16384},
        "_Z21numeric_round_kernelILb1EEvPKlS1_": {"registers": 96, "spill_stores": 0,
                                                  "spill_loads": 0, "smem_bytes": 0}}


def test_a_failed_build_raises_and_records_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")  # no cached library
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("numeric_round")
    src = tmp_path / "native_src"
    shutil.copytree(native.SRC_DIR, src)
    (src / "smmio.cpp").write_text("#error deliberately broken\n")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="deliberately broken"):
        native.lib()
    assert profile.report()["compiles"] == [] and profile.compile_stats() == {}
    assert not [e for e in events.LOG.tail(10) if e["kind"] == "compile"]


# ------------------------------------------------------------- the phases --
def test_the_recorder_feeds_only_the_ports_declared_phases(monkeypatch):
    with ENGINE.phase("upload"):  # the port's own phase name
        pass
    ENGINE.record("plan", 0.005)
    ENGINE.record("plan", 2.0)
    PhaseTimers().record("driver_local_load", 0.5)  # an ad-hoc name: a span only
    stats = profile.phase_stats()
    assert set(stats) == {"plan", "upload"}
    assert stats["plan"]["count"] == 2 and stats["plan"]["buckets"][0.01] == 1
    assert 'spgemm_phase_seconds_count{phase="plan"} 2' in \
        metrics.render(metrics.collect_engine())
    monkeypatch.setenv("SPGEMM_TPU_OBS_TRACE", "0")
    ENGINE.record("plan", 1.0)
    assert profile.phase_stats()["plan"]["count"] == 2


def test_the_master_knob_zero_makes_the_accounts_inert(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_OBS_TRACE", "0")
    profile.record_build("native", 1.0, True, "lib", None)
    profile.observe_memory({"bytes_in_use": 100})
    profile.observe_estimate(1, 1, 1, 2, 2, 2)
    profile.observe_delta(1, 1, 2)
    rep = profile.report()
    assert rep["enabled"] is False and rep["compiles"] == [] and rep["compile_sites"] == {}
    assert rep["memory"]["samples"] == 0 and rep["estimator"]["count"] == 0
    assert rep["delta"]["count"] == 0
    json.dumps(rep)
    json.dumps(profile.summary())


# ---------------------------------------------------- the engine's pushes --
def _estimator_chain(seed: int = 7) -> list:
    """The obs smoke's chain: banded, 64 tile rows (past the estimator's
    48-row sample budget), k 4."""
    rng = np.random.default_rng(seed)
    return [banded_block_sparse(64, 4, 1, rng, "full") for _ in range(4)]


def test_a_chain_with_the_estimator_scores_as_many_plans_as_the_jax_chain(monkeypatch):
    from spgemm_tpu.chain import chain_product as jax_chain_product
    from spgemm_tpu.ops import plancache as jax_plancache
    from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxBSM

    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "1")  # the port's default is off
    jax_plancache.clear()
    ENGINE.reset()
    mats = _estimator_chain()
    got = _quiet(chain_product, mats, device="cpu")
    want = _quiet(jax_chain_product, [JaxBSM(rows=m.rows, cols=m.cols, k=m.k,
                                             coords=m.coords.copy(), tiles=m.tiles.copy())
                                      for m in mats], backend="xla")
    jax_plancache.clear()
    assert got == BlockSparseMatrix.from_reference(want)
    # every estimated plan of the port's chain landed and was scored once
    assert profile.est_stats()["count"] == ENGINE.counter_snapshot()["est_hits"] > 0
    assert profile.est_stats() == jax_profile.est_stats()
    assert 'spgemm_est_rel_error_count{quantity="keys"}' in \
        metrics.render(metrics.collect_engine())


def _edit(m: BlockSparseMatrix, rows) -> BlockSparseMatrix:
    tiles = m.tiles.copy()
    tiles[np.isin(m.coords[:, 0], np.asarray(list(rows), np.int64))] ^= \
        np.uint64(0x9E3779B97F4A7C15)
    return BlockSparseMatrix(rows=m.rows, cols=m.cols, k=m.k, coords=m.coords, tiles=tiles)


def test_the_delta_account_counts_the_edits_dirty_rows(monkeypatch):
    """A then B edited in some tile rows, then A edited: the dirty rows
    each multiply predicts are the output rows the edit reaches, counted
    here from the coordinates (an A row is dirty where it was edited; a B
    edit dirties every A row holding a tile in an edited column)."""
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "1")
    rng = np.random.default_rng(11)
    a, b = (banded_block_sparse(40, 2, 2, rng) for _ in range(2))
    out_rows = np.unique(a.coords[np.isin(a.coords[:, 1], b.coords[:, 0]), 0])
    a_rows, b_rows = [3, 4, 17], [9, 30]
    a2, b2 = _edit(a, a_rows), _edit(b, b_rows)
    reach_b = np.unique(a.coords[np.isin(a.coords[:, 1], b_rows), 0])
    want_dirty = [len(out_rows), 0, len(np.intersect1d(out_rows, reach_b)),
                  len(np.intersect1d(out_rows, np.union1d(a_rows, reach_b)))]
    steps = [(a, b), (a, b), (a, b2), (a2, b)]
    for x, y in steps:
        p = engine.plan(*(DeviceBlockMatrix.from_host(m, "cpu") for m in (x, y)))
        engine.spgemm_device(x, y, device="cpu", plan=p)
    hist = jax_profile.Hist(jax_profile.FRACTION_BUCKETS)
    for n in want_dirty:
        hist.observe_locked(min(1.0, n / len(out_rows)))
    assert profile.delta_stats() == {"count": 4, "predicted_rows": sum(want_dirty),
                                     "executed_rows": sum(want_dirty), "mispredictions": 0,
                                     "dirty_fraction": hist.snapshot_locked()}
    assert "spgemm_delta_mispredictions_total 0" in metrics.render(metrics.collect_engine())


def test_the_memory_gauges_are_omitted_on_the_cpu(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "1")
    _quiet(chain_product, _estimator_chain(3)[:3], device="cpu")
    mem = profile.memory_stats()
    assert mem["available"] is False and mem["samples"] == 0
    profile.memory_job_begin("job-x")  # a no-op while the device never reported
    assert profile.memory_job_peak("job-x") is None and profile.memory_job_peak(None) is None
    text = metrics.render(metrics.collect_engine())
    assert "spgemm_hbm_bytes_in_use" not in text and "spgemm_hbm_peak_bytes" not in text
    assert "spgemm_hbm_samples_total 0" in text
    assert profile.summary()["hbm_peak_bytes"] is None


def test_the_cards_reading_is_the_allocators_without_a_sync(monkeypatch):
    """On a card the sample is the allocator's allocated bytes now and at
    peak (what torch.cuda.memory_allocated and max_memory_allocated return)
    on the multiply's device, read in one stats call without a sync, into
    the window of the thread's job tag."""
    def no_sync(*a, **kw):
        raise AssertionError("the memory sample synchronized the card")

    seen = []

    def nested(dev):
        seen.append(dev)
        return {"allocated_bytes": {"all": {"current": 900_000_000, "peak": 1_300_000_000,
                                            "allocated": 5, "freed": 4}},
                "reserved_bytes": {"all": {"current": 2_000_000_000}}}

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", nested)
    with trace.RECORDER.tagged(job_id="job-9"):
        engine._observe_memory("cuda:0")
    assert seen == [torch.device("cuda:0")]
    assert profile.memory_stats() == {"available": True, "samples": 1,
                                      "bytes_in_use": 900_000_000,
                                      "peak_bytes": 1_300_000_000}
    assert profile.memory_job_peak("job-9") == 900_000_000
    engine._observe_memory("cpu")  # the CPU: nothing
    assert profile.memory_stats()["samples"] == 1


def test_concurrent_observations_lose_nothing():
    """More threads than cores feed the phase, delta and memory accounts at
    once, with a short switch interval: every observation is counted."""
    import sys
    import threading

    n_threads, per = 16, 300

    def work(t):
        with trace.RECORDER.tagged(job_id=f"job-{t}"):
            for i in range(per):
                profile.observe_phase("plan", 0.001)
                profile.observe_delta(i % 5, i % 5, 10)
                profile.observe_memory({"bytes_in_use": t * 1000 + i})

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    total = n_threads * per
    assert profile.phase_stats()["plan"]["count"] == total
    dlt = profile.delta_stats()
    assert (dlt["count"], dlt["predicted_rows"], dlt["mispredictions"]) == \
        (total, n_threads * sum(i % 5 for i in range(per)), 0)
    assert profile.memory_stats()["samples"] == total
    assert [profile.memory_job_peak(f"job-{t}") for t in range(n_threads)] == \
        [t * 1000 + per - 1 for t in range(n_threads)]
