"""The port's autotuner (spgemm_tpu_torch/tune) on the CPU: trial planning,
preemption, canary rollout and revert backoff, the warm store's tune tier
across a restart, estimator adaptation and the SPGEMM_TPU_TUNE=0 A/B (the
counterparts of tests/test_tune.py); the port daemon on device="cpu" running
idle trial legs, the tuned canary after a promotion and a restart; and
parity with the JAX package: the Tuner's rows through one script, the class
key, knob resolution env > tuned > default, a chain under each trial vector
(SPGEMM_TPU_DELTA=0, the oracle deciding ties) and a JAX-written tune entry
as a counted miss.  Inputs from numpy seeds at small sizes.  Tolerance:
exact everywhere."""

import os
import threading
import time

import numpy as np
import pytest

from spgemm_tpu.chain import chain_product as jax_chain_product
from spgemm_tpu.ops import plancache as jax_plancache
from spgemm_tpu.ops import warmstore as jax_warmstore
from spgemm_tpu.tune import tuner as jax_tuner
from spgemm_tpu.utils import knobs as jax_knobs
from spgemm_tpu.utils.gen import random_chain as jax_random_chain
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.obs import events
from spgemm_tpu_torch.obs import profile as obs_profile
from spgemm_tpu_torch.ops import delta, plancache, warmstore
from spgemm_tpu_torch.serve import client, placement
from spgemm_tpu_torch.serve.daemon import Daemon
from spgemm_tpu_torch.serve.queue import Job
from spgemm_tpu_torch.tune import tuner as tune_mod
from spgemm_tpu_torch.tune.tuner import (BACKOFF0_S, TUNER, TrialPreempted, Tuner,
                                         run_trial_leg, trial_vectors)
from spgemm_tpu_torch.utils import failpoints, io_text, knobs
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import random_chain
from spgemm_tpu_torch.utils.semantics import chain_oracle
from spgemm_tpu_torch.utils.timers import ENGINE

_ENV = ("SPGEMM_TPU_TUNE", "SPGEMM_TPU_TUNE_TRIAL_S", "SPGEMM_TPU_TUNE_MIN_WIN",
        "SPGEMM_TPU_ACCUM_ROUTE", "SPGEMM_TPU_PLAN_AHEAD", "SPGEMM_TPU_FAILPOINTS",
        "SPGEMM_TPU_WARM_DIR", "SPGEMM_TPU_SERVE_SLICES", "SPGEMM_TPU_SERVE_ADDR",
        "SPGEMM_TPU_DELTA", "SPGEMM_TPU_SERVE_BATCH_WINDOW_S")


def _reset():
    for t in (TUNER, jax_tuner.TUNER):
        t.clear()
        t.persist_with(None)
    knobs.clear_tuned()
    jax_knobs.clear_tuned()
    for mod in (placement, delta, plancache, failpoints, obs_profile):
        mod.clear()
    warmstore.reset()
    jax_warmstore.reset()
    ENGINE.reset()
    events.LOG.clear()


@pytest.fixture(autouse=True)
def _fresh_tune_state(monkeypatch):
    """The tuner singletons, the process-wide overlays, the books, ENGINE
    and the profiling accounts outlive a test (a pickup swaps the overlay, a
    leg accumulates the tune_trial phase): each test starts untuned."""
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    _reset()
    yield
    _reset()


@pytest.fixture
def make_daemon(tmp_path):
    daemons = []

    def _make(idx=0, **kw):
        kw.setdefault("device", "cpu")
        d = Daemon(str(tmp_path / f"d{idx}.sock"), **kw)
        d.start()
        daemons.append(d)
        return d

    yield _make
    for d in daemons:
        d.stop()


def _mats(n=3, k=2, seed=7):
    return random_chain(n, 4, k, 0.5, np.random.default_rng(seed), "full")


def _chain_folder(tmp_path, n=3, k=2, seed=7, name="tune_in"):
    mats = _mats(n, k, seed)
    folder = str(tmp_path / name)
    io_text.write_chain_dir(folder, mats, k)
    return folder


def _oracle_bytes(folder) -> bytes:
    n, k = io_text.read_size(folder)
    mats = io_text.read_chain(folder, 0, n - 1, k)
    blocks = chain_oracle([m.to_dict() for m in mats], k)
    return io_text.format_matrix(
        BlockSparseMatrix.from_dict(mats[0].rows, mats[-1].cols, k, blocks).prune_zeros())


def _drive_trials(t: Tuner, ck: str, folder: str, winner: dict, base_s: float = 1.0,
                  best_s: float = 0.5) -> None:
    """Walk the class through its whole trial plan with made-up walls: the
    baseline base_s, `winner` best_s, every other candidate slightly slower
    than the baseline; every digest equal."""
    t.note_job(ck, "cpu")
    while True:
        leg = t.next_leg(lambda key: folder)
        if leg is None:
            break
        key, _fld, vec = leg
        secs = base_s if not vec else (best_s if vec == winner else base_s * 1.01)
        t.record_leg(key, vec, secs, "digest-0")


def _wait_until(pred, timeout=60.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _run(d, folder, out, **options):
    j = client.submit(folder, d.socket_path, {"output": out, **options})
    return client.wait(j["id"], d.socket_path, timeout=120)["job"]


# ------------------------------------------------------------------ planning --
def test_trial_vectors_shape(monkeypatch):
    legs = trial_vectors()
    assert legs[0] == {}  # the baseline first, always
    names = {k for leg in legs for k in leg}
    # the port's search set, and exactly the registry's searched knobs
    assert names == {"SPGEMM_TPU_ACCUM_ROUTE", "SPGEMM_TPU_PLAN_AHEAD"}
    assert names == {kb.name for kb in knobs.REGISTRY.values() if kb.tuned}
    assert all(len(leg) <= 1 for leg in legs)  # one-knob deviations only
    assert legs[1:] == [{"SPGEMM_TPU_ACCUM_ROUTE": "ladder"},
                        {"SPGEMM_TPU_ACCUM_ROUTE": "dense"}, {"SPGEMM_TPU_PLAN_AHEAD": "0"}]
    # deviations from the base: an exported base moves them
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", "dense")
    monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", "0")
    assert trial_vectors()[1:] == [{"SPGEMM_TPU_ACCUM_ROUTE": "auto"},
                                   {"SPGEMM_TPU_ACCUM_ROUTE": "ladder"},
                                   {"SPGEMM_TPU_PLAN_AHEAD": "2"}]


def test_promotion_needs_min_win():
    t = Tuner()
    _drive_trials(t, "ck@cpu", "/nonexistent-ok", winner={}, base_s=1.0)
    st = t.stats()["classes"][0]
    # no candidate beat the baseline: the class settles untuned
    assert st["state"] == "settled" and st["knobs"] == {}
    assert t.overlay_for("ck@cpu") == {}


def test_promotion_and_canary_lifecycle():
    t = Tuner()
    winner = {"SPGEMM_TPU_ACCUM_ROUTE": "dense"}
    _drive_trials(t, "ck@cpu", "/nonexistent-ok", winner=winner)
    st = t.stats()["classes"][0]
    assert st["state"] == "canary" and st["knobs"] == winner
    assert st["win"] == pytest.approx(2.0)
    assert t.overlay_for("ck@cpu") == winner
    assert t.consume_canary("ck@cpu") is True
    assert t.consume_canary("ck@cpu") is False  # consumed exactly once
    t.note_terminal("ck@cpu", ok=True)
    assert t.stats()["classes"][0]["state"] == "live"
    assert t.overlay_for("ck@cpu") == winner


def test_canary_failure_reverts_and_backs_off():
    t = Tuner()
    winner = {"SPGEMM_TPU_PLAN_AHEAD": "0"}
    _drive_trials(t, "ck@cpu", "/nonexistent-ok", winner=winner)
    assert t.consume_canary("ck@cpu") is True
    t.note_terminal("ck@cpu", ok=False)
    st = t.stats()["classes"][0]
    assert st["state"] == "reverted" and st["backoff_s"] == BACKOFF0_S
    assert t.overlay_for("ck@cpu") == {}
    assert t.stats()["reverts"] == 1
    assert t.next_leg(lambda key: "/x") is None  # parked until the backoff runs out
    with t._lock:
        t._classes["ck@cpu"].retry_at = time.monotonic() - 1
    _drive_trials(t, "ck@cpu", "/nonexistent-ok", winner=winner)
    assert t.consume_canary("ck@cpu") is True
    t.note_terminal("ck@cpu", ok=False)
    assert t.stats()["classes"][0]["backoff_s"] == 2 * BACKOFF0_S  # doubled


def test_parity_mismatch_parks_the_class():
    t = Tuner()
    t.note_job("ck@cpu", "cpu")
    assert t.next_leg(lambda key: "/x")[2] == {}
    t.record_leg("ck@cpu", {}, 1.0, "digest-base")
    key, _f, vec = t.next_leg(lambda key: "/x")
    t.record_leg(key, vec, 0.1, "digest-DIFFERENT")
    st = t.stats()["classes"][0]
    # a candidate that changed the bits is an engine bug: never promoted
    assert st["state"] == "reverted" and st["knobs"] == {}
    assert t.stats()["reverts"] == 1


# ---------------------------------------------------------------- preemption --
def test_preempted_leg_is_discarded_and_retried():
    t = Tuner()
    t.note_job("ck@cpu", "cpu")

    def preempting_run(folder):
        raise TrialPreempted(folder)

    assert run_trial_leg(preempting_run, lambda key: "/x", tuner=t) is True
    assert knobs.tuned_overlay() == {}  # restored
    assert t.next_leg(lambda key: "/x")[2] == {}  # the baseline is still owed
    assert run_trial_leg(lambda folder: "d0", lambda key: "/x", tuner=t) is True
    assert t.next_leg(lambda key: "/x")[2] != {}  # the baseline landed
    kinds = [e["kind"] for e in events.LOG.tail(10)]
    assert kinds == ["tune_trial_preempted", "tune_trial"]


def test_trial_failpoint_aborts_leg_without_side_effects(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "tune.trial:1")
    t = Tuner()
    t.note_job("ck@cpu", "cpu")
    ran = []
    assert run_trial_leg(lambda folder: ran.append(folder) or "d0", lambda key: "/x",
                         tuner=t) is True
    assert ran == []  # aborted before the leg ran anything
    assert knobs.tuned_overlay() == {}
    assert t.next_leg(lambda key: "/x")[2] == {}
    assert t.stats()["classes"][0]["state"] == "trialing"
    assert failpoints.triggered() == {"tune.trial": 1}


def test_a_leg_skewed_by_an_overlay_swap_is_discarded():
    """Another activation swapping the overlay mid-measurement (the
    generation moved) discards the leg: its wall measured a mixture."""
    t = Tuner()
    t.note_job("ck@cpu", "cpu")

    def swapping_run(folder):
        knobs.set_tuned({**knobs.tuned_overlay(), "SPGEMM_TPU_PLAN_AHEAD": "1"})
        return "d0"

    assert run_trial_leg(swapping_run, lambda key: "/x", tuner=t) is True
    assert t.next_leg(lambda key: "/x")[2] == {}
    assert events.LOG.tail(1)[0]["reason"] == "overlay-swapped"


def test_a_leg_runs_under_its_vector_and_extra_pin():
    """The candidate vector and the extra pins are live inside run_fn (the
    planner thread reads the same process-wide overlay), and the earlier
    overlay is back after it."""
    knobs.set_tuned({"SPGEMM_TPU_EST_SAMPLE_ROWS": "24"})
    t = Tuner()
    t.note_job("ck@cpu", "cpu")
    seen = []

    def run(folder):
        seen.append((knobs.get("SPGEMM_TPU_ACCUM_ROUTE"), knobs.get("SPGEMM_TPU_DELTA"),
                     knobs.get("SPGEMM_TPU_EST_SAMPLE_ROWS"), knobs.source("SPGEMM_TPU_DELTA")))
        return "d0"

    for _ in trial_vectors():
        run_trial_leg(run, lambda key: "/x", tuner=t, extra={"SPGEMM_TPU_DELTA": "0"})
    assert seen[0] == ("auto", False, 24, "tuned")
    assert [s[0] for s in seen] == ["auto", "ladder", "dense", "auto"]
    assert knobs.tuned_overlay() == {"SPGEMM_TPU_EST_SAMPLE_ROWS": "24"}


def test_daemon_beat_preempts_within_one_heartbeat(tmp_path):
    """The daemon's trial runner yields the device once a real job is
    queued: the heartbeat before the read and between multiplies raises
    TrialPreempted."""
    d = Daemon(str(tmp_path / "t.sock"), journal=False, device="cpu")  # never started
    sl = d.slices[0]
    run = d._tune_run_fn(sl, sl.gen)
    folder = _chain_folder(tmp_path)
    assert run(folder) == run(folder)  # a deterministic digest
    d.queue.submit(Job("job-t1", folder, str(tmp_path / "out"), {}))
    t0 = time.perf_counter()
    with pytest.raises(TrialPreempted):
        run(folder)
    assert time.perf_counter() - t0 < 1.0


def test_a_job_queued_mid_leg_preempts_it_between_multiplies(tmp_path, monkeypatch):
    """A job submitted while a leg is inside its chain stops the leg at the
    next multiply boundary, before the chain's end."""
    d = Daemon(str(tmp_path / "t.sock"), journal=False, device="cpu")
    sl = d.slices[0]
    folder = _chain_folder(tmp_path, n=6)
    from spgemm_tpu_torch import chain as chain_mod

    real = chain_mod.chain_product
    multiplies = []

    def counting_chain(mats, **kw):
        beat = kw.pop("heartbeat")

        def hb():
            multiplies.append(1)
            if len(multiplies) == 1:  # a job lands during the first multiply
                d.queue.submit(Job("job-x", folder, str(tmp_path / "o"), {}))
            beat()

        return real(mats, heartbeat=hb, **kw)

    monkeypatch.setattr(chain_mod, "chain_product", counting_chain)
    with pytest.raises(TrialPreempted):
        d._tune_run_fn(sl, sl.gen)(folder)
    assert multiplies == [1]  # of 5 multiplies


def test_maybe_tune_never_runs_while_pool_busy(tmp_path, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_TUNE_TRIAL_S", "0.01")
    d = Daemon(str(tmp_path / "t.sock"), journal=False, device="cpu")
    sl = d.slices[0]
    folder = _chain_folder(tmp_path)
    TUNER.note_job("ck@cpu", "cpu")
    placement.note_class("ck@cpu", folder)
    sl.current = Job("job-b", folder, str(tmp_path / "o"), {})  # a job mid-execute
    before = TUNER.stats()["trials"]
    d._maybe_tune(sl, sl.gen)
    assert TUNER.stats()["trials"] == before
    sl.current = None
    sl.canary = True  # an auditioning slice runs no trial either
    d._maybe_tune(sl, sl.gen)
    assert TUNER.stats()["trials"] == before
    sl.canary = False
    d._maybe_tune(sl, sl.gen)
    assert TUNER.stats()["trials"] == before + 1


# ------------------------------------------------------------ warm store tier --
def test_override_roundtrips_warm_store_across_restart(monkeypatch, tmp_path):
    monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", str(tmp_path))
    t = Tuner()
    t.persist_with(warmstore.save_tune)
    winner = {"SPGEMM_TPU_ACCUM_ROUTE": "dense"}
    _drive_trials(t, "ck@cpu", "/x", winner=winner)
    t.consume_canary("ck@cpu")
    t.note_terminal("ck@cpu", ok=True)  # live, persisted
    assert any(n.startswith("tune-") for n in os.listdir(tmp_path))
    assert warmstore.stats()["tunes"] == 1 and warmstore.scan(str(tmp_path))["tunes"] == 1
    warmstore.reset()
    t2 = Tuner()
    assert t2.load(warmstore.load_tunes()) == 1
    assert t2.overlay_for("ck@cpu") == winner
    assert t2.stats()["classes"][0]["state"] == "live"


def test_canary_record_reauditions_after_restart(monkeypatch, tmp_path):
    monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", str(tmp_path))
    t = Tuner()
    t.persist_with(warmstore.save_tune)
    _drive_trials(t, "ck@cpu", "/x", winner={"SPGEMM_TPU_ACCUM_ROUTE": "dense"})
    warmstore.reset()
    t2 = Tuner()
    assert t2.load(warmstore.load_tunes()) == 1
    assert t2.stats()["classes"][0]["state"] == "canary"
    assert t2.consume_canary("ck@cpu") is True


def test_knob_vector_skewed_override_is_counted_cold_fallback(monkeypatch, tmp_path):
    """A record persisted under another base of the searched knobs (an
    exported SPGEMM_TPU_ACCUM_ROUTE that changed) is refused: counted,
    removed, never adopted."""
    monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", str(tmp_path))
    t = Tuner()
    t.persist_with(warmstore.save_tune)
    _drive_trials(t, "ck@cpu", "/x", winner={"SPGEMM_TPU_PLAN_AHEAD": "0"})
    assert any(n.startswith("tune-") for n in os.listdir(tmp_path))
    warmstore.reset()
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", "ladder")  # the base moved
    assert warmstore.load_tunes() == {}
    assert warmstore.stats()["corrupt"] == 1 and ENGINE.counters["warm_corrupt"] == 1
    assert not any(n.startswith("tune-") for n in os.listdir(tmp_path))


def test_an_overlay_leaves_the_tune_signature_alone(monkeypatch, tmp_path):
    """The signature is the base vector: a live overlay (a class's tuned
    route) does not turn the class's own record into a mismatch."""
    monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", str(tmp_path))
    warmstore.save_tune("ck@cpu", {"state": "live", "knobs": {"SPGEMM_TPU_ACCUM_ROUTE": "dense"}})
    knobs.set_tuned({"SPGEMM_TPU_ACCUM_ROUTE": "dense"})
    warmstore.reset()
    assert list(warmstore.load_tunes()) == ["ck@cpu"]


def test_clear_tunes_leaves_plans(monkeypatch, tmp_path):
    monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", str(tmp_path))
    t = Tuner()
    t.persist_with(warmstore.save_tune)
    _drive_trials(t, "ck@cpu", "/x", winner={"SPGEMM_TPU_ACCUM_ROUTE": "dense"})
    (tmp_path / "plan-deadbeef.npz").write_bytes(b"not-a-real-plan")
    warmstore.reset()
    assert warmstore.clear_tunes(str(tmp_path)) == 1
    names = os.listdir(tmp_path)
    assert not any(n.startswith("tune-") for n in names)
    assert "plan-deadbeef.npz" in names  # the plan tier is untouched


def test_scan_and_clone_carry_the_tune_tier(monkeypatch, tmp_path):
    """scan_tunes reads any directory without binding it, and a clone copies
    tune entries as it copies plans."""
    src, dst = tmp_path / "src", tmp_path / "dst"
    monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", str(src))
    warmstore.save_tune("ck@cpu", {"state": "live", "knobs": {"SPGEMM_TPU_PLAN_AHEAD": "0"}})
    warmstore.reset()
    monkeypatch.delenv("SPGEMM_TPU_WARM_DIR")
    assert warmstore.scan_tunes(str(src))["ck@cpu"]["state"] == "live"
    assert warmstore.clone(str(src), str(dst)) == {"copied": 1, "skipped": 0,
                                                   "skip_reasons": {}}
    assert warmstore.scan_tunes(str(dst)) == warmstore.scan_tunes(str(src))


def test_a_jax_written_tune_entry_is_a_counted_miss(monkeypatch, tmp_path):
    monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", str(tmp_path))
    assert jax_warmstore.configure(str(tmp_path))
    assert jax_warmstore.save_tune("ck@cpu", {"state": "live",
                                              "knobs": {"SPGEMM_TPU_ACCUM_ROUTE": "dense"}})
    jax_warmstore.reset()
    assert warmstore.scan_tunes(str(tmp_path))  # readable as a record
    assert warmstore.load_tunes() == {}  # never adopted
    assert warmstore.stats()["corrupt"] == 1


# ------------------------------------------------------- estimator adaptation --
def test_est_adaptation_tight_class_shrinks_sample_budget():
    t = Tuner()
    t.note_job("ck@cpu", "cpu")
    for _ in range(tune_mod.EST_MIN_JOBS):
        t.note_est_accuracy("ck@cpu", 0.01)
    assert t.overlay_for("ck@cpu")["SPGEMM_TPU_EST_SAMPLE_ROWS"] == "24"  # 48 halved
    for _ in range(10 * tune_mod.EST_MIN_JOBS):
        t.note_est_accuracy("ck@cpu", 0.01)
    assert int(t.overlay_for("ck@cpu")["SPGEMM_TPU_EST_SAMPLE_ROWS"]) == tune_mod.EST_ROWS_FLOOR


def test_est_adaptation_misfiring_class_raises_confidence():
    t = Tuner()
    t.note_job("ck@cpu", "cpu")
    for _ in range(tune_mod.EST_MIN_JOBS):
        t.note_est_accuracy("ck@cpu", 0.9)
    assert float(t.overlay_for("ck@cpu")["SPGEMM_TPU_EST_CONFIDENCE"]) == pytest.approx(0.7)
    for _ in range(10 * tune_mod.EST_MIN_JOBS):
        t.note_est_accuracy("ck@cpu", 0.9)
    assert float(t.overlay_for("ck@cpu")["SPGEMM_TPU_EST_CONFIDENCE"]) == 1.0


# ---------------------------------------------------------------- TUNE=0 A/B --
def test_tune_off_is_inert_everywhere(monkeypatch, tmp_path):
    monkeypatch.setenv("SPGEMM_TPU_TUNE", "0")
    t = Tuner()
    t.note_job("ck@cpu", "cpu")  # gated: no class is even created
    assert t.stats()["classes"] == []
    assert t.overlay_for("ck@cpu") == {}
    assert t.consume_canary("ck@cpu") is False
    assert run_trial_leg(lambda folder: "d0", lambda key: "/x", tuner=t) is False
    d = Daemon(str(tmp_path / "t.sock"), journal=False, device="cpu")
    d.start()
    try:
        scrape = d._op_metrics()["text"]
        assert "spgemm_tune" not in scrape
        assert "tune_trial" not in scrape and "tune_apply" not in scrape
        assert d._op_stats()["tune"]["enabled"] is False
    finally:
        d.stop()


def test_tune_off_daemon_runs_jobs_untuned(monkeypatch, tmp_path, make_daemon):
    """SPGEMM_TPU_TUNE=0 with trials armed: jobs give the oracle's bytes, no
    class forms, no leg runs, no override is loaded (a record on disk stays
    unread: only the warm store's entry count shows it), and the scrape has
    no tune family, phase or counter."""
    monkeypatch.setenv("SPGEMM_TPU_TUNE", "0")
    monkeypatch.setenv("SPGEMM_TPU_TUNE_TRIAL_S", "0.01")
    d = make_daemon()
    warmstore.save_tune("ck@cpu", {"state": "live", "knobs": {"SPGEMM_TPU_PLAN_AHEAD": "0"}})
    folder = _chain_folder(tmp_path)
    want = _oracle_bytes(folder)
    for i in range(2):
        job = _run(d, folder, str(tmp_path / f"o{i}"))
        assert job["state"] == "done"
        assert open(tmp_path / f"o{i}", "rb").read() == want
    time.sleep(0.3)  # idle ticks pass
    assert TUNER.stats() == {"enabled": False, "classes": [], "overrides": {}, "trials": 0,
                             "reverts": 0}
    assert knobs.tuned_overlay() == {}
    scrape = d._op_metrics()["text"]
    assert "spgemm_tune" not in scrape and 'phase="tune' not in scrape \
        and 'event="tune' not in scrape
    assert 'spgemm_warm_entries{kind="tune"} 1' in scrape


def test_tune_enabled_idle_daemon_scrape_unchanged(tmp_path):
    """Tuning on but no class formed: the scrape has no tune family."""
    d = Daemon(str(tmp_path / "t.sock"), journal=False, device="cpu")
    d.start()
    try:
        assert "spgemm_tune" not in d._op_metrics()["text"]
    finally:
        d.stop()


# --------------------------------------------------------- daemon trial lane --
def test_daemon_idle_trials_settle_a_seeded_class(tmp_path, monkeypatch):
    """A seeded class's legs run on idle ticks (the real chain on the CPU)
    and the class leaves trialing on its own, every leg bit-exact (a parity
    mismatch would park it as reverted)."""
    monkeypatch.setenv("SPGEMM_TPU_TUNE_TRIAL_S", "0.01")
    folder = _chain_folder(tmp_path)
    d = Daemon(str(tmp_path / "t.sock"), journal=False, device="cpu")
    d.start()
    try:
        TUNER.note_job("ck@cpu", "cpu")
        placement.note_class("ck@cpu", folder)
        _wait_until(lambda: TUNER.stats()["classes"][0]["state"] in ("settled", "canary"),
                    msg="the class to leave trialing")
        assert TUNER.stats()["trials"] >= len(trial_vectors())
        assert d._op_stats()["tune"]["classes"]
    finally:
        d.stop()


def test_daemon_jobs_form_a_class_and_its_legs_run(tmp_path, monkeypatch, make_daemon):
    """Through the socket: the folder's second submit (its structure then
    recorded) carries the class; idle legs follow, one per trial vector,
    each with its vector, wall, phases and launch counters in its
    tune_trial event; stats and the scrape show the class."""
    monkeypatch.setenv("SPGEMM_TPU_TUNE_TRIAL_S", "0.01")
    monkeypatch.setenv("SPGEMM_TPU_TUNE_MIN_WIN", "1000")  # nothing promotes
    d = make_daemon()
    folder = _chain_folder(tmp_path)
    want = _oracle_bytes(folder)
    for i in range(2):
        assert _run(d, folder, str(tmp_path / f"o{i}"))["state"] == "done"
        assert open(tmp_path / f"o{i}", "rb").read() == want
    ck = plancache.tune_class_key(
        plancache.chain_structure(placement.signature(folder)), "cpu")
    assert ck is not None and placement.rep_folder(ck) == folder
    _wait_until(lambda: TUNER.stats()["classes"]
                and TUNER.stats()["classes"][0]["state"] == "settled",
                msg="the class to settle")
    legs = [e for e in events.LOG.tail(200) if e["kind"] == "tune_trial"]
    assert [e["knobs"] for e in legs] == trial_vectors()
    assert all(e["class_key"] == ck and e["seconds"] > 0 and "plan" in e["phases_s"]
               for e in legs)
    stats = d._op_stats()["tune"]
    assert stats["classes"][0]["class"] == ck and stats["trials"] == len(legs)
    scrape = d._op_metrics()["text"]
    assert "spgemm_tune_overrides" not in scrape.replace("# HELP spgemm_tune_overrides", "")
    assert 'spgemm_engine_events_total{event="tune_trials"} 4' in scrape


def test_promoted_vector_canary_then_restart_readopts(tmp_path, monkeypatch, make_daemon):
    """A promotion persisted by the daemon's store; the next job is the
    tuned canary (a tightened deadline, the same bytes) and goes live; a
    second daemon on the same warm directory adopts the live record and
    runs the class's job under it."""
    d = make_daemon(0)
    folder = _chain_folder(tmp_path)
    want = _oracle_bytes(folder)
    assert _run(d, folder, str(tmp_path / "o0"))["state"] == "done"  # records the structure
    ck = plancache.tune_class_key(
        plancache.chain_structure(placement.signature(folder)), "cpu")
    winner = {"SPGEMM_TPU_ACCUM_ROUTE": "dense"}
    _drive_trials(TUNER, ck, folder, winner=winner)  # the daemon's store persists it
    assert warmstore.scan_tunes(d.warm_dir)[ck]["state"] == "canary"
    job = _run(d, folder, str(tmp_path / "o1"), timeout_s=40)
    assert job["state"] == "done" and job["timeout_s"] == 20  # the tuned canary
    assert open(tmp_path / "o1", "rb").read() == want
    assert knobs.tuned_overlay() == winner
    assert TUNER.stats()["classes"][0]["state"] == "live"
    assert [e["kind"] for e in events.LOG.tail(200)].count("tune_canary_passed") == 1
    assert ENGINE.count_snapshot().get("tune_apply", 0) >= 2  # persisted, then activated
    scrape = d._op_metrics()["text"]
    assert 'spgemm_tune_overrides{state="live"} 1' in scrape
    assert f'spgemm_tune_win_ratio{{class="{ck}"}} 2' in scrape
    assert 'spgemm_warm_entries{kind="tune"} 1' in scrape
    d.stop()
    # the restart: a fresh tuner state in the same process, the same socket
    TUNER.clear()
    knobs.clear_tuned()
    d2 = Daemon(d.socket_path, device="cpu")
    d2.start()
    try:
        rows = d2._op_stats()["tune"]["classes"]
        assert [(r["class"], r["state"], r["knobs"]) for r in rows] == [(ck, "live", winner)]
        job = _run(d2, folder, str(tmp_path / "o2"), timeout_s=40)
        assert job["state"] == "done" and job["timeout_s"] == 40  # live: no canary
        assert open(tmp_path / "o2", "rb").read() == want
        assert knobs.tuned_overlay() == winner
    finally:
        d2.stop()


def test_a_failed_tuned_canary_reverts(tmp_path, make_daemon):
    """The tuned canary's failure reverts the class with backoff and the next
    job runs on the base vector."""
    def runner(job, degraded=False):
        if knobs.tuned_overlay():
            raise RuntimeError("a misbehaving vector")
        from spgemm_tpu_torch.serve.daemon import run_chain_job
        run_chain_job(job, degraded)

    d = make_daemon(runner=runner)
    folder = _chain_folder(tmp_path)
    assert _run(d, folder, str(tmp_path / "o0"))["state"] == "done"
    ck = plancache.tune_class_key(
        plancache.chain_structure(placement.signature(folder)), "cpu")
    _drive_trials(TUNER, ck, folder, winner={"SPGEMM_TPU_PLAN_AHEAD": "0"})
    assert _run(d, folder, str(tmp_path / "o1"))["state"] == "failed"
    row = TUNER.stats()["classes"][0]
    assert row["state"] == "reverted" and row["backoff_s"] == BACKOFF0_S
    assert warmstore.scan_tunes(d.warm_dir)[ck]["state"] == "reverted"
    assert _run(d, folder, str(tmp_path / "o2"))["state"] == "done"
    assert knobs.tuned_overlay() == {}


# ---------------------------------------------------- parity with the JAX package --
def _script_rows(t, vectors_of, knobs_mod):
    """Drive one tuner through the shared script; its row after each step,
    vectors given as their positions in the tuner's own trial plan."""
    plan = vectors_of()

    def row():
        out = []
        for r in t.stats()["classes"]:
            r = dict(r)
            r["knobs"] = plan.index(r["knobs"]) if r["knobs"] else None
            out.append(r)
        return out

    rows = []
    walls = [1.0, 0.8, 1.2, 0.5]
    for ck in ("a@cpu", "b@cpu"):
        t.note_job(ck, "cpu")
        rows.append(row())
    i = 0
    while (leg := t.next_leg(lambda key: "/fixed" if key == "a@cpu" else None)) is not None:
        key, folder, vec = leg
        assert folder == "/fixed"
        t.record_preempted(key, vec, "preempted")
        t.record_leg(key, vec, walls[plan.index(vec)], "d0")
        rows.append(row())
        i += 1
    assert i == len(plan)
    assert t.consume_canary("a@cpu")
    t.note_terminal("a@cpu", ok=False)
    rows.append(row())
    for err in (0.01, 0.02, 0.03, 0.01, 0.9, 0.9, 0.9, 0.9):
        t.note_est_accuracy("b@cpu", err)
        rows.append(row())
    with t._lock:
        t._classes["a@cpu"].retry_at = 0.0
    key, _f, vec = t.next_leg(lambda key: "/fixed")
    t.record_leg(key, vec, 1.0, "d0")
    key, _f, vec = t.next_leg(lambda key: "/fixed")
    t.record_leg(key, vec, 0.1, "d-other")  # a parity mismatch
    rows.append(row())
    return rows


def test_the_tuner_state_machine_matches_the_jax_tuner():
    port = _script_rows(Tuner(), trial_vectors, knobs)
    jax = _script_rows(jax_tuner.Tuner(), lambda: jax_tuner.trial_vectors("cpu"), jax_knobs)
    assert port == jax
    assert port[-1][0]["state"] == "reverted" and port[-1][0]["backoff_s"] == 2 * BACKOFF0_S
    assert port[-1][1]["est"] == {"SPGEMM_TPU_EST_SAMPLE_ROWS": "24",
                                  "SPGEMM_TPU_EST_CONFIDENCE": "0.7"}


@pytest.mark.parametrize("fp", [None, "", "abc", "0123456789abcdef" * 4])
@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 80GB HBM3", ""])
def test_the_class_key_is_the_jax_key(fp, kind):
    assert plancache.tune_class_key(fp, kind) == jax_plancache.tune_class_key(fp, kind)


def test_knob_resolution_matches_the_jax_registry(monkeypatch):
    """env > tuned > default, value and source, on every knob both
    registries hold with one default."""
    shared = [n for n, kb in knobs.REGISTRY.items() if n in jax_knobs.REGISTRY
              and jax_knobs.REGISTRY[n].default == kb.default
              and jax_knobs.REGISTRY[n].kind == kb.kind]
    assert {"SPGEMM_TPU_TUNE", "SPGEMM_TPU_TUNE_TRIAL_S", "SPGEMM_TPU_TUNE_MIN_WIN",
            "SPGEMM_TPU_ACCUM_ROUTE", "SPGEMM_TPU_PLAN_AHEAD"} <= set(shared)
    overlay = {"SPGEMM_TPU_ACCUM_ROUTE": "dense", "SPGEMM_TPU_PLAN_AHEAD": "0",
               "SPGEMM_TPU_EST_SAMPLE_ROWS": "24", "SPGEMM_TPU_TUNE_MIN_WIN": "1.5"}
    monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", "3")
    for mod in (knobs, jax_knobs):
        mod.set_tuned(overlay)
    for name in shared:
        assert knobs.get(name) == jax_knobs.get(name), name
        assert knobs.base_get(name) == jax_knobs.base_get(name), name
        assert knobs.source(name) == jax_knobs.source(name), name
    assert knobs.get("SPGEMM_TPU_PLAN_AHEAD") == 3  # env beats tuned
    assert knobs.get("SPGEMM_TPU_ACCUM_ROUTE") == "dense"
    assert knobs.base_get("SPGEMM_TPU_ACCUM_ROUTE") == "auto"
    assert knobs.source("SPGEMM_TPU_ACCUM_ROUTE") == "tuned"
    assert knobs.base_tuned_vector() == (("SPGEMM_TPU_PLAN_AHEAD", "3"),
                                         ("SPGEMM_TPU_ACCUM_ROUTE", "auto"))
    with pytest.raises(ValueError, match="SPGEMM_TPU_ACCUM_ROUTE"):
        knobs.set_tuned({"SPGEMM_TPU_ACCUM_ROUTE": "sideways"})
    with pytest.raises(KeyError):
        knobs.set_tuned({"SPGEMM_TPU_NOT_A_KNOB": "1"})


@pytest.mark.parametrize("leg", range(4))
@pytest.mark.parametrize("seed,dist", [(81, "full"), (82, "adversarial")])
def test_a_chain_under_each_trial_vector_gives_the_jax_bytes(leg, seed, dist, monkeypatch):
    """Each trial vector of the port, as the tuned overlay a leg runs under,
    gives the JAX package's bytes (delta off, ROADMAP section 3); where the
    two differ the oracle decides, and the port must hold the oracle's."""
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    mats = jax_random_chain(5, 6, 2, 0.5, np.random.default_rng(seed), dist)
    vector = trial_vectors()[leg]
    knobs.set_tuned({**vector, "SPGEMM_TPU_DELTA": "0"})
    got = chain_product([BlockSparseMatrix.from_reference(m) for m in mats], device="cpu")
    want = jax_chain_product(mats, backend="xla")
    oracle = BlockSparseMatrix.from_dict(mats[0].rows, mats[-1].cols, 2, chain_oracle(
        [m.to_dict() for m in mats], 2))
    same_jax = np.array_equal(got.coords, want.coords) and np.array_equal(got.tiles, want.tiles)
    assert same_jax or io_text.format_matrix(got.prune_zeros()) == \
        io_text.format_matrix(oracle.prune_zeros())
    assert io_text.format_matrix(got.prune_zeros()) == io_text.format_matrix(oracle.prune_zeros())


def test_concurrent_overlay_swaps_never_tear():
    """Activations from many threads replace the overlay whole: a reader
    sees one of the vectors written, never a mixture, and the generation
    counts every change."""
    vectors = [{"SPGEMM_TPU_ACCUM_ROUTE": r, "SPGEMM_TPU_PLAN_AHEAD": a}
               for r, a in (("auto", "2"), ("dense", "0"), ("ladder", "1"))]
    seen, stop = [], threading.Event()
    g0 = knobs.tuned_generation()

    def writer(i):
        for _ in range(200):
            knobs.set_tuned(vectors[i % 3])
            knobs.set_tuned(vectors[(i + 1) % 3])

    def reader():
        while not stop.is_set():
            seen.append(knobs.tuned_overlay())

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(6)]
    r = threading.Thread(target=reader)
    r.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    stop.set()
    r.join(timeout=30)
    assert not r.is_alive() and not any(t.is_alive() for t in threads)
    assert all(s in vectors + [{}] for s in seen)
    assert knobs.tuned_generation() > g0
