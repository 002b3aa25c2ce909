"""spgemmd's pool of several slices on the port (parallel/mesh.slice_pool,
Daemon._preferred_names, _devices_held, _accepts, one executor per slice,
per-slice degrade and recovery, work stealing, wide slices on
parallel/rowshard), mirroring the JAX package's tests/test_serve_pool.py on
the CPU, where the daemon takes the injected device count as given and
every slice position is `cpu`.  Injected runners everywhere the engine is
not the subject; the real engine's bytes against the oracle.  Tolerance:
zero differing bytes."""

import os
import shutil
import threading
import time

import numpy as np
import pytest

from spgemm_tpu.parallel import mesh as jax_mesh
from spgemm_tpu_torch import tune as tune_mod
from spgemm_tpu_torch.ops import delta, plancache, warmstore
from spgemm_tpu_torch.parallel import mesh
from spgemm_tpu_torch.serve import client, placement, protocol
from spgemm_tpu_torch.serve.daemon import Daemon, run_chain_job
from spgemm_tpu_torch.serve.queue import Job
from spgemm_tpu_torch.utils import failpoints, io_text
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import random_chain
from spgemm_tpu_torch.utils.semantics import chain_oracle, field_spgemm_oracle
from spgemm_tpu_torch.utils.timers import ENGINE


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("SPGEMM_TPU_FAILPOINTS", raising=False)
    for name in ("SPGEMM_TPU_WARM_DIR", "SPGEMM_TPU_SERVE_ADDR", "SPGEMM_TPU_SERVE_SLICES",
                 "SPGEMM_TPU_DELTA", "SPGEMM_TPU_TUNE_TRIAL_S"):
        monkeypatch.delenv(name, raising=False)
    for mod in (delta, plancache, failpoints, placement):
        mod.clear()
    warmstore.reset()
    yield
    for mod in (delta, plancache, failpoints, placement):
        mod.clear()
    warmstore.reset()


@pytest.fixture
def make_daemon(tmp_path):
    """Port daemons (device="cpu" unless given), per-test sockets, stopped
    at teardown."""
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


def _chain_folder(tmp_path, n=3, k=2, seed=7, name="chain_in"):
    """A chain input directory and the oracle's bytes."""
    mats = random_chain(n, 4, k, 0.5, np.random.default_rng(seed), "full")
    folder = str(tmp_path / name)
    io_text.write_chain_dir(folder, mats, k)
    want = chain_oracle([m.to_dict() for m in mats], k)
    return folder, io_text.format_matrix(BlockSparseMatrix.from_dict(
        mats[0].rows, mats[-1].cols, k, want).prune_zeros())


def _wait_until(pred, timeout=30.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


# ------------------------------------------------------------ slice table --
@pytest.mark.parametrize("spec,n", [("1x4+4", 8), ("1x4*+4", 8), ("1", None), ("auto", 4),
                                    ("auto", 1), ("2x2+1x4", 8), ("1+1x2", 3), ("3x1*+1x2", 5),
                                    ("2", None), ("1x3", 3)])
def test_the_slice_pool_is_the_jax_pool_field_for_field(spec, n):
    port, jax = mesh.slice_pool(spec, n), jax_mesh.slice_pool(spec, n)
    assert [(s.name, s.index, s.device_ids, s.default, s.width) for s in port] == \
        [(s.name, s.index, s.device_ids, s.default, s.width) for s in jax]
    assert [[a.overlaps(b) for b in port] for a in port] == \
        [[a.overlaps(b) for b in jax] for a in jax]


def test_slice_spec_terms_and_device_assignment():
    pool = mesh.slice_pool("1x4+4", 8)
    assert [s.width for s in pool] == [4, 1, 1, 1, 1]
    assert pool[0].device_ids == (0, 1, 2, 3)
    assert [s.device_ids for s in pool[1:]] == [(4,), (5,), (6,), (7,)]
    assert [s.default for s in pool] == [False, True, True, True, True]
    assert pool[0].name == "s0w4" and pool[1].name == "s1w1"
    auto = mesh.slice_pool("auto", 4)
    assert auto[-1].name == "s4w4" and auto[-1].overlaps(auto[0]) and not auto[-1].default


def test_the_daemon_builds_its_pool_on_the_cpu_and_refuses_an_overcommit(tmp_path):
    d = Daemon(str(tmp_path / "a.sock"), slices="1x2+1", n_devices=3, device="cpu")
    assert [(s.name, s.devices, s.device, s.width, s.spec.default) for s in d.slices] == [
        ("s0w2", ("cpu", "cpu"), "cpu,cpu", 2, False), ("s1w1", ("cpu",), "cpu", 1, True)]
    d = Daemon(str(tmp_path / "b.sock"), slices="2", device="cpu")  # trusted as given
    assert [s.devices for s in d.slices] == [("cpu",), ("cpu",)]
    assert [s.name for s in Daemon(str(tmp_path / "c.sock"), slices="auto",
                                   device="cpu").slices] == ["s0w1"]
    d = Daemon(str(tmp_path / "d.sock"), slices="auto", n_devices=2)
    assert [s.devices for s in d.slices] == [("cuda:0",), ("cuda:1",), ("cuda:0", "cuda:1")]
    with pytest.raises(mesh.SliceSpecError, match="needs 2 devices but only 1 are visible"):
        Daemon(str(tmp_path / "e.sock"), slices="2", n_devices=1)


# ------------------------------------------------------------- placement --
def test_preferred_names_by_class(tmp_path):
    d = Daemon(str(tmp_path / "a.sock"), slices="1x2+2", n_devices=4, device="cpu")
    wide, s1, s2 = d.slices

    def pref(cls):
        job = Job("p", "f", "o", {})
        job.placement = None if cls is None else {"class": cls}
        return d._preferred_names(job)

    assert pref("small") == pref("default") == pref(None) == {s1.name, s2.name}
    assert pref("large") == {wide.name}
    s1.degraded = s2.degraded = True
    assert pref("small") == pref("default") == {wide.name}  # the narrowest healthy
    wide.degraded = True
    assert pref("large") == set()
    star = Daemon(str(tmp_path / "b.sock"), slices="1x2*+2", n_devices=4, device="cpu")
    job = Job("q", "f", "o", {})
    assert star._preferred_names(job) == {star.slices[0].name}


def test_an_mxu_job_stays_off_a_wide_slice_while_a_single_is_healthy(tmp_path, make_daemon):
    """A wide slice's sharded fold is the exact one, so a job under mxu
    prefers the single-device slices whatever its class, and no wide slice
    steals it while one of them is healthy; with every single degraded the
    wide slice is eligible (its runner keeps the field mode)."""
    folder, _ = _chain_folder(tmp_path)
    d = make_daemon(runner=lambda job, degraded=False: None, slices="1x2+1", n_devices=3)
    d._stop.set()  # freeze the executors; the predicate is driven by hand
    for sl in d.slices:
        sl.thread.join(timeout=5.0)
        sl.current = None
    wide, single = d.slices
    for cls in ("small", "large", "default", None):
        job = Job("m", folder, "o", {"backend": "mxu"})
        job.placement = None if cls is None else {"class": cls}
        assert d._preferred_names(job) == {single.name}
    exact = Job("e", folder, "o", {"backend": "exact"})
    exact.placement = {"class": "large"}
    assert d._preferred_names(exact) == {wide.name}
    held, mxu = Job("h", folder, "o", {}), Job("m", folder, "o", {"backend": "mxu"})
    assert d._accepts(single, held) is True
    assert d._accepts(wide, mxu) is False and wide.current is None  # never stolen
    single.current = None
    assert d._accepts(single, mxu) is True and not mxu.stolen
    single.current, single.degraded = None, True
    late = Job("l", folder, "o", {"backend": "mxu"})
    assert d._preferred_names(late) == {wide.name}
    assert d._accepts(wide, late) is True and not late.stolen


def test_accept_claims_slice_under_the_queue_lock(tmp_path, make_daemon):
    """The claim is made by the accept predicate, so an overlapping slice
    deciding in the same round sees its devices held."""
    folder, _ = _chain_folder(tmp_path)
    d = make_daemon(runner=lambda job, degraded=False: None, slices="auto", n_devices=2)
    d._stop.set()  # freeze the executors; the predicate is driven by hand
    for sl in d.slices:
        sl.thread.join(timeout=5.0)
        sl.current = None
    single, full = d.slices[0], d.slices[2]
    j1, j2 = Job("c1", folder, "o", {}), Job("c2", folder, "o", {})
    j2.placement = {"class": "large"}  # prefers the full-mesh slice
    assert d._accepts(single, j1) is True and single.current is j1
    assert d._accepts(full, j2) is False  # shares device 0 with the claimed single
    single.current = None
    assert d._accepts(full, j2) is True and not j2.stolen
    # a small job while the full mesh holds both devices: no single may take it
    j3 = Job("c3", folder, "o", {})
    assert d._accepts(d.slices[1], j3) is False


def test_lone_wide_slice_pins_all_its_devices(tmp_path, make_daemon):
    """`1x4` must shard over its four positions, never shrink to one."""
    folder, _ = _chain_folder(tmp_path)
    seen = {}

    def runner(job, degraded=False):
        seen.update(devices=job.devices, slice=job.slice)

    d = make_daemon(runner=runner, slices="1x4", n_devices=4, device="cuda",
                    probe=lambda: "ok")
    j = client.submit(folder, d.socket_path)
    job = client.wait(j["id"], d.socket_path, timeout=30)["job"]
    assert job["state"] == "done" and job["detail"]["device"] == "cuda:0,cuda:1,cuda:2,cuda:3"
    assert seen == {"devices": ("cuda:0", "cuda:1", "cuda:2", "cuda:3"), "slice": "s0w4"}


def test_single_slice_default_is_the_one_slice_executor(tmp_path, make_daemon):
    folder, _ = _chain_folder(tmp_path)
    seen = {}

    def runner(job, degraded=False):
        seen.update(devices=job.devices, slice=job.slice, stolen=job.stolen)

    d = make_daemon(runner=runner)
    assert len(d.slices) == 1 and d.slices[0].width == 1
    j = client.submit(folder, d.socket_path)
    assert client.wait(j["id"], d.socket_path, timeout=30)["job"]["state"] == "done"
    assert seen == {"devices": ("cpu",), "slice": "s0w1", "stolen": False}


# ----------------------------------------------------- pool dispatching --
def test_two_slices_run_jobs_concurrently(tmp_path, make_daemon):
    folder, _ = _chain_folder(tmp_path)
    started, release = [], threading.Event()

    def runner(job, degraded=False):
        started.append(job.slice)
        release.wait(30)

    d = make_daemon(runner=runner, slices="2", n_devices=2)
    try:
        for _ in range(2):
            client.submit(folder, d.socket_path)
        _wait_until(lambda: len(started) == 2, msg="two jobs running at once")
        assert sorted(started) == ["s0w1", "s1w1"]
        st = client.stats(d.socket_path)
        assert sum(1 for s in st["slices"] if s["busy"]) == 2
    finally:
        release.set()


def test_work_stealing_when_preferred_slice_busy(tmp_path, make_daemon):
    """`1x2+1`: the narrow slice is the default; while it is busy the idle
    wide slice steals the next default-class job, counted on the slice
    row, in ENGINE's serve_steals and on the scrape."""
    folder, _ = _chain_folder(tmp_path)
    release = threading.Event()

    def runner(job, degraded=False):
        release.wait(30)

    d = make_daemon(runner=runner, slices="1x2+1", n_devices=3)
    steals0 = ENGINE.counter_snapshot().get("serve_steals", 0)
    try:
        narrow = next(s.name for s in d.slices if s.width == 1)
        wide = next(s.name for s in d.slices if s.width == 2)
        j1 = client.submit(folder, d.socket_path)
        _wait_until(lambda: any(s.current for s in d.slices), msg="first job picked up")
        j2 = client.submit(folder, d.socket_path)
        _wait_until(lambda: sum(1 for s in d.slices if s.current) == 2,
                    msg="second job stolen by the idle slice")
        snap1 = client.status(j1["id"], d.socket_path)["job"]
        snap2 = client.status(j2["id"], d.socket_path)["job"]
        assert snap1["slice"] == narrow and not snap1["stolen"]
        assert snap2["slice"] == wide and snap2["stolen"]
        st = client.stats(d.socket_path)
        assert next(s for s in st["slices"] if s["name"] == wide)["steals"] == 1
        assert next(s for s in st["slices"] if s["name"] == narrow)["steals"] == 0
        assert st["serve"]["serve_steals"] - steals0 == 1
        text = client.metrics(d.socket_path)
        assert f'spgemm_slice_steals_total{{slice="{wide}"}} 1' in text
        assert f'spgemm_slice_steals_total{{slice="{narrow}"}} 0' in text
        assert 'spgemm_engine_events_total{event="serve_steals"}' in text
    finally:
        release.set()


def test_overlapping_slices_are_mutually_exclusive(tmp_path, make_daemon):
    """`auto`'s full-mesh slice never runs while a single holds a device."""
    folder, _ = _chain_folder(tmp_path)
    release = threading.Event()

    def runner(job, degraded=False):
        release.wait(30)

    d = make_daemon(runner=runner, slices="auto", n_devices=2)
    try:
        for _ in range(3):
            client.submit(folder, d.socket_path)
        _wait_until(lambda: sum(1 for s in d.slices if s.current) == 2, msg="both singles busy")
        time.sleep(0.6)  # every chance for the full-mesh slice to err
        full = next(s for s in d.slices if s.width == 2)
        assert full.current is None
        assert client.stats(d.socket_path)["jobs"]["queued"] == 1
    finally:
        release.set()


# -------------------------------------------------- per-slice degrade ----
def test_one_wedged_slice_degrades_alone(tmp_path, make_daemon):
    """One wedged slice degrades while the other serves on its device; the
    daemon is not degraded and its reason stays null; stats and the
    per-slice series say which slice."""
    folder, _ = _chain_folder(tmp_path)
    unwedge, first = threading.Event(), threading.Event()

    def runner(job, degraded=False):
        if not first.is_set() and not degraded:
            first.set()
            unwedge.wait(60)  # a hung device call: no beat, no return

    d = make_daemon(runner=runner, slices="2", n_devices=2, job_timeout_s=0.3,
                    wedge_grace_s=0.2, probe=lambda: "timeout")
    try:
        j1 = client.submit(folder, d.socket_path)
        resp = client.wait(j1["id"], d.socket_path, timeout=30)
        assert resp["job"]["error"]["code"] == protocol.E_JOB_TIMEOUT
        _wait_until(lambda: any(s.degraded for s in d.slices), msg="wedged slice degrades")
        assert d.degraded is False
        j2 = client.submit(folder, d.socket_path, {"timeout_s": 0})
        resp2 = client.wait(j2["id"], d.socket_path, timeout=30)
        assert resp2["job"]["state"] == "done" and resp2["job"]["detail"]["degraded"] is False
        st = client.stats(d.socket_path)
        assert st["degraded"] is False and st["degrade_reason"] is None
        assert st["slices_degraded"] == 1
        bad = next(s for s in st["slices"] if s["degraded"])
        good = next(s for s in st["slices"] if not s["degraded"])
        assert bad["degrade_reason"] and resp2["job"]["slice"] == good["name"]
        text = client.metrics(d.socket_path)
        assert f'spgemm_slice_degraded{{slice="{bad["name"]}"}} 1' in text
        assert f'spgemm_slice_degraded{{slice="{good["name"]}"}} 0' in text
        assert "spgemmd_degraded 0" in text
    finally:
        unwedge.set()


def test_all_slices_degraded_still_serves_and_flags_daemon(tmp_path, make_daemon):
    folder, want = _chain_folder(tmp_path)
    unwedge = threading.Event()
    hangs = []

    def runner(job, degraded=False):
        if not degraded and len(hangs) < 2:
            hangs.append(job.id)
            unwedge.wait(60)
        elif degraded:
            run_chain_job(job, degraded=True)

    d = make_daemon(runner=runner, slices="2", n_devices=2, job_timeout_s=0.3,
                    wedge_grace_s=0.2, probe=lambda: "timeout")
    try:
        for _ in range(2):
            j = client.submit(folder, d.socket_path)
            client.wait(j["id"], d.socket_path, timeout=30)
        _wait_until(lambda: all(s.degraded for s in d.slices), msg="both slices degrade")
        _wait_until(lambda: all(s.thread is not None for s in d.slices),
                    msg="both slices on the host oracle")
        assert d.degraded is True and d.degrade_reason
        out = str(tmp_path / "oracle.out")
        j = client.submit(folder, d.socket_path, {"timeout_s": 0, "output": out})
        resp = client.wait(j["id"], d.socket_path, timeout=30)
        assert resp["job"]["state"] == "done" and resp["job"]["detail"]["degraded"] is True
        assert open(out, "rb").read() == want
    finally:
        unwedge.set()


def test_a_live_probe_reinstates_only_the_wedged_slice(tmp_path, make_daemon):
    """Recovery is per slice: the wedged slice alone is probed, reinstated
    behind its own canary and counted; the other slice never degraded."""
    folder, _ = _chain_folder(tmp_path)
    unwedge, first = threading.Event(), threading.Event()

    def runner(job, degraded=False):
        if not first.is_set():
            first.set()
            unwedge.wait(60)

    d = make_daemon(runner=runner, slices="2", n_devices=2, job_timeout_s=0.3,
                    wedge_grace_s=0.2, probe=lambda: "cpu")
    try:
        j1 = client.submit(folder, d.socket_path)
        assert client.wait(j1["id"], d.socket_path, timeout=30)["job"]["state"] == "failed"
        _wait_until(lambda: sum(s.recoveries for s in d.slices) == 1, msg="a reinstatement")
        rows = {s["name"]: s for s in client.stats(d.socket_path)["slices"]}
        wedged = next(s for s in d.slices if s.recoveries == 1).name
        other = next(name for name in rows if name != wedged)
        assert rows[wedged]["canary"] and not rows[wedged]["degraded"]
        assert rows[other]["recoveries"] == 0 and not rows[other]["canary"]
        assert not d.degraded and d.degrade_reason is None
    finally:
        unwedge.set()


# ------------------------------------------------------------ lock order --
def test_two_slices_finishing_at_once_keep_the_lock_order(tmp_path, make_daemon):
    """Two slices commit terminal jobs at the same instant while a client
    reads stats: each commit takes a job's lock, then the tuner's, the
    placement book's and obs/profile's (the order daemon._commit_terminal
    sets); stats takes those without a job's.  No deadlock: every job ends
    within its wait, with the oracle's bytes."""
    folders = [_chain_folder(tmp_path, seed=s, name=f"c{s}") for s in (41, 42)]
    barrier = threading.Barrier(2, timeout=30)

    def runner(job, degraded=False):
        run_chain_job(job, degraded=degraded)
        try:
            barrier.wait()  # both slices reach their commit together
        except threading.BrokenBarrierError:
            pass

    d = make_daemon(runner=runner, slices="2", n_devices=2)
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            client.stats(d.socket_path)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        for rnd in range(3):
            jobs = []
            for i, (folder, _) in enumerate(folders):
                out = str(tmp_path / f"out.{rnd}.{i}")
                jobs.append((client.submit(folder, d.socket_path, {"output": out})["id"], out,
                             folders[i][1]))
            for jid, out, want in jobs:
                job = client.wait(jid, d.socket_path, timeout=60)["job"]
                assert job["state"] == "done", job["error"]
                assert open(out, "rb").read() == want
            barrier.reset()
        # the later rounds carried a tuner class: the tuner's lock was taken
        assert tune_mod.TUNER.stats()["classes"]
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()


def test_one_trial_leg_per_cadence_across_the_pool(tmp_path, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_TUNE_TRIAL_S", "100")
    legs = []
    monkeypatch.setattr(tune_mod, "run_trial_leg", lambda *a, **kw: legs.append(a) or True)
    d = Daemon(str(tmp_path / "a.sock"), slices="3", n_devices=3, device="cpu")
    for sl in d.slices:
        d._maybe_tune(sl, sl.gen)
    assert len(legs) == 1


# ------------------------------------------------ the real engine ---------
@pytest.mark.parametrize("spec,n", [("2", 2), ("1x2+1", 3)])
def test_the_pool_serves_the_real_engine_bit_exact(tmp_path, make_daemon, spec, n):
    """Real chains through a pool: every job's bytes the oracle's; under
    `1x2+1` a large-class job runs on the wide slice, sharded
    (parallel/rowshard: its detail counts rowshard_round), and a small one
    on the single; the delta store is not consulted on the wide slice."""
    fa, wa = _chain_folder(tmp_path, seed=31, name="pool_a", n=4)
    fb, wb = _chain_folder(tmp_path, seed=32, name="pool_b", n=4)
    d = make_daemon(slices=spec, n_devices=n)  # the default runner: the real engine
    if spec == "1x2+1":
        placement.note_mass(fa, placement.LARGE_MASS_PAIRS * 2)  # fa prices large
        placement.note_mass(fb, 1.0)
    jobs = []
    for rep in range(2):
        for folder, want in ((fa, wa), (fb, wb)):
            out = f"{folder}.{rep}.out"
            jobs.append((client.submit(folder, d.socket_path, {"output": out})["id"], out, want,
                         folder))
    slices = {}
    for jid, out, want, folder in jobs:
        job = client.wait(jid, d.socket_path, timeout=300)["job"]
        assert job["state"] == "done", job["error"]
        assert open(out, "rb").read() == want
        if not job["stolen"]:
            slices.setdefault(folder, set()).add(job["slice"])
        det = job["detail"]
        wide = job["slice"] == "s0w2"
        assert (det.get("rowshard_round", 0) > 0) == wide
        assert det["device"] == ("cpu,cpu" if wide else "cpu")
        if wide:
            assert det["delta_rows"] == 0 and det["total_rows"] == 0
    # a job an idle slice stole runs there; every other ran where its class is
    if spec == "1x2+1":
        assert slices[fa] == {"s0w2"} and slices.get(fb, {"s1w1"}) == {"s1w1"}
    else:
        assert set().union(*slices.values()) <= {"s0w1", "s1w1"}


def _wrap_folder(tmp_path):
    """tests/data/golden_wrap (products that wrap, so field mode's bytes
    differ from the exact fold's) and the field-mode oracle's bytes."""
    folder = str(tmp_path / "wrap")
    shutil.copytree(os.path.join(os.path.dirname(__file__), "data", "golden_wrap"), folder)
    n, k = io_text.read_size(folder)
    mats = io_text.read_chain(folder, 0, n - 1, k)
    dicts = [m.to_dict() for m in mats]
    field = io_text.format_matrix(BlockSparseMatrix.from_dict(
        mats[0].rows, mats[-1].cols, k,
        chain_oracle(dicts, k, multiply=field_spgemm_oracle)).prune_zeros())
    exact = io_text.format_matrix(BlockSparseMatrix.from_dict(
        mats[0].rows, mats[-1].cols, k, chain_oracle(dicts, k)).prune_zeros())
    assert field != exact
    return folder, field


@pytest.mark.parametrize("spec,n", [("1x2+1", 3), ("1x2", 2)])
def test_an_mxu_job_gives_the_field_oracle_bytes_on_any_pool(tmp_path, make_daemon, spec, n):
    """The real engine: a large-class job under mxu on `1x2+1` runs on the
    single (never sharded), and on a pool of one wide slice it runs
    unsharded on the slice's first device; either way its bytes are the
    field-mode oracle's, never the exact fold's."""
    folder, want = _wrap_folder(tmp_path)
    d = make_daemon(slices=spec, n_devices=n)
    placement.note_mass(folder, placement.LARGE_MASS_PAIRS * 2)  # prices large
    for rep in range(2):
        out = f"{folder}.{rep}.out"
        jid = client.submit(folder, d.socket_path, {"output": out, "backend": "mxu"})["id"]
        job = client.wait(jid, d.socket_path, timeout=300)["job"]
        assert job["state"] == "done", job["error"]
        assert open(out, "rb").read() == want
        assert job["detail"].get("rowshard_round", 0) == 0
        assert job["slice"] == ("s1w1" if spec == "1x2+1" else "s0w2")


def test_run_chain_job_keeps_the_field_mode_on_a_wide_slice(tmp_path):
    folder, want = _wrap_folder(tmp_path)
    job = Job("w", folder, str(tmp_path / "w.out"), {"backend": "mxu"})
    job.devices = ("cpu", "cpu")
    run_chain_job(job)
    assert open(job.output, "rb").read() == want
