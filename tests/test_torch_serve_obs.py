"""spgemmd's obs layer on the port (serve/daemon.py's `metrics`, `trace`,
`events`, `profile` and `slo` ops, its event log and flight dumps,
serve/client.py's obs calls and the CLI's `metrics`, `events`,
`trace-dump`, `profile` and `slo`), on device="cpu": the ops answer and
their series move after a submit; the profile and slo reports have the JAX
package's shape; an armed serve.executor failpoint with objectives burns
the SLO with the client's trace id, and the window's end clears it; a
job's detail carries its device memory peak (solo and under a batch) only
when the device reported; serve/obs_smoke.py passes on the CPU; a job's trace id
runs from the client's span through the daemon's spans; a reap, a wedge and
a degrade each write their event and a flight dump (runners gated by
threading.Events, never a race of wall clocks); the flight directory stays
bounded; a failpoint reaches the scrape and the event log; the JAX client
reads the port daemon's obs ops; and the slice as a whole, one small chain
through a port daemon and a JAX daemon (SPGEMM_TPU_DELTA=0), gives the same
bytes and the same job_submit/job_start/job_done sequence.  Inputs from
numpy seeds at small sizes.  Tolerance: byte equality."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from spgemm_tpu.obs import events as jax_events
from spgemm_tpu.obs import trace as jax_trace
from spgemm_tpu.serve import client as jax_client
from spgemm_tpu.serve import daemon as jax_daemon
from spgemm_tpu.obs import profile as jax_profile
from spgemm_tpu.obs import slo as jax_slo
from spgemm_tpu_torch.obs import events, profile, slo, trace
from spgemm_tpu_torch.ops import delta, plancache, warmstore
from spgemm_tpu_torch.serve import client, placement, protocol
from spgemm_tpu_torch.serve.daemon import Daemon
from spgemm_tpu_torch.utils import failpoints, io_text
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import random_chain
from spgemm_tpu_torch.utils.semantics import chain_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIFECYCLE = ("job_submit", "job_start", "job_done", "job_failed")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("SPGEMM_TPU_FAILPOINTS", "SPGEMM_TPU_WARM_DIR", "SPGEMM_TPU_SERVE_ADDR",
                 "SPGEMM_TPU_SERVE_SLICES", "SPGEMM_TPU_DELTA", "SPGEMM_TPU_OBS_TRACE",
                 "SPGEMM_TPU_OBS_EVENTS", "SPGEMM_TPU_OBS_RING_CAP",
                 "SPGEMM_TPU_SERVE_BATCH_WINDOW_S", "SPGEMM_TPU_SLO_TARGET_S",
                 "SPGEMM_TPU_SLO_ERROR_PCT", "SPGEMM_TPU_SLO_WINDOW_S"):
        monkeypatch.delenv(name, raising=False)
    for mod in (delta, plancache, failpoints, placement, profile):
        mod.clear()
    warmstore.reset()
    trace.RECORDER.clear()
    events.LOG.clear()
    slo.SLO.clear()
    yield
    for mod in (delta, plancache, failpoints, placement, profile):
        mod.clear()
    warmstore.reset()
    events.LOG.clear()
    slo.SLO.clear()


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


def _chain_folder(tmp_path, n=3, k=2, seed=7, name="chain_in"):
    mats = random_chain(n, 4, k, 0.5, np.random.default_rng(seed), "full")
    folder = str(tmp_path / name)
    io_text.write_chain_dir(folder, mats, k)
    blocks = chain_oracle([m.to_dict() for m in mats], k)
    want = io_text.format_matrix(
        BlockSparseMatrix.from_dict(mats[0].rows, mats[-1].cols, k, blocks).prune_zeros())
    return folder, want


def _wait_until(pred, timeout=60.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _run(d, folder, out, trace_id=None, **options):
    j = client.submit(folder, d.socket_path, {"output": out, **options}, trace=trace_id)
    return client.wait(j["id"], d.socket_path, timeout=120)["job"]


def _series(text: str) -> dict:
    """{`name{labels}`: value} of a text-format 0.0.4 scrape; raises on a
    line that is neither a comment nor `series value`."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


def _kinds(evs, job_id=None):
    """Every event's kind, or one job's lifecycle kinds."""
    if job_id is None:
        return [e["kind"] for e in evs]
    return [e["kind"] for e in evs if e.get("job_id") == job_id and e["kind"] in LIFECYCLE]


def _gated_runner(gate: threading.Event, entered: threading.Event):
    """A runner whose healthy jobs hang until gate is set (a card that
    hangs); degraded jobs return at once."""
    def runner(job, degraded=False):
        if not degraded:
            from spgemm_tpu_torch.utils.timers import ENGINE
            with ENGINE.phase("serve_load"):  # a span of the job before it hangs
                pass
            entered.set()
            gate.wait(120)
    return runner


# ---------------------------------------------------------------- the ops --
def test_the_three_ops_answer_and_move_after_a_submit(tmp_path, make_daemon):
    folder, want = _chain_folder(tmp_path)
    d = make_daemon()
    before = _series(client.metrics(d.socket_path))
    assert before['spgemmd_jobs_terminal_total{outcome="done"}'] == 0
    assert before["spgemmd_job_wall_seconds_count"] == 0
    assert not any(k.startswith("spgemm_serve_batch_size") for k in before)  # window 0
    job = _run(d, folder, str(tmp_path / "out"))
    assert job["state"] == "done" and open(tmp_path / "out", "rb").read() == want
    after = _series(client.metrics(d.socket_path))
    assert after['spgemmd_jobs_terminal_total{outcome="done"}'] == 1
    assert after["spgemmd_job_wall_seconds_count"] == 1
    assert after['spgemmd_job_wall_seconds_bucket{le="+Inf"}'] == 1
    assert after['spgemm_phase_entries_total{phase="serve_execute"}'] == \
        before.get('spgemm_phase_entries_total{phase="serve_execute"}', 0) + 1
    assert after['spgemm_slice_jobs_total{slice="s0w1"}'] == 1
    assert after["spgemm_trace_spans_emitted_total"] > before["spgemm_trace_spans_emitted_total"]
    assert after["spgemm_events_emitted_total"] >= before["spgemm_events_emitted_total"] + 3
    resp = client.events_info(50, d.socket_path)
    assert _kinds(resp["events"], job["id"]) == ["job_submit", "job_start", "job_done"]
    assert resp["log"]["path"] == d.events_path
    start = next(e for e in resp["events"] if e["kind"] == "job_start")
    assert start["trace_id"] == job["trace"] and start["slice"] == "s0w1"
    assert start["degraded"] is False and start["folder"] == folder
    evs = client.trace(d.socket_path)
    tagged = {e["name"] for e in evs if e["ph"] == "X" and e["args"].get("job_id") == job["id"]}
    assert {"serve_execute", "serve_load", "serve_chain", "serve_write", "plan", "upload",
            "numeric_dispatch"} <= tagged
    st = client.stats(d.socket_path)
    assert st["trace"]["emitted"] > 0 and st["events"]["path"] == d.events_path
    assert st["flight_dir"] == d.flight_dir
    with pytest.raises(client.ServeError) as ei:
        client.request({"op": "events", "n": "x"}, d.socket_path)
    assert ei.value.code == protocol.E_BAD_REQUEST


def test_the_events_file_holds_the_lifecycle_after_shutdown(tmp_path):
    folder, _ = _chain_folder(tmp_path)
    d = Daemon(str(tmp_path / "d.sock"), device="cpu")
    d.start()
    try:
        job = _run(d, folder, str(tmp_path / "out"))
    finally:
        d.stop()  # flushes the writer
    recs = [json.loads(line) for line in open(d.events_path)]
    kinds = [r["kind"] for r in recs]
    assert kinds[0] == "daemon_start"
    assert _kinds(recs, job["id"]) == ["job_submit", "job_start", "job_done"]
    assert [r["seq"] for r in recs] == sorted(r["seq"] for r in recs)


def test_a_jobs_spans_nest_under_its_execute_and_the_planner_carries_its_tags(
        tmp_path, make_daemon, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", "2")
    folder, _ = _chain_folder(tmp_path, n=5)
    d = make_daemon()
    tid = "ab" * 16
    job = _run(d, folder, str(tmp_path / "out"), trace_id=tid)
    spans = [e for e in client.trace(d.socket_path)
             if e["ph"] == "X" and e["args"].get("job_id") == job["id"]]
    by_id = {e["args"]["span_id"]: e for e in spans}
    (execute,) = [e for e in spans if e["name"] == "serve_execute"]

    def under_execute(e):
        while e is not None:
            if e is execute:
                return True
            e = by_id.get(e["args"].get("parent"))
        return False

    assert all(e["args"]["trace_id"] == tid and e["args"]["slice"] == "s0w1" for e in spans)
    for name in ("upload", "numeric_dispatch", "plan_wait", "serve_chain"):
        got = [e for e in spans if e["name"] == name]
        assert got and all(under_execute(e) for e in got), name
    plans = [e for e in spans if e["name"] == "plan"]
    assert {e["tid"] for e in plans} != {execute["tid"]}  # the planner thread's
    lo, hi = execute["ts"], execute["ts"] + execute["dur"]
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi + 1.0 for e in plans)


def test_a_trace_runs_from_the_client_through_a_cli_daemon(tmp_path):
    """The CLI's serve, metrics, events and trace-dump on one --device cpu
    daemon in its own process: the client's client_submit span and the
    daemon's spans merge into one trace on the job's trace id."""
    folder, want = _chain_folder(tmp_path, seed=3)
    sock = str(tmp_path / "cli.sock")
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("SPGEMM_TPU_DELTA", None)
    cli = [sys.executable, "-m", "spgemm_tpu_torch.cli"]
    proc = subprocess.Popen([*cli, "serve", "--device", "cpu", "--socket", sock], env=env,
                            cwd=str(tmp_path), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        _wait_until(lambda: os.path.exists(sock) or proc.poll() is not None, 120, "the socket")
        tid = "cd" * 16
        j = client.submit(folder, sock, {"output": str(tmp_path / "out")}, trace=tid)
        job = client.wait(j["id"], sock, timeout=120)["job"]
        assert job["state"] == "done" and open(tmp_path / "out", "rb").read() == want
        dumps = tmp_path / "dumps"
        trace.dump_json(str(dumps / "client.trace.json"), process_name="client")

        def run(*args):
            r = subprocess.run([*cli, *args, "--socket", sock], env=env, cwd=str(tmp_path),
                               capture_output=True, text=True, timeout=120)
            assert r.returncode == 0, r.stderr
            return r.stdout

        text = run("metrics")
        assert _series(text)['spgemmd_jobs_terminal_total{outcome="done"}'] == 1
        lines = [json.loads(line) for line in run("events", "--tail", "20").splitlines()]
        assert _kinds(lines, job["id"]) == ["job_submit", "job_start", "job_done"]
        run("trace-dump", "-o", str(dumps / "daemon.trace.json"))
        merged_path = str(tmp_path / "merged.json")
        run("trace-dump", "--merge", str(dumps), "--trace", tid, "-o", merged_path)
        merged = json.load(open(merged_path))
        spans = [e for e in merged if e["ph"] == "X"]
        assert {e["args"]["trace_id"] for e in spans} == {tid}
        names = {e["name"] for e in spans}
        assert {"client_submit", "serve_execute", "numeric_dispatch"} <= names
        assert len({e["pid"] for e in spans}) == 2  # a track per process
        client_span = next(e for e in spans if e["name"] == "client_submit")
        execute = next(e for e in spans if e["name"] == "serve_execute")
        # one wall-clock axis: the daemon's execute starts inside the
        # client's round trip (the submit answers at admission)
        assert execute["ts"] >= client_span["ts"] - 5e5
    finally:
        if proc.poll() is None:
            client.shutdown(sock)
            proc.wait(timeout=60)
    assert proc.returncode == 0, proc.stderr.read()


def _cli_json(sock: str, *args) -> dict:
    """A client subcommand of the CLI in its own process, its --json answer."""
    r = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", *args, "--socket", sock,
                        "--json"], env={**os.environ, "PYTHONPATH": REPO},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


def test_the_profile_and_slo_ops_and_subcommands_serve(tmp_path, make_daemon):
    """After one real job: the profile report has the JAX package's keys,
    one delta observation per multiply (a first contact's full fallbacks),
    the job's phases in the histograms, no device memory on the CPU; the
    slo report counts the job for its tenant; `cli profile` and `cli slo`,
    with and without --json, answer from their own processes."""
    folder, want = _chain_folder(tmp_path, n=4)
    d = make_daemon()
    job = _run(d, folder, str(tmp_path / "out"))
    assert job["state"] == "done" and open(tmp_path / "out", "rb").read() == want
    assert "hbm_peak_bytes" not in job["detail"]  # the CPU reports no device memory
    rep = client.profile(d.socket_path)
    assert set(rep) == set(jax_profile.report())
    assert rep["delta"]["count"] == 3 and rep["delta"]["mispredictions"] == 0
    assert rep["delta"]["dirty_fraction"]["buckets"]["0.9"] == 0  # 1.0 each: full fallbacks
    assert rep["memory"]["available"] is False
    assert {"plan", "serve_execute", "serve_chain"} <= set(profile.phase_stats())
    rep = client.slo(d.socket_path)
    assert set(rep) == set(jax_slo.SLO.report())
    row = rep["tenants"]["default"]
    assert row["jobs"] == 1 and row["errors"] == 0 and row["error_ratio"] == 0
    assert set(row["latency_s"]) == {"p50", "p95", "p99"}
    assert rep["objectives"]["enabled"] is False and rep["burn"][0]["slice"] == "s0w1"
    st = client.stats(d.socket_path)
    assert st["profile"]["delta_observations"] == 3 and st["slo"]["records"] == 1
    s = _series(client.metrics(d.socket_path))
    assert s['spgemm_slo_error_ratio{tenant="default"}'] == 0
    assert s['spgemm_slo_burn_active{slice="s0w1",tenant="default"}'] == 0
    assert s["spgemm_delta_dirty_fraction_count"] == 3 and "spgemm_hbm_peak_bytes" not in s
    assert _cli_json(d.socket_path, "profile")["delta"]["count"] == 3
    assert _cli_json(d.socket_path, "slo")["tenants"]["default"]["jobs"] == 1
    env = {**os.environ, "PYTHONPATH": REPO}
    for sub, line in (("profile", "delta: x3"), ("slo", "tenant default: jobs=1")):
        r = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", sub, "--socket",
                            d.socket_path], env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0 and line in r.stdout, (r.stdout, r.stderr)


def test_a_wedged_pickup_burns_the_slo_with_the_clients_trace_id(tmp_path, make_daemon,
                                                                   monkeypatch):
    """With objectives declared and serve.executor armed to hang once, the
    reaped job is a bad event: spgemm_slo_burn_active{tenant, slice} reads
    1, one slo_burn event and the slo report's burning window carry the
    trace id the client minted; once the window ends (the knob shortened
    to 1 s, as an operator may) a read clears it with slo_burn_clear."""
    folder, _ = _chain_folder(tmp_path)
    monkeypatch.setenv("SPGEMM_TPU_SLO_TARGET_S", "60")
    monkeypatch.setenv("SPGEMM_TPU_SLO_WINDOW_S", "600")
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "serve.executor:1:1")
    d = make_daemon(runner=lambda job, degraded=False: None, job_timeout_s=0.3,
                    wedge_grace_s=120)
    try:
        resp = client.submit(folder, d.socket_path, {"output": str(tmp_path / "o")})
        minted = resp["trace"]
        assert isinstance(minted, str) and len(minted) == 32
        job = client.wait(resp["id"], d.socket_path, timeout=120)["job"]
        assert job["error"]["code"] == protocol.E_JOB_TIMEOUT
        s = _series(client.metrics(d.socket_path))
        assert s['spgemm_slo_burn_active{slice="s0w1",tenant="default"}'] == 1
        assert s['spgemm_slo_error_ratio{tenant="default"}'] == 1
        burns = [e for e in client.events(200, d.socket_path) if e["kind"] == "slo_burn"]
        assert len(burns) == 1 and burns[0]["trace_id"] == minted
        assert (burns[0]["tenant"], burns[0]["slice"], burns[0]["bad"]) == ("default", "s0w1", 1)
        (burn,) = client.slo(d.socket_path)["burn"]
        assert burn["active"] and burn["trace_id"] == minted
    finally:
        monkeypatch.delenv("SPGEMM_TPU_FAILPOINTS")  # the hang ends
    monkeypatch.setenv("SPGEMM_TPU_SLO_WINDOW_S", "1")
    time.sleep(1.2)
    (burn,) = client.slo(d.socket_path)["burn"]
    assert burn["active"] is False
    kinds = [e["kind"] for e in client.events(200, d.socket_path)
             if e["kind"].startswith("slo_burn")]
    assert kinds == ["slo_burn", "slo_burn_clear"]
    s = _series(client.metrics(d.socket_path))
    assert s['spgemm_slo_burn_active{slice="s0w1",tenant="default"}'] == 0


def test_a_jobs_detail_carries_its_device_memory_peak(tmp_path, make_daemon, monkeypatch):
    """Readings pushed on the executor thread land in the job's own window
    (its span tag): a solo job's detail reports the highest; under a batch
    every member's window opens at pickup with the newest reading, the
    batch's readings land in the head's window (its spans carry the head's
    id), and a mate reports the reading at its pickup.  Each member is its
    own SLO record."""
    folder, _ = _chain_folder(tmp_path)
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    readings = iter([800, 2000, 5000])

    def push():
        profile.observe_memory({"bytes_in_use": next(readings)})

    def runner(job, degraded=False):
        push()
        push()

    d = make_daemon(runner=runner, batch_runner=lambda jobs, degraded=False: push())
    solo = _run(d, folder, str(tmp_path / "o"))
    assert solo["detail"]["hbm_peak_bytes"] == 2000
    plancache.note_chain_structure(placement.signature(folder), "fp-test")
    monkeypatch.setenv("SPGEMM_TPU_SERVE_BATCH_WINDOW_S", "0.5")
    monkeypatch.setenv("SPGEMM_TPU_SERVE_BATCH_K", "8")
    gate = threading.Event()
    d._runner = lambda job, degraded=False: gate.wait(60)  # holds the executor
    blocker = client.submit(_chain_folder(tmp_path, seed=9, name="blocker")[0], d.socket_path,
                            {"output": str(tmp_path / "b")})["id"]
    ids = [client.submit(folder, d.socket_path, {"output": str(tmp_path / f"o{i}")},
                         tenant="acme")["id"] for i in range(3)]
    gate.set()
    client.wait(blocker, d.socket_path, timeout=60)
    jobs = [client.wait(i, d.socket_path, timeout=60)["job"] for i in ids]
    assert [j["batch"] for j in jobs] == [ids[0]] * 3
    assert [j["detail"]["hbm_peak_bytes"] for j in jobs] == [5000, 2000, 2000]
    assert profile.memory_stats()["peak_bytes"] == 5000
    assert client.slo(d.socket_path)["tenants"]["acme"]["jobs"] == 3


def test_the_obs_smoke_passes_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "TMPDIR": str(tmp_path)}
    r = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.serve.obs_smoke", "--device",
                        "cpu"], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "obs-smoke: OK" in r.stdout and "burn leg OK" in r.stdout


# ------------------------------------------------------ watchdog, dumps --
def test_a_reap_and_a_wedge_write_events_and_flight_dumps(tmp_path, make_daemon, capfd):
    folder, _ = _chain_folder(tmp_path)
    gate, entered = threading.Event(), threading.Event()
    probing, probe_go = threading.Event(), threading.Event()

    def probe():
        probing.set()
        probe_go.wait(120)
        return "cpu"  # a live probe on a CPU daemon

    d = make_daemon(runner=_gated_runner(gate, entered), job_timeout_s=0.2,
                    wedge_grace_s=0.2, probe=probe)
    try:
        j1 = client.wait(client.submit(folder, d.socket_path)["id"], d.socket_path,
                         timeout=120)["job"]
        assert j1["error"]["code"] == protocol.E_JOB_TIMEOUT
        assert probing.wait(120)  # reaped, wedged, degraded: the probe is out
        gate.set()
        probe_go.set()
        _wait_until(lambda: not client.stats(d.socket_path)["degraded"], msg="reinstatement")
        canary = client.wait(client.submit(folder, d.socket_path)["id"], d.socket_path,
                             timeout=120)["job"]
        assert canary["state"] == "done"
        _wait_until(lambda: "slice_canary_passed" in _kinds(client.events(100, d.socket_path)),
                    msg="the canary's settle")
    finally:
        gate.set()
        probe_go.set()
    kinds = _kinds(client.events(100, d.socket_path))
    order = ["job_submit", "job_start", "watchdog_reap", "watchdog_wedge", "daemon_degrade",
             "slice_recovered", "job_submit", "slice_canary", "job_start", "job_done",
             "slice_canary_passed"]
    it = iter(kinds)
    assert all(k in it for k in order), kinds  # in this order, maybe with others between
    reap = next(e for e in client.events(100, d.socket_path) if e["kind"] == "watchdog_reap")
    assert reap["job_id"] == j1["id"] and reap["trace_id"] == j1["trace"]
    dumps = sorted(os.listdir(d.flight_dir))
    assert dumps == sorted([f"{j1['id']}.trace.json", f"{j1['id']}.wedged.trace.json",
                            "degrade.trace.json"])
    reaped = json.load(open(os.path.join(d.flight_dir, f"{j1['id']}.trace.json")))
    names = {(e["name"], e["ph"]) for e in reaped if e["args"].get("job_id") == j1["id"]}
    assert ("serve_load", "X") in names and ("serve_reap", "i") in names
    degrade = json.load(open(os.path.join(d.flight_dir, "degrade.trace.json")))
    assert any(e["name"] == "serve_degrade" and e["ph"] == "i" for e in degrade)
    text = client.metrics(d.socket_path)
    s = _series(text)
    assert s['spgemmd_jobs_terminal_total{outcome="timeout"}'] == 1
    assert s['spgemm_slice_recoveries_total{slice="s0w1"}'] == 1
    assert s['spgemm_engine_events_total{event="serve_degrades"}'] >= 1


def test_executor_death_dumps_the_orphans_flight(tmp_path, make_daemon):
    folder, _ = _chain_folder(tmp_path)
    started = threading.Event()

    def runner(job, degraded=False):
        if not degraded:
            started.set()
            raise KeyboardInterrupt  # kills the executor thread (not an Exception)

    d = make_daemon(runner=runner, probe=lambda: "timeout")
    j = client.wait(client.submit(folder, d.socket_path)["id"], d.socket_path,
                    timeout=120)["job"]
    assert j["error"]["code"] == protocol.E_EXECUTOR_DIED
    _wait_until(lambda: os.path.exists(os.path.join(d.flight_dir, "degrade.trace.json")),
                msg="the degrade's dump")
    assert os.path.exists(os.path.join(d.flight_dir, f"{j['id']}.trace.json"))
    kinds = _kinds(client.events(50, d.socket_path), j["id"])
    assert kinds == ["job_submit", "job_start", "job_failed"]


def test_the_flight_directory_stays_bounded(tmp_path, make_daemon, monkeypatch):
    monkeypatch.setattr(Daemon, "FLIGHT_RETAIN", 3)
    d = make_daemon()
    os.makedirs(d.flight_dir)
    old = os.path.join(d.flight_dir, "old.trace.json")
    open(old, "w").write("[]")
    os.utime(old, (1, 1))  # a previous daemon's dump: pruned first
    for name in ("a", "b", "c", "d"):
        assert d._flight_dump(name) == os.path.join(d.flight_dir, f"{name}.trace.json")
    assert sorted(os.listdir(d.flight_dir)) == ["b.trace.json", "c.trace.json", "d.trace.json"]
    d._flight_dump("b")  # a re-dump is the newest
    d._flight_dump("e")
    assert sorted(os.listdir(d.flight_dir)) == ["b.trace.json", "d.trace.json", "e.trace.json"]


def test_a_failed_flight_dump_is_a_warning_not_a_crash(tmp_path, make_daemon):
    d = make_daemon()
    open(d.flight_dir, "w").write("a file where the directory goes")
    assert d._flight_dump("x") is None


def test_a_failpoint_reaches_the_scrape_and_the_event_log(tmp_path, make_daemon, monkeypatch):
    folder, _ = _chain_folder(tmp_path)
    d = make_daemon()
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "kernel.dispatch:1:1")
    job = _run(d, folder, str(tmp_path / "out"))
    assert job["state"] == "failed" and "FailpointTriggered" in job["error"]["message"]
    s = _series(client.metrics(d.socket_path))
    assert s['spgemm_failpoints_triggered_total{point="kernel.dispatch"}'] == 1
    assert s['spgemmd_jobs_terminal_total{outcome="error"}'] == 1
    evs = client.events(50, d.socket_path)
    fp = next(e for e in evs if e["kind"] == "failpoint_trigger")
    assert fp["point"] == "kernel.dispatch" and fp["action"] == "raise"
    assert fp["job_id"] == job["id"]  # emitted inside the job's tags
    failed = next(e for e in evs if e["kind"] == "job_failed")
    assert failed["job_id"] == job["id"] and "FailpointTriggered" in failed["error"]


def test_the_batch_size_family_renders_once_an_armed_window_sampled(tmp_path, make_daemon,
                                                                    monkeypatch):
    folder, _ = _chain_folder(tmp_path)
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    d = make_daemon(runner=lambda job, degraded=False: None)
    assert _run(d, folder, "x")["state"] == "done"  # window 0: nothing sampled
    assert "spgemm_serve_batch_size" not in client.metrics(d.socket_path)
    # the folder's structure recorded (as a real runner records it): a group key
    plancache.note_chain_structure(placement.signature(folder), "fp-test")
    monkeypatch.setenv("SPGEMM_TPU_SERVE_BATCH_WINDOW_S", "0.05")
    assert _run(d, folder, "x")["state"] == "done"
    s = _series(client.metrics(d.socket_path))
    assert s["spgemm_serve_batch_size_count"] == 1 and s["spgemm_serve_batch_size_sum"] == 1
    assert s['spgemm_serve_batch_size_bucket{le="1"}'] == 1


def test_obs_off_leaves_the_daemon_serving(tmp_path, make_daemon, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_OBS_TRACE", "0")
    monkeypatch.setenv("SPGEMM_TPU_OBS_EVENTS", "0")
    folder, want = _chain_folder(tmp_path)
    d = make_daemon()
    assert _run(d, folder, str(tmp_path / "out"))["state"] == "done"
    assert open(tmp_path / "out", "rb").read() == want
    assert client.events(50, d.socket_path) == []
    assert [e for e in client.trace(d.socket_path) if e["ph"] != "M"] == []
    assert _series(client.metrics(d.socket_path))["spgemm_trace_spans"] == 0


def test_the_jax_client_reads_the_port_daemons_obs_ops(tmp_path, make_daemon):
    folder, _ = _chain_folder(tmp_path)
    d = make_daemon()
    j = jax_client.submit(folder, d.socket_path, {"output": str(tmp_path / "out")})
    assert jax_client.wait(j["id"], d.socket_path, timeout=120)["job"]["state"] == "done"
    assert "spgemmd_jobs_terminal_total" in jax_client.metrics(d.socket_path)
    assert _kinds(jax_client.events(20, d.socket_path), j["id"]) == \
        ["job_submit", "job_start", "job_done"]
    assert any(e["args"].get("trace_id") == j["trace"]
               for e in jax_client.trace(d.socket_path) if e["ph"] == "X")


# ---------------------------------------------------- the slice as a whole --
def test_a_chain_through_both_daemons_gives_the_same_bytes_and_lifecycle(tmp_path, make_daemon,
                                                                         monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")  # the reference's delta fault (ROADMAP 3)
    folder, want = _chain_folder(tmp_path, n=5, seed=11)
    d = make_daemon()
    tid = "ef" * 16
    port_job = _run(d, folder, str(tmp_path / "port.out"), trace_id=tid)
    port_kinds = [e["kind"] for e in client.events(100, d.socket_path)
                  if e.get("trace_id") == tid and e["kind"] in LIFECYCLE]
    port_dump = trace.dump_json(str(tmp_path / "dumps" / "port.trace.json"), process_name="port")
    jax_events.LOG.clear()
    jd = jax_daemon.Daemon(str(tmp_path / "jax.sock"))
    jd.start()
    try:
        jtid = "0f" * 16
        j = jax_client.submit(folder, jd.socket_path, {"output": str(tmp_path / "jax.out")},
                              trace=jtid)
        jax_job = jax_client.wait(j["id"], jd.socket_path, timeout=300)["job"]
        jax_kinds = _kinds(jax_client.events(100, jd.socket_path), j["id"])
        jax_dump = jax_trace.dump_json(str(tmp_path / "dumps" / "jax.trace.json"),
                                       process_name="jax")
    finally:
        jd.stop()
    assert port_job["state"] == jax_job["state"] == "done"
    assert open(tmp_path / "port.out", "rb").read() == open(tmp_path / "jax.out", "rb").read() \
        == want
    assert port_kinds == jax_kinds == ["job_submit", "job_start", "job_done"]
    # the two daemons' dumps stitch into one trace with either package's tool
    for merge in (trace.merge_trace_files, jax_trace.merge_trace_files):
        merged = merge([port_dump, jax_dump])
        execs = [e for e in merged if e["ph"] == "X" and e["name"] == "serve_execute"
                 and e["args"].get("trace_id") in (tid, jtid)]
        assert {e["args"]["trace_id"] for e in execs} == {tid, jtid}
        assert len({e["pid"] for e in execs}) == 2
