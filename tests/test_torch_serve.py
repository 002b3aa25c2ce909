"""spgemmd on the port (spgemm_tpu_torch/serve/, parallel/mesh.py, the
CLI's serve/submit/status), on the CPU: the wire protocol, the journal's
framing, the slice table and the serve knobs against the JAX package's;
the fair queue's order and caps; a port daemon on device="cpu" against the
oracle, the JAX daemon (under SPGEMM_TPU_DELTA=0, clear of the reference's
delta fault) and the JAX package's own client; journal replay; the
watchdog's reap, wedge, death, degrade and recovery with injected runners
driven by threading.Events; the degraded runner's arithmetic; the five ops
not served yet; and the CLI.  Inputs from numpy seeds at small sizes.
Tolerance: byte equality everywhere."""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from spgemm_tpu.parallel import mesh as jax_mesh
from spgemm_tpu.serve import client as jax_client
from spgemm_tpu.serve import daemon as jax_daemon
from spgemm_tpu.serve import protocol as jax_protocol
from spgemm_tpu.serve import queue as jax_queue
from spgemm_tpu.utils import knobs as jax_knobs
from spgemm_tpu_torch.ops import delta, plancache, warmstore
from spgemm_tpu_torch.parallel import mesh
from spgemm_tpu_torch.serve import client, placement, protocol
from spgemm_tpu_torch.serve import daemon as daemon_mod
from spgemm_tpu_torch.serve.daemon import Daemon, journal_frame, journal_parse_line
from spgemm_tpu_torch.serve.queue import (TERMINAL, Job, JobAbandoned, JobQueue, QueueFull,
                                          TenantCapExceeded)
from spgemm_tpu_torch.utils import failpoints, io_text, knobs
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import random_chain
from spgemm_tpu_torch.utils.semantics import chain_oracle, field_spgemm_oracle
from spgemm_tpu_torch.utils.timers import ENGINE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("SPGEMM_TPU_FAILPOINTS", raising=False)
    for name in ("SPGEMM_TPU_WARM_DIR", "SPGEMM_TPU_SERVE_ADDR", "SPGEMM_TPU_SERVE_SLICES",
                 "SPGEMM_TPU_DELTA"):
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
    """Port daemons on device="cpu", bound to per-test sockets, stopped at
    teardown."""
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


def _oracle_bytes(mats, k, multiply=None) -> bytes:
    kw = {} if multiply is None else {"multiply": multiply}
    blocks = chain_oracle([m.to_dict() for m in mats], k, **kw)
    return io_text.format_matrix(
        BlockSparseMatrix.from_dict(mats[0].rows, mats[-1].cols, k, blocks).prune_zeros())


def _chain_folder(tmp_path, n=3, k=2, seed=7, name="chain_in", dist="full"):
    """A chain input directory, its matrices and the oracle's bytes."""
    mats = random_chain(n, 4, k, 0.5, np.random.default_rng(seed), dist)
    folder = str(tmp_path / name)
    io_text.write_chain_dir(folder, mats, k)
    return folder, mats, _oracle_bytes(mats, k)


def _raw_roundtrip(sock_path, payload: bytes) -> dict:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(30.0)
        s.connect(sock_path)
        try:
            s.sendall(payload)
        except BrokenPipeError:
            pass
        for line in protocol.read_lines(s):
            return json.loads(line)
    raise AssertionError("no response line")


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


# ------------------------------------------------------------- protocol --
def test_the_wire_tables_are_the_jax_tables():
    assert protocol.PROTOCOL_VERSION == jax_protocol.PROTOCOL_VERSION
    assert protocol.ACCEPTED_VERSIONS == jax_protocol.ACCEPTED_VERSIONS
    assert protocol.OPS == jax_protocol.OPS
    assert protocol.REQUEST_FIELDS == jax_protocol.REQUEST_FIELDS
    assert protocol.FIELD_MIN_VERSION == jax_protocol.FIELD_MIN_VERSION
    assert protocol.ERROR_CODES == jax_protocol.ERROR_CODES
    assert protocol.MAX_LINE_BYTES == jax_protocol.MAX_LINE_BYTES
    for name in ("E_BAD_REQUEST", "E_QUEUE_FULL", "E_TENANT_CAP", "E_BUSY", "E_UNKNOWN_JOB",
                 "E_SHUTTING_DOWN", "E_INTERNAL", "E_UNAVAILABLE", "E_JOB_TIMEOUT",
                 "E_EXECUTOR_DIED", "E_JOB_ERROR"):
        assert getattr(protocol, name) == getattr(jax_protocol, name), name


_MESSAGES = [
    {"op": "stats"},
    {"v": 4, "ok": True, "id": "job-1", "state": "queued", "queued": 1},
    {"v": 2, "op": "submit", "folder": "/tmp/a b/é", "options": {"round_size": 4},
     "tenant": "t-1"},
    protocol.error(protocol.E_QUEUE_FULL, "queue full", id=None),
    {"nested": [1, 2.5, None, True, {"x": "y\n"}]},
]


@pytest.mark.parametrize("msg", _MESSAGES)
def test_encode_gives_the_jax_bytes(msg):
    assert protocol.encode(msg) == jax_protocol.encode(msg)


_LINES = [
    '{"v": 4, "op": "stats"}', '{"v": 1, "op": "submit", "folder": "x"}',
    '{"v": 3, "op": "wait", "id": "job-2", "timeout": 1}', '{"v": 4, "op": "metrics"}',
    "not json", "[1, 2]", '"str"', '{"op": "stats"}', '{"v": 99, "op": "stats"}',
    '{"v": 4, "op": "frobnicate"}', '{"v": 4}', '{"v": "4", "op": "stats"}', "",
]


@pytest.mark.parametrize("line", _LINES)
def test_parse_request_accepts_and_refuses_as_the_jax_module(line):
    def outcome(mod):
        try:
            return ("ok", mod.parse_request(line))
        except mod.ProtocolError as e:
            return ("refused", e.code, e.message)

    assert outcome(protocol) == outcome(jax_protocol)


@pytest.mark.parametrize("spec", ["tcp:127.0.0.1:7463", "tcp:[::1]:0", "tcp:host:65535",
                                  "unix:/tmp/s", "/tmp/plain.sock", "tcp:host:x",
                                  "tcp::80", "tcp:h:70000", "unix:", "", "tcp:nohost"])
def test_parse_addr_as_the_jax_module(spec):
    def outcome(mod):
        try:
            return mod.parse_addr(spec)
        except ValueError as e:
            return str(e)

    assert outcome(protocol) == outcome(jax_protocol)


@pytest.mark.parametrize("value", ["default", "a.b:c-d_e", "x" * 64, "x" * 65, "", "a b",
                                   'q"', 7, None, "0" * 32, "f" * 32, "F" * 32, "0" * 31])
def test_tenant_and_trace_validators_as_the_jax_module(value):
    assert protocol.valid_tenant(value) == jax_protocol.valid_tenant(value)
    assert protocol.valid_trace(value) == jax_protocol.valid_trace(value)


def test_version_negotiation_as_the_jax_module():
    for msg in ({"op": "stats"}, {"op": "submit", "tenant": "t"},
                {"op": "submit", "tenant": "t", "trace": "0" * 32}, {"op": "submit",
                                                                   "tenant": None}):
        assert protocol.version_for(msg) == jax_protocol.version_for(msg)
        for v in (1, 2, 3, 4):
            assert protocol.strip_for_version(msg, v) == jax_protocol.strip_for_version(msg, v)
    for message in ("protocol version mismatch: daemon speaks v2 (accepts v1/v2), x",
                    "tenant 'accepts v1/v2' bad", "protocol version mismatch: nothing"):
        assert protocol.accepted_from_error(message) == \
            jax_protocol.accepted_from_error(message)


def test_read_lines_as_the_jax_module():
    for mod in (protocol, jax_protocol):
        a, b = socket.socketpair()
        a.sendall(b'{"v":4}\n\xff\xfe\n{"tail": no newline')
        a.close()
        assert list(mod.read_lines(b, bufsize=3)) == ['{"v":4}', "��"]
        b.close()
        a, b = socket.socketpair()
        a.sendall(b"x" * 100)
        with pytest.raises(mod.ProtocolError):
            list(mod.read_lines(b, bufsize=16, max_line=50))
        a.close()
        b.close()


@pytest.mark.parametrize("name,values", [
    ("SPGEMM_TPU_SERVE_SOCKET", ["", "/tmp/s.sock"]),
    ("SPGEMM_TPU_SERVE_ADDR", ["", "tcp:127.0.0.1:0", " x "]),
    ("SPGEMM_TPU_SERVE_SLICES", ["", "1", "auto", "2x1+1*"]),
    ("SPGEMM_TPU_SERVE_TENANT_INFLIGHT", ["", "3", "0", "x"]),
    ("SPGEMM_TPU_SERVE_QUEUE_CAP", ["", "5", "0", "-1"]),
    ("SPGEMM_TPU_SERVE_JOB_TIMEOUT", ["", "0", "2.5", "-1", "x"]),
    ("SPGEMM_TPU_SERVE_RECOVER_S", ["", "0", "1.5", "-0.5"]),
    ("SPGEMM_TPU_SERVE_WEDGE_GRACE_S", ["", "7.5", "-1"]),
    ("SPGEMM_TPU_SERVE_BATCH_K", ["", "1", "8", "0", "x"]),
    ("SPGEMM_TPU_SERVE_BATCH_WINDOW_S", ["", "0", "0.5", "-0.1", "x"]),
    ("SPGEMM_TPU_FAILPOINTS", ["", "plan.build:1:1"]),
])
def test_serve_knobs_parse_like_jax(name, values, monkeypatch):
    for value in values:
        monkeypatch.setenv(name, value)
        try:
            want = jax_knobs.get(name)
        except ValueError:
            with pytest.raises(ValueError, match=name):
                knobs.get(name)
            continue
        assert knobs.get(name) == want, value


# -------------------------------------------------------------- journal --
_EVENTS = [
    {"event": "submit", "id": "job-1", "folder": "/tmp/f", "output": "/tmp/f/matrix",
     "options": {"backend": "mxu"}, "timeout_s": 0.0, "tenant": "default",
     "trace": "0" * 32},
    {"event": "done", "id": "job-1"},
    {"event": "failed", "id": "job-é2"},
]


@pytest.mark.parametrize("event", _EVENTS)
def test_journal_frame_gives_the_jax_bytes(event):
    line = journal_frame(event)
    assert line == jax_daemon.journal_frame(event)
    assert journal_parse_line(line.strip()) == event


@pytest.mark.parametrize("line", ["{\"event\": \"done\", \"id\": \"j\"}", "{broken",
                                  "00000000 3 abc", "zz 1 x", "1 2", "",
                                  journal_frame({"event": "done", "id": "j"})[:-5]])
def test_journal_parse_line_as_the_jax_module(line):
    assert journal_parse_line(line) == jax_daemon.journal_parse_line(line)


@pytest.mark.parametrize("tear", [0, 1, 3])
def test_torn_journals_truncate_at_the_jax_record(tmp_path, tear):
    lines = [journal_frame({"event": "submit", "id": f"job-{i}", "folder": "f",
                            "output": "o"}) for i in range(1, 5)]
    lines += [journal_frame({"event": "done", "id": "job-1"})]
    lines[tear] = lines[tear][:len(lines[tear]) // 2] + "\n"  # a record cut mid-write
    results = []
    for mod in (daemon_mod, jax_daemon):
        sock = str(tmp_path / f"{mod.__name__.split('.')[0]}.sock")
        with open(sock + ".journal", "w", encoding="utf-8") as f:
            f.writelines(lines)
        d = mod.Daemon(sock, runner=lambda job, degraded=False: None)
        results.append(d._journal_live_records())
    assert results[0] == results[1] and results[0][1] == 1


# --------------------------------------------------------- queue and mesh --
def test_queue_fifo_caps_and_first_write_wins():
    q = JobQueue(cap=2)
    a, b = Job("a", "f", "o", {}), Job("b", "f", "o", {})
    assert q.submit(a) == 1 and q.submit(b) == 2
    with pytest.raises(QueueFull):
        q.submit(Job("c", "f", "o", {}))
    assert q.next(0.01) is a and q.next(0.01) is b and q.next(0.01) is None
    a.start()
    assert a.finish("done") and not a.finish("failed") and a.state == "done"
    assert q.counts() == {"queued": 1, "running": 0, "done": 1, "failed": 0, "depth": 0}


@pytest.mark.parametrize("order", ["aaabbc", "abcabc", "aaaaab", "cbaaab"])
def test_the_fair_order_is_the_jax_order(order):
    pops = []
    for jq, mod in ((JobQueue, None), (jax_queue.JobQueue, jax_queue)):
        q = jq(cap=64)
        make = Job if mod is None else mod.Job
        for i, t in enumerate(order):
            q.submit(make(f"{t}{i}", "f", "o", {}, tenant=t))
        got = []
        while (job := q.next(0.01)) is not None:
            got.append(job.id)
        pops.append(got)
    assert pops[0] == pops[1]
    first_round = {job[0] for job in pops[0][:len(set(order))]}
    assert first_round == set(order)  # every tenant is served in the first round


def test_the_tenant_cap_and_release(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_SERVE_TENANT_INFLIGHT", "2")
    q = JobQueue(cap=10)
    jobs = [Job(f"j{i}", "f", "o", {}, tenant="t") for i in range(2)]
    for j in jobs:
        q.submit(j)
    with pytest.raises(TenantCapExceeded) as ei:
        q.submit(Job("j2", "f", "o", {}, tenant="t"))
    assert ei.value.cap == 2
    q.submit(Job("u0", "f", "o", {}, tenant="u"))  # another tenant is not held back
    q.next(0.01)
    jobs[0].start()
    jobs[0].finish("done")
    q.release(jobs[0])
    q.release(jobs[0])  # idempotent
    q.release(Job("never", "f", "o", {}, tenant="t"))  # never admitted: no slot freed
    q.submit(Job("j3", "f", "o", {}, tenant="t"))
    with pytest.raises(TenantCapExceeded):
        q.submit(Job("j4", "f", "o", {}, tenant="t"))
    assert q.tenants()["t"]["inflight"] == 2


def test_terminal_jobs_are_evicted_past_retention(monkeypatch):
    monkeypatch.setattr(JobQueue, "RETAIN_TERMINAL", 2)
    q = JobQueue(cap=10)
    jobs = [Job(f"j{i}", "f", "o", {}) for i in range(5)]
    for j in jobs[:4]:
        q.submit(j)
        assert q.next(0.01) is j
        j.start()
        j.finish("done")
    q.submit(jobs[4])
    assert q.get("j0") is None and q.get("j1") is None
    assert q.get("j2") is jobs[2] and q.get("j4") is jobs[4]


def test_job_abandoned_pierces_an_exception_catch():
    assert not issubclass(JobAbandoned, Exception)


@pytest.mark.parametrize("spec,n", [("1", 1), ("auto", 1), ("2", 2), ("1*", 1),
                                    ("2x1+1*", 3), ("3", 2), ("1x4", 8), ("auto", 4),
                                    ("bad", 1), ("0", 1), ("", 1), ("1x1+1x2", 4)])
def test_the_slice_spec_parses_as_the_jax_module(spec, n):
    def outcome(mod):
        try:
            return mod.parse_slice_spec(spec, n)
        except mod.SliceSpecError as e:
            return str(e)

    assert outcome(mesh) == outcome(jax_mesh)


@pytest.mark.parametrize("spec,n", [("1", 1), ("auto", 1), ("2", 2), ("2x1+1*", 3)])
def test_single_device_pools_are_the_jax_pools(spec, n):
    assert mesh.slice_pool(spec, n) == [
        mesh.DeviceSlice(s.name, s.index, s.device_ids, s.default)
        for s in jax_mesh.slice_pool(spec, n)]


@pytest.mark.parametrize("spec,n,fragment", [("1x4", 4, "rowshard"), ("auto", 4, "rowshard"),
                                             ("1+1x2", 3, "rowshard"), ("1x4", 1, "rowshard"),
                                             ("2", 1, "only 1 are visible")])
def test_wide_or_overcommitted_slices_raise(spec, n, fragment):
    with pytest.raises(mesh.SliceSpecError, match=fragment):
        mesh.slice_pool(spec, n)


def test_the_daemon_serves_one_slice(tmp_path):
    d = Daemon(str(tmp_path / "a.sock"), slices="auto", n_devices=1)
    assert [(s.name, s.device) for s in d.slices] == [("s0w1", "cuda:0")]
    assert [s.device for s in Daemon(str(tmp_path / "b.sock"), device="cpu").slices] == ["cpu"]
    with pytest.raises(mesh.SliceSpecError, match="one slice"):
        Daemon(str(tmp_path / "c.sock"), slices="2", n_devices=2)
    with pytest.raises(mesh.SliceSpecError, match="rowshard"):
        Daemon(str(tmp_path / "d.sock"), slices="1x2", n_devices=2)
    with pytest.raises(ValueError, match="device"):
        Daemon(str(tmp_path / "e.sock"), device="tpu")


# ------------------------------------------------ serving on the CPU --
def test_bytes_equal_the_oracle_and_the_jax_daemon(tmp_path, make_daemon, monkeypatch):
    folder, _, want = _chain_folder(tmp_path, n=5, k=2, seed=11)
    d = make_daemon()
    job = _run(d, folder, str(tmp_path / "port.out"))
    assert job["state"] == "done", job["error"]
    assert open(tmp_path / "port.out", "rb").read() == want
    assert job["detail"]["degraded"] is False and job["detail"]["device"] == "cpu"
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")  # the reference's delta fault (ROADMAP 3)
    jd = jax_daemon.Daemon(str(tmp_path / "jax.sock"))
    jd.start()
    try:
        j = jax_client.submit(folder, jd.socket_path, {"output": str(tmp_path / "jax.out")})
        resp = jax_client.wait(j["id"], jd.socket_path, timeout=300)
        assert resp["job"]["state"] == "done", resp["job"]["error"]
    finally:
        jd.stop()
    assert open(tmp_path / "jax.out", "rb").read() == want


@pytest.mark.parametrize("backend", [None, "xla", "pallas"])
def test_the_jax_client_drives_the_port_daemon(backend, tmp_path, make_daemon):
    folder, _, want = _chain_folder(tmp_path, n=4, k=2, seed=12, dist="adversarial")
    d = make_daemon()
    opts = {"output": str(tmp_path / "out")}
    if backend is not None:
        opts["backend"] = backend
    j = jax_client.submit(folder, d.socket_path, opts, tenant="jax-client")
    resp = jax_client.wait(j["id"], d.socket_path, timeout=120)
    assert resp["job"]["state"] == "done", resp["job"]["error"]
    assert resp["job"]["tenant"] == "jax-client" and resp["job"]["trace"] == j["trace"]
    assert open(tmp_path / "out", "rb").read() == want
    assert jax_client.stats(d.socket_path)["daemon"] == "spgemmd"


def test_the_tcp_front_end_serves_both_clients(tmp_path, make_daemon):
    folder, _, want = _chain_folder(tmp_path, seed=18)
    d = make_daemon(addr="tcp:127.0.0.1:0")
    addr = f"tcp:127.0.0.1:{d.tcp_port}"
    for mod, out in ((client, "port.out"), (jax_client, "jax.out")):
        j = mod.submit(folder, addr, {"output": str(tmp_path / out)})
        assert mod.wait(j["id"], addr, timeout=120)["job"]["state"] == "done"
        assert open(tmp_path / out, "rb").read() == want
    with pytest.raises(ValueError, match="tcp:HOST:PORT"):
        Daemon(str(tmp_path / "u.sock"), device="cpu", addr="unix:/tmp/x")


@pytest.mark.parametrize("name,want", [(None, "exact"), ("xla", "exact"), ("pallas", "exact"),
                                       ("exact", "exact"), ("hybrid", "hybrid"),
                                       ("mxu", "mxu")])
def test_jax_backend_names_map_to_exact(name, want):
    assert daemon_mod.engine_backend(name) == want


def test_xla_and_pallas_run_the_exact_fold_not_field_mode(tmp_path, make_daemon):
    folder, mats, want = _chain_folder(tmp_path, n=3, k=2, seed=13, dist="adversarial")
    field = _oracle_bytes(mats, 2, field_spgemm_oracle)
    assert field != want  # the inputs tell the two arithmetics apart
    d = make_daemon()
    for backend in ("xla", "pallas", "exact", "mxu"):
        out = str(tmp_path / f"o.{backend}")
        assert _run(d, folder, out, backend=backend)["state"] == "done"
        assert open(out, "rb").read() == (field if backend == "mxu" else want), backend


def test_second_submit_hits_the_plan_cache_and_an_edit_takes_delta(tmp_path, make_daemon):
    folder, mats, want = _chain_folder(tmp_path, n=4, k=2, seed=14)
    d = make_daemon()
    first = _run(d, folder, str(tmp_path / "o1"))
    second = _run(d, folder, str(tmp_path / "o2"))
    assert first["detail"]["plan_cache_misses"] >= 1 and second["detail"]["plan_cache_hits"] >= 1
    assert second["detail"]["delta_rows"] == 0 < second["detail"]["total_rows"]
    for phase in ("serve_queue_wait", "serve_load", "serve_chain", "serve_write",
                  "serve_execute", "plan"):
        assert phase in first["detail"]["phases_s"], phase
    tiles = mats[0].tiles.copy()
    tiles[0] ^= np.uint64(1)
    mats[0] = BlockSparseMatrix(rows=mats[0].rows, cols=mats[0].cols, k=2,
                                coords=mats[0].coords, tiles=tiles)
    io_text.write_matrix(os.path.join(folder, "matrix1"), mats[0])
    third = _run(d, folder, str(tmp_path / "o3"))
    assert 0 < third["detail"]["delta_rows"] < third["detail"]["total_rows"]
    assert open(tmp_path / "o3", "rb").read() == _oracle_bytes(mats, 2)
    assert open(tmp_path / "o1", "rb").read() == want == open(tmp_path / "o2", "rb").read()


def test_job_phases_are_scoped_per_job(tmp_path, make_daemon):
    folder, _, _ = _chain_folder(tmp_path)
    seen = []

    def runner(job, degraded=False):
        n = len(seen) + 1
        ENGINE.incr("launches_numeric_round", n)
        ENGINE.record("plan", 0.25 * n)
        seen.append(job.id)

    d = make_daemon(runner=runner)
    details = [_run(d, folder, str(tmp_path / f"o{i}"))["detail"] for i in (1, 2)]
    assert [det["launches_numeric_round"] for det in details] == [1, 2]
    assert [det["phases_s"]["plan"] for det in details] == [0.25, 0.5]


def test_the_planner_thread_attributes_to_the_job():
    seen = []
    with ENGINE.scope() as scope:
        token = ENGINE.attribution()

        def worker():
            with ENGINE.attributed(token):
                ENGINE.incr("plan_cache_hits")
            ENGINE.incr("plan_cache_hits")  # after the block: not the scope's
            seen.append(True)

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    ENGINE.incr("plan_cache_hits")  # closed: not the scope's
    assert seen and scope.counter_snapshot() == {"plan_cache_hits": 1}


def test_bad_options_are_refused_at_admission(tmp_path, make_daemon):
    folder, _, _ = _chain_folder(tmp_path)
    d = make_daemon(runner=lambda job, degraded=False: None)
    for opts, fragment in (({"round_size": "abc"}, "round_size"), ({"round_size": 0},
                                                                   "round_size"),
                           ({"backend": "cuda"}, "cuda"), ({"timeout_s": -5}, "timeout_s"),
                           ({"timeout_s": "x"}, "timeout_s"), ({"round_sise": 4}, "round_sise")):
        with pytest.raises(client.ServeError) as ei:
            client.submit(folder, d.socket_path, opts)
        assert ei.value.code == protocol.E_BAD_REQUEST and fragment in ei.value.message
    with pytest.raises(client.ServeError) as ei:
        client.submit(str(tmp_path / "nowhere"), d.socket_path)
    assert ei.value.code == protocol.E_BAD_REQUEST
    with pytest.raises(client.ServeError) as ei:
        client.status("job-999", d.socket_path)
    assert ei.value.code == protocol.E_UNKNOWN_JOB
    with pytest.raises(client.ServeError) as ei:
        client.submit(folder, d.socket_path, tenant="bad tenant")
    assert ei.value.code == protocol.E_BAD_REQUEST


def test_malformed_lines_and_oversized_lines(make_daemon, monkeypatch):
    d = make_daemon(runner=lambda job, degraded=False: None)
    assert _raw_roundtrip(d.socket_path, b"garbage\n")["error"]["code"] == protocol.E_BAD_REQUEST
    monkeypatch.setattr(protocol, "MAX_LINE_BYTES", 64)
    resp = _raw_roundtrip(d.socket_path, b"x" * 200)
    assert resp["error"]["code"] == protocol.E_BAD_REQUEST and "exceeds" in \
        resp["error"]["message"]
    assert client.stats(d.socket_path)["ok"] is True


def test_queue_full_is_a_structured_answer(tmp_path, make_daemon):
    folder, _, _ = _chain_folder(tmp_path)
    release = threading.Event()
    d = make_daemon(runner=lambda job, degraded=False: release.wait(60), queue_cap=1)
    try:
        first = client.submit(folder, d.socket_path)
        _wait_until(lambda: d.queue.get(first["id"]).state == "running", msg="pickup")
        client.submit(folder, d.socket_path)
        with pytest.raises(client.ServeError) as ei:
            client.submit(folder, d.socket_path)
        assert ei.value.code == protocol.E_QUEUE_FULL
    finally:
        release.set()


@pytest.mark.parametrize("op", ["metrics", "trace", "profile", "events", "slo"])
def test_the_unported_ops_answer_bad_request(op, make_daemon):
    d = make_daemon(runner=lambda job, degraded=False: None)
    resp = _raw_roundtrip(d.socket_path, protocol.encode({"v": 4, "op": op}))
    assert resp["ok"] is False and resp["error"]["code"] == protocol.E_BAD_REQUEST
    assert repr(op) in resp["error"]["message"] and "not served yet" in resp["error"]["message"]
    assert client.stats(d.socket_path)["degraded"] is False  # and it serves on


def test_relative_paths_resolve_on_the_client(tmp_path, make_daemon, monkeypatch):
    _chain_folder(tmp_path)
    seen = {}

    def runner(job, degraded=False):
        seen.update(folder=job.folder, output=job.output, ck=job.options["checkpoint_dir"])

    d = make_daemon(runner=runner)
    monkeypatch.chdir(tmp_path)
    j = client.submit("chain_in", d.socket_path, {"output": "o", "checkpoint_dir": "ck"})
    client.wait(j["id"], d.socket_path, timeout=60)
    assert seen == {"folder": str(tmp_path / "chain_in"), "output": str(tmp_path / "o"),
                    "ck": str(tmp_path / "ck")}


def test_shutdown_drains_and_unlinks(tmp_path, monkeypatch):
    monkeypatch.setattr(Daemon, "DRAIN_GRACE_S", 0.1)
    folder, _, _ = _chain_folder(tmp_path)
    release = threading.Event()
    d = Daemon(str(tmp_path / "s.sock"), device="cpu",
               runner=lambda job, degraded=False: release.wait(60))
    t = threading.Thread(target=d.serve_forever)
    t.start()
    try:
        _wait_until(lambda: os.path.exists(d.socket_path), msg="socket")
        j = client.submit(folder, d.socket_path)
        _wait_until(lambda: d.queue.get(j["id"]).state == "running", msg="pickup")
        assert client.shutdown(d.socket_path)["stopping"] is True
        t.join(60)
        assert not t.is_alive() and not os.path.exists(d.socket_path)
        assert d.queue.get(j["id"]).error["code"] == protocol.E_SHUTTING_DOWN
    finally:
        release.set()


# ----------------------------------------------------------- the journal --
def test_the_submit_record_precedes_the_terminal_one(tmp_path, make_daemon):
    folder, _, _ = _chain_folder(tmp_path)
    d = make_daemon(runner=lambda job, degraded=False: None)
    j = client.submit(folder, d.socket_path)
    client.wait(j["id"], d.socket_path, timeout=60)
    events = [journal_parse_line(ln.strip())["event"]
              for ln in open(d.journal_path, encoding="utf-8")]
    assert events == ["submit", "done"]


def test_a_restart_replays_unfinished_jobs(tmp_path):
    folder, _, want = _chain_folder(tmp_path, n=5, k=2, seed=15)
    ckdir, out = str(tmp_path / "ck"), str(tmp_path / "matrix.resume")
    sock = str(tmp_path / "dj.sock")
    d1 = Daemon(sock, device="cpu", runner=lambda job, degraded=False: None)
    resp = d1._op_submit({"op": "submit", "folder": folder,
                          "options": {"output": out, "checkpoint_dir": ckdir}})
    assert resp["ok"] and resp["id"] == "job-1"  # journaled, never run: a crash
    d2 = Daemon(sock, device="cpu")
    d2.start()
    try:
        job = client.wait("job-1", sock, timeout=120)["job"]
        assert job["state"] == "done", job["error"]
        assert open(out, "rb").read() == want
        assert any(f.startswith("pass_") for f in os.listdir(ckdir))
        assert client.submit(folder, sock, {"output": out + ".2"})["id"] == "job-2"
    finally:
        d2.stop()


def test_a_torn_journal_record_is_truncated_and_counted(tmp_path, monkeypatch):
    folder, _, _ = _chain_folder(tmp_path)
    sock = str(tmp_path / "torn.sock")
    d1 = Daemon(sock, device="cpu")
    assert d1._op_submit({"op": "submit", "folder": folder})["id"] == "job-1"
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "serve.journal:1:1")
    assert d1._op_submit({"op": "submit", "folder": folder})["id"] == "job-2"  # torn record
    assert failpoints.triggered() == {"serve.journal": 1}
    monkeypatch.delenv("SPGEMM_TPU_FAILPOINTS")
    d2 = Daemon(sock, device="cpu", runner=lambda job, degraded=False: None)
    d2.start()
    try:
        assert client.wait("job-1", sock, timeout=60)["job"]["state"] == "done"
        with pytest.raises(client.ServeError):
            client.status("job-2", sock)  # past the tear: not replayed
        assert client.stats(sock)["journal"]["torn"] == 1
    finally:
        d2.stop()


def test_the_journal_compacts_at_runtime(tmp_path, make_daemon, monkeypatch):
    monkeypatch.setattr(Daemon, "JOURNAL_COMPACT_EVERY", 4)
    folder, _, _ = _chain_folder(tmp_path)
    d = make_daemon(runner=lambda job, degraded=False: None)
    for _ in range(6):
        j = client.submit(folder, d.socket_path)
        client.wait(j["id"], d.socket_path, timeout=60)
    events = [journal_parse_line(ln.strip()) for ln in open(d.journal_path, encoding="utf-8")]
    assert {e["id"] for e in events} == {"job-5", "job-6"} and len(events) == 4


# ---------------------------------------------------------- the watchdog --
def _gated_runner(calls: list, gate: threading.Event, entered: threading.Event | None = None):
    """A runner whose healthy jobs hang (a call that never returns) until
    gate is set; degraded jobs return at once."""
    def runner(job, degraded=False):
        calls.append((job.id, degraded))
        if not degraded:
            if entered is not None:
                entered.set()
            gate.wait(120)
    return runner


def test_a_reap_then_a_wedge_degrades_and_serves_on(tmp_path, make_daemon, capfd):
    folder, _, _ = _chain_folder(tmp_path)
    calls, gate = [], threading.Event()
    before = ENGINE.counter_snapshot().get("serve_degrades", 0)
    d = make_daemon(runner=_gated_runner(calls, gate), job_timeout_s=0.2, wedge_grace_s=0.2,
                    probe=lambda: "timeout")
    try:
        j1 = client.wait(client.submit(folder, d.socket_path)["id"], d.socket_path,
                         timeout=120)["job"]
        assert j1["state"] == "failed" and j1["error"]["code"] == protocol.E_JOB_TIMEOUT
        assert j1["detail"]["degraded"] is False  # the reaped job keeps its detail
        _wait_until(lambda: d.degraded, msg="a degrade after the wedge grace")
        j2 = client.wait(client.submit(folder, d.socket_path)["id"], d.socket_path,
                         timeout=120)["job"]
        assert j2["state"] == "done" and j2["detail"]["degraded"] is True
        assert (j2["id"], True) in calls
        _wait_until(lambda: client.stats(d.socket_path)["backend_probe"] == "timeout",
                    msg="the probe's outcome")
        st = client.stats(d.socket_path)
        assert st["degraded"] is True and "wedged" in st["degrade_reason"]
        assert st["slices"][0]["degraded"] is True and st["slices_degraded"] == 1
        assert st["serve"]["serve_reaps"] >= 1 and st["serve"]["serve_degrades"] >= 1
        assert ENGINE.counter_snapshot()["serve_degrades"] == before + 1
        assert st["slices"][0]["oracle_jobs"] == 1
    finally:
        gate.set()
    err = capfd.readouterr().err
    assert [ln for ln in err.splitlines() if ln.startswith("spgemmd: slice")] == [
        f"spgemmd: slice s0w1 (cpu) degraded: executor wedged on reaped job {j1['id']}; "
        "probing the card (jobs wait for its outcome)",
        "spgemmd: slice s0w1 (cpu) serves on the host oracle: the card probe found it dead "
        "(timeout)"]


def test_a_live_probe_after_a_wedge_gives_the_card_back(tmp_path, make_daemon, capfd):
    # SPGEMM_TPU_SERVE_RECOVER_S at its default 0: the probe after the
    # degrade decides, and a card that computes serves the next job
    folder, _, _ = _chain_folder(tmp_path)
    calls, gate = [], threading.Event()
    probing, probe_go = threading.Event(), threading.Event()

    def probe():
        probing.set()
        probe_go.wait(120)
        return "ok"

    d = make_daemon(runner=_gated_runner(calls, gate), job_timeout_s=0.2, wedge_grace_s=0.2,
                    probe=probe)
    assert d._recover_s == 0
    try:
        j1 = client.wait(client.submit(folder, d.socket_path)["id"], d.socket_path,
                         timeout=120)["job"]
        assert j1["error"]["code"] == protocol.E_JOB_TIMEOUT
        assert probing.wait(120)
        j2 = client.submit(folder, d.socket_path, {"timeout_s": 30})["id"]
        # no executor while the probe is out: the job waits, on no oracle
        st = client.stats(d.socket_path)
        assert st["degraded"] is True and st["slices"][0]["probing"] is True
        assert client.status(j2, d.socket_path)["job"]["state"] == "queued"
        assert d.slices[0].thread is None
        gate.set()  # healthy jobs return at once from here
        probe_go.set()
        job = client.wait(j2, d.socket_path, timeout=120)["job"]
        assert job["state"] == "done" and job["detail"]["degraded"] is False
        assert job["detail"]["device"] == "cpu" and job["timeout_s"] == 15  # the canary
        assert [c for c in calls if c[1]] == []
        st = client.stats(d.socket_path)
        assert st["degraded"] is False and st["backend_probe"] == "ok"
        assert st["slices"][0]["oracle_jobs"] == 0 and st["slices"][0]["recoveries"] == 1
        assert st["serve"]["serve_degrades"] >= 1 and st["serve"]["serve_recoveries"] >= 1
    finally:
        gate.set()
        probe_go.set()
    err = capfd.readouterr().err
    assert "serves on the host oracle" not in err
    assert [ln for ln in err.splitlines() if ln.startswith("spgemmd: slice")] == [
        f"spgemmd: slice s0w1 (cpu) degraded: executor wedged on reaped job {j1['id']}; "
        "probing the card (jobs wait for its outcome)"]


def test_a_slow_job_is_reaped_but_not_wedged(tmp_path, make_daemon):
    folder, _, _ = _chain_folder(tmp_path)
    calls, gate = [], threading.Event()
    d = make_daemon(runner=_gated_runner(calls, gate), job_timeout_s=0.2, wedge_grace_s=3600,
                    probe=lambda: "never-runs")
    j1 = client.wait(client.submit(folder, d.socket_path)["id"], d.socket_path,
                     timeout=120)["job"]
    assert j1["error"]["code"] == protocol.E_JOB_TIMEOUT
    gate.set()  # the slow call returns: the executor moves on
    _wait_until(lambda: d.slices[0].reaped is None, msg="the executor moving on")
    j2 = client.wait(client.submit(folder, d.socket_path, {"timeout_s": 0})["id"],
                     d.socket_path, timeout=120)["job"]
    assert j2["state"] == "done" and j2["detail"]["degraded"] is False
    assert d.degraded is False and d.slices[0].gen == 1


def test_a_reaped_chain_ends_at_its_next_heartbeat(tmp_path):
    folder, _, _ = _chain_folder(tmp_path, n=4)
    out = str(tmp_path / "stale")
    job = Job("job-x", folder, out, {"failover": True})
    job.device = "cpu"
    job.start()
    job.finish("failed", error={"code": protocol.E_JOB_TIMEOUT, "message": "reaped"})
    for degraded in (False, True):
        with pytest.raises(JobAbandoned), contextlib.redirect_stdout(io.StringIO()):
            daemon_mod.run_chain_job(job, degraded=degraded)
    assert not os.path.exists(out)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_executor_death_fails_the_job_and_degrades(tmp_path, make_daemon):
    folder, _, _ = _chain_folder(tmp_path)
    calls = []

    def runner(job, degraded=False):
        calls.append((job.id, degraded))
        if not degraded:
            raise KeyboardInterrupt  # kills the executor thread

    d = make_daemon(runner=runner, probe=lambda: "error")
    j1 = client.wait(client.submit(folder, d.socket_path)["id"], d.socket_path,
                     timeout=120)["job"]
    assert j1["state"] == "failed" and j1["error"]["code"] == protocol.E_EXECUTOR_DIED
    j2 = client.wait(client.submit(folder, d.socket_path)["id"], d.socket_path,
                     timeout=120)["job"]
    assert j2["state"] == "done" and (j2["id"], True) in calls
    st = client.stats(d.socket_path)
    assert st["degraded"] is True and "died" in st["degrade_reason"]


def test_recovery_reinstates_behind_a_canary(tmp_path, make_daemon):
    # the probe after the degrade finds the card dead (the oracle serves);
    # SPGEMM_TPU_SERVE_RECOVER_S's re-probe then finds it live
    folder, _, _ = _chain_folder(tmp_path)
    calls, gate, entered = [], threading.Event(), threading.Event()
    probe_go = threading.Event()
    outcomes = ["timeout"]

    def probe():
        if not outcomes:
            probe_go.wait(120)
            return "cpu"  # a daemon on the CPU: the probe ran, so it is live
        return outcomes.pop()

    d = make_daemon(runner=_gated_runner(calls, gate, entered), job_timeout_s=0.2,
                    wedge_grace_s=0.2, recover_s=0.05, probe=probe)
    try:
        client.wait(client.submit(folder, d.socket_path)["id"], d.socket_path, timeout=120)
        _wait_until(lambda: d.degraded, msg="the degrade")
        j = client.wait(client.submit(folder, d.socket_path)["id"], d.socket_path,
                        timeout=120)["job"]
        assert j["state"] == "done" and j["detail"]["degraded"] is True  # the dead card's
        gate.set()  # the next healthy job returns at once
        probe_go.set()
        _wait_until(lambda: not d.degraded and d.slices[0].recoveries == 1,
                    msg="the reinstatement")
        assert d.slices[0].canary is True
        j = client.wait(client.submit(folder, d.socket_path, {"timeout_s": 30})["id"],
                        d.socket_path, timeout=120)["job"]
        assert j["state"] == "done" and j["detail"]["degraded"] is False
        assert j["timeout_s"] == 15  # the canary's tightened deadline
        _wait_until(lambda: not client.stats(d.socket_path)["slices"][0]["canary"],
                    msg="the canary passing")
        st = client.stats(d.socket_path)
        assert st["serve"]["serve_recoveries"] >= 1 and st["backend_probe"] == "cpu"
    finally:
        gate.set()
        probe_go.set()


@pytest.mark.parametrize("outcome,live", [("ok", True), ("cpu", False), ("timeout", False),
                                          ("error", False)])
def test_only_a_computing_card_is_live_for_a_card_daemon(outcome, live, tmp_path):
    assert Daemon(str(tmp_path / "c.sock"))._probe_live(outcome) is live
    assert Daemon(str(tmp_path / "p.sock"), device="cpu")._probe_live(outcome) is \
        (outcome in ("ok", "cpu"))


def test_the_heartbeat_failpoint_wedges_the_real_runner(tmp_path, make_daemon, monkeypatch):
    folder, _, want = _chain_folder(tmp_path, n=4)
    # loaded first, as main() does: a cold engine import can outlast the
    # deadline, and the first job's first beat must be the one that hangs
    daemon_mod._load_engine()
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "serve.heartbeat:1:1")
    d = make_daemon(job_timeout_s=2.0, wedge_grace_s=0.5, probe=lambda: "timeout")
    try:
        j1 = _run(d, folder, str(tmp_path / "o1"))
        assert j1["error"]["code"] == protocol.E_JOB_TIMEOUT
        assert failpoints.triggered()["serve.heartbeat"] == 1
        _wait_until(lambda: d.degraded, msg="the wedge")
        j2 = _run(d, folder, str(tmp_path / "o2"))
        assert j2["state"] == "done" and j2["detail"]["degraded"] is True, j2
        assert open(tmp_path / "o2", "rb").read() == want
        assert failpoints.triggered()["serve.heartbeat"] == 1
    finally:
        monkeypatch.delenv("SPGEMM_TPU_FAILPOINTS")  # releases the hung heartbeat


def test_the_executor_failpoint_is_a_wedge(tmp_path, make_daemon, monkeypatch):
    folder, _, _ = _chain_folder(tmp_path)
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "serve.executor:1:1")
    d = make_daemon(runner=lambda job, degraded=False: None, job_timeout_s=0.2,
                    wedge_grace_s=0.2, probe=lambda: "timeout")
    try:
        j1 = client.wait(client.submit(folder, d.socket_path)["id"], d.socket_path,
                         timeout=120)["job"]
        assert j1["error"]["code"] == protocol.E_JOB_TIMEOUT
        _wait_until(lambda: d.degraded, msg="the wedge")
    finally:
        monkeypatch.delenv("SPGEMM_TPU_FAILPOINTS")


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_the_accept_and_readline_failpoints(tmp_path, make_daemon, monkeypatch):
    monkeypatch.setattr(failpoints, "DELAY_S", 0.0)
    d = make_daemon(runner=lambda job, degraded=False: None)
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "serve.accept:1:1,serve.readline:1:1")
    with pytest.raises((ConnectionError, OSError)):
        client.stats(d.socket_path)  # the handler died mid-request: no answer
    assert client.stats(d.socket_path)["ok"] is True  # the slot was freed
    assert failpoints.triggered() == {"serve.accept": 1, "serve.readline": 1}
    _wait_until(lambda: d._conn_count == 0, msg="connections closed")


# ----------------------------------------- the degraded runner's arithmetic --
@pytest.mark.parametrize("backend", ["mxu", "exact", "hybrid", "xla"])
def test_a_degraded_job_keeps_its_arithmetic(backend, tmp_path, make_daemon):
    folder, mats, want = _chain_folder(tmp_path, n=3, k=2, seed=16, dist="adversarial")
    field = _oracle_bytes(mats, 2, field_spgemm_oracle)
    assert field != want
    d = make_daemon()
    d.degrade_at_start("test: card lost", "timeout")
    job = _run(d, folder, str(tmp_path / "o"), backend=backend)
    assert job["state"] == "done" and job["detail"]["degraded"] is True
    assert open(tmp_path / "o", "rb").read() == (field if backend == "mxu" else want)
    st = client.stats(d.socket_path)
    assert st["degraded"] is True and st["backend_probe"] == "timeout"


# ------------------------------------------------------------ main and CLI --
def test_serve_without_a_card_exits_1_with_one_line(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", "serve", "--socket",
                           str(tmp_path / "s.sock")], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1
    assert proc.stderr.strip().splitlines() == [
        "spgemmd: no CUDA device is visible; pass --device cpu to serve on the CPU"]
    assert not os.path.exists(tmp_path / "s.sock")


def test_serve_on_a_dead_card_starts_degraded_and_says_so(tmp_path, monkeypatch, capsys):
    import torch

    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_touch(*a):
        raise AssertionError("a card the probe found dead is not touched in-process")

    monkeypatch.setattr(torch.cuda, "get_device_name", no_touch)
    monkeypatch.setattr(daemon_mod, "_load_kernels", no_touch)
    monkeypatch.setattr(daemon_mod, "_startup_probe", lambda: "timeout")
    monkeypatch.setattr(Daemon, "serve_forever",
                        lambda self: seen.update(degraded=self.degraded,
                                                 reason=self.degrade_reason,
                                                 probe=self._probe_outcome,
                                                 device=self.slices[0].device,
                                                 name=self.device_name))
    assert daemon_mod.main(["--socket", str(tmp_path / "s.sock")]) == 0
    assert seen == {"degraded": True, "reason": "startup probe: card unusable (probe: timeout)",
                    "probe": "timeout", "device": "cuda:0", "name": None}
    assert capsys.readouterr().err.strip().splitlines() == [
        "spgemmd: startup probe: card unusable (probe: timeout); serving on the host oracle "
        "(degraded)"]


def test_serve_refuses_a_wide_slice(tmp_path, capsys):
    assert daemon_mod.main(["--socket", str(tmp_path / "s.sock"), "--device", "cpu",
                            "--slices", "1x2"]) == 1
    assert "rowshard" in capsys.readouterr().err


def test_the_cli_serves_submits_and_shuts_down(tmp_path):
    folder, _, want = _chain_folder(tmp_path, n=4, k=2, seed=17)
    sock = str(tmp_path / "cli.sock")
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("SPGEMM_TPU_WARM_DIR", None)
    proc = subprocess.Popen([sys.executable, "-m", "spgemm_tpu_torch.cli", "serve", "--socket",
                             sock, "--device", "cpu"], env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        _wait_until(lambda: os.path.exists(sock) or proc.poll() is not None, 120, "the socket")
        out = str(tmp_path / "out")
        sub = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", "submit", folder,
                              "--socket", sock, "--output", out, "--backend", "exact", "--wait"],
                             env=env, capture_output=True, text=True, timeout=300)
        assert sub.returncode == 0, sub.stderr
        assert json.loads(sub.stdout)["job"]["state"] == "done"
        assert open(out, "rb").read() == want
        st = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", "status", "--socket",
                             sock], env=env, capture_output=True, text=True, timeout=120)
        assert json.loads(st.stdout)["device"] == {"type": "cpu", "name": "cpu"}
        down = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", "status",
                               "--socket", sock, "--shutdown"], env=env, capture_output=True,
                              text=True, timeout=120)
        assert json.loads(down.stdout)["stopping"] is True
        assert proc.wait(timeout=120) == 0 and not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


def test_a_folder_named_serve_is_still_a_chain_folder(tmp_path, monkeypatch):
    _, mats, want = _chain_folder(tmp_path)
    io_text.write_chain_dir(str(tmp_path / "serve"), mats, 2)
    monkeypatch.chdir(tmp_path)
    from spgemm_tpu_torch import cli

    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.run(["serve", "--device", "cpu"]) == 0
    assert open(tmp_path / "matrix", "rb").read() == want
