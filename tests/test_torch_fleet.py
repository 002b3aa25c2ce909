"""The fleet layer on the port (spgemm_tpu_torch/fleet/, the price-book
gossip in serve/placement.stats(), protocol.format_addr and the router's
error codes), on the CPU: each piece held to the JAX package's (placement
stats, addresses, PriceBook, _label_scrape, the same scripted traffic
through both routers); the port's router in front of two port daemons with
fake runners (spgemm_tpu's tests/test_fleet.py's contracts) and with real
ones, against the bytes of the JAX CLI's ./matrix; and the fleet smoke as
a subprocess.  Inputs from numpy seeds at small sizes.  Tolerance: byte
equality everywhere."""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from spgemm_tpu.fleet import pricebook as jax_pricebook
from spgemm_tpu.fleet import router as jax_router
from spgemm_tpu.serve import placement as jax_placement
from spgemm_tpu.serve import protocol as jax_protocol
from spgemm_tpu_torch.fleet import pricebook, router
from spgemm_tpu_torch.fleet.router import Router, _label_scrape
from spgemm_tpu_torch.ops import delta, plancache, warmstore
from spgemm_tpu_torch.serve import client, placement, protocol
from spgemm_tpu_torch.serve.daemon import Daemon
from spgemm_tpu_torch.utils import failpoints, io_text
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import random_chain
from spgemm_tpu_torch.utils.semantics import chain_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOKS = (delta, plancache, failpoints, placement, jax_placement)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("SPGEMM_TPU_FAILPOINTS", "SPGEMM_TPU_WARM_DIR", "SPGEMM_TPU_SERVE_ADDR",
                 "SPGEMM_TPU_SERVE_SLICES", "SPGEMM_TPU_SERVE_TENANT_INFLIGHT",
                 "SPGEMM_TPU_ROUTER_BACKENDS", "SPGEMM_TPU_ROUTER_POLL_S", "SPGEMM_TPU_DELTA"):
        monkeypatch.delenv(name, raising=False)
    for mod in BOOKS:
        mod.clear()
    warmstore.reset()
    yield
    for mod in BOOKS:
        mod.clear()
    warmstore.reset()


def _chain_folder(tmp_path, n=3, k=2, seed=7, name="chain_in"):
    mats = random_chain(n, 4, k, 0.5, np.random.default_rng(seed), "full")
    folder = str(tmp_path / name)
    io_text.write_chain_dir(folder, mats, k)
    want = chain_oracle([m.to_dict() for m in mats], k)
    want_bytes = io_text.format_matrix(BlockSparseMatrix.from_dict(
        mats[0].rows, mats[-1].cols, k, want).prune_zeros())
    return folder, want_bytes


def _fake(job, degraded=False):
    return None


@pytest.fixture
def make_daemon(tmp_path):
    """Port daemons on device="cpu" with a TCP front end, stopped at
    teardown."""
    daemons = []

    def _make(idx=0, **kw):
        kw.setdefault("device", "cpu")
        kw.setdefault("runner", _fake)
        d = Daemon(str(tmp_path / f"d{idx}.sock"), addr="tcp:127.0.0.1:0", **kw)
        d.start()
        daemons.append(d)
        return d

    yield _make
    for d in daemons:
        d.stop()


@pytest.fixture
def make_router(make_daemon):
    """(router, [daemons]): a router of `cls` (the port's by default) in front
    of n port daemons, all on TCP, stopped at teardown."""
    routers = []

    def _make(n=2, cls=Router, poll_s=0.2, first=0, **daemon_kw):
        ds = [make_daemon(idx=first + i, **daemon_kw) for i in range(n)]
        r = cls(listen="tcp:127.0.0.1:0", backends=[_addr(d) for d in ds], poll_s=poll_s)
        r.start()
        routers.append(r)
        return r, ds

    yield _make
    for r in routers:
        r.stop()


def _addr(obj) -> str:
    port = obj.tcp_port if isinstance(obj, Daemon) else obj.port
    return f"tcp:127.0.0.1:{port}"


def _dead_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens here now
    return port


# ------------------------------------------------------ placement gossip --
def test_placement_stats_gossip_the_book_as_the_jax_module_does(tmp_path):
    """The same note_mass, lookup and route calls give the same stats on
    both modules, the `book` sample included: the newest BOOK_GOSSIP_CAP
    entries, in recency order."""
    assert placement.BOOK_GOSSIP_CAP == jax_placement.BOOK_GOSSIP_CAP == 64
    folders = []
    for i in range(placement.BOOK_GOSSIP_CAP + 6):
        folder = tmp_path / f"f{i}"
        folder.mkdir()
        (folder / "size").write_text(f"2 {i % 5 + 1}\n")
        (folder / "matrix1").write_text("x" * i)
        folders.append(str(folder))
    rng = np.random.default_rng(5)
    masses = rng.integers(1, 3_000_000, len(folders)).astype(float)
    for mod in (placement, jax_placement):
        for folder, mass in zip(folders, masses):
            mod.note_mass(folder, mass)
        mod.note_mass(folders[3], 7.0)  # a re-price moves the entry to the newest end
        mod.lookup_mass(folders[0])      # a hit moves it too
        mod.lookup_mass(str(tmp_path / "missing"))
        mod.route(folders[10])
        mod.route(str(tmp_path / "missing"))
    got, want = placement.stats(), jax_placement.stats()
    assert got == want
    assert len(got["book"]) == placement.BOOK_GOSSIP_CAP
    assert list(got["book"]) == list(want["book"])
    assert list(got["book"].values())[-3:] == [7.0, float(masses[0]), float(masses[10])]
    placement.clear()
    assert placement.stats()["book"] == {}


# -------------------------------------------------------------- protocol --
def test_the_router_error_codes_are_the_jax_ones():
    assert protocol.E_BACKEND_LOST == jax_protocol.E_BACKEND_LOST == "backend-lost"
    assert protocol.E_NO_BACKEND == jax_protocol.E_NO_BACKEND == "no-backend"
    for code in (protocol.E_BACKEND_LOST, protocol.E_NO_BACKEND):
        assert protocol.ERROR_CODES[code] == jax_protocol.ERROR_CODES[code]


@pytest.mark.parametrize("spec", ["tcp:127.0.0.1:7463", "tcp:[::1]:80", "tcp:host:0",
                                  "tcp:a.b.c:65535", "unix:/tmp/x.sock", "/tmp/bare.sock",
                                  "rel.sock", "unix:rel/x"])
def test_format_addr_gives_the_jax_spelling(spec):
    parsed = protocol.parse_addr(spec)
    assert parsed == jax_protocol.parse_addr(spec)
    assert protocol.format_addr(parsed) == jax_protocol.format_addr(parsed)
    # the canonical spelling parses back to itself
    assert protocol.parse_addr(protocol.format_addr(parsed)) == parsed


# ------------------------------------------------------------- pricebook --
_BLOCKS = [
    None, [], "book", {}, {"book": None}, {"book": []}, {"book": {1: "nan"}},
    {"book": {"a": 1.0, "b": 2, "c": "x", "d": True, 3: 4.0}},
    {"book": {"e": 5.5, "a": 9.0}}, {"book": {"f": 1e7}}, {"book": {"g": 0.0, "b": 3.0}},
]


def test_pricebook_gives_the_jax_answers_on_the_same_blocks(tmp_path):
    folders = []
    for i in range(3):
        folder, _ = _chain_folder(tmp_path, seed=i, name=f"c{i}")
        folders.append(folder)
    sigs = [placement.signature(f) for f in folders]
    assert sigs == [jax_placement.signature(f) for f in folders]
    blocks = _BLOCKS + [{"book": {sigs[0]: 123.0, sigs[2]: 2e6}}, {"book": {sigs[1]: 4.0}}]
    for cap in (pricebook.CAP, 3):
        mine, theirs = pricebook.PriceBook(cap=cap), jax_pricebook.PriceBook(cap=cap)
        for block in blocks:
            assert mine.merge(block) == theirs.merge(block), block
            for folder in (*folders, str(tmp_path / "missing")):
                assert mine.lookup(folder) == theirs.lookup(folder)
            assert mine.stats() == theirs.stats()
    assert pricebook.CAP == jax_pricebook.CAP == 4096


def test_pricebook_merge_lookup_and_bounds(tmp_path):
    book = pricebook.PriceBook(cap=2)
    folder, _ = _chain_folder(tmp_path)
    sig = placement.signature(folder)
    assert book.lookup(folder) is None  # first contact
    assert book.merge({"book": {sig: 123.0, "other": 7}}) == 2
    assert book.lookup(folder) == 123.0
    assert book.merge(None) == 0
    assert book.merge({"book": {1: "nan"}}) == 0
    # the LRU bound: a third signature evicts the oldest untouched one
    assert book.merge({"book": {"third": 9.0}}) == 1
    assert book.stats() == {"book_entries": 2, "book_hits": 1, "book_misses": 1, "merged": 3}
    assert book.lookup(folder) == 123.0


# --------------------------------------------------------- _label_scrape --
@pytest.mark.parametrize("text, backend", [
    ('# HELP x y\na{b="c"} 1\nplain 2\n', 'be"1'),
    ("", "tcp:127.0.0.1:9"),
    ('# TYPE h histogram\nh_bucket{le="0.1"} 3\nh_sum 4.5\nh_count 3\n\n', "tcp:h:1"),
    ('x{} 1\nbroken\ny{a="b",c="d"} +Inf\n  \nz 1e-05', "unix:/p\\q"),
])
def test_label_scrape_gives_the_jax_text(text, backend):
    assert _label_scrape(text, backend) == jax_router._label_scrape(text, backend)


def test_label_scrape_injects_not_clobbers():
    out = _label_scrape('# HELP x y\na{b="c"} 1\nplain 2\n', 'be"1')
    assert out.splitlines() == ['a{backend="be\\"1",b="c"} 1', 'plain{backend="be\\"1"} 2']


# ---------------------------------------------------------------- router --
def test_router_requires_backends(monkeypatch):
    with pytest.raises(ValueError, match="at least one backend"):
        Router(listen="tcp:127.0.0.1:0", backends=[])
    with pytest.raises(ValueError, match="at least one backend"):
        Router(listen="tcp:127.0.0.1:0")  # the knob is unset
    with pytest.raises(ValueError, match="duplicate"):
        Router(listen="tcp:127.0.0.1:0", backends=["tcp:127.0.0.1:1", "tcp:127.0.0.1:1"])
    monkeypatch.setenv("SPGEMM_TPU_ROUTER_BACKENDS", " tcp:127.0.0.1:1 , /tmp/b.sock,")
    monkeypatch.setenv("SPGEMM_TPU_ROUTER_POLL_S", "0.5")
    r = Router(listen="tcp:127.0.0.1:0")
    assert sorted(r._backends) == ["tcp:127.0.0.1:1", "unix:/tmp/b.sock"]
    assert r._poll_s == 0.5
    assert router.main(["--backends", ""]) == 1


def test_router_passes_tenant_and_trace_through(tmp_path, make_router):
    """The client's trace context and tenant reach the backend unchanged;
    the answer comes back under the fleet id, naming the backend."""
    folder, _ = _chain_folder(tmp_path)
    r, ds = make_router()
    trace = protocol.mint_trace()
    resp = client.submit(folder, _addr(r), tenant="alice", trace=trace)
    assert resp["id"].startswith("r")
    assert resp["backend"] in r._backends
    assert resp["trace"] == trace
    st = client.wait(resp["id"], _addr(r), timeout=30)
    job = st["job"]
    assert job["id"] == resp["id"]  # the fleet id, not the backend's
    assert job["state"] == "done"
    assert job["tenant"] == "alice" and job["trace"] == trace
    assert st["backend"] == resp["backend"]
    stats = client.stats(_addr(r))
    assert stats["daemon"] == "spgemm-router"
    assert stats["tenants"] == {"alice": {"jobs": 1, "inflight": 0}}


def test_router_rejects_bad_tenant_and_unknown_job(tmp_path, make_router):
    folder, _ = _chain_folder(tmp_path)
    r, _ = make_router()
    with pytest.raises(client.ServeError) as ei:
        client.submit(folder, _addr(r), tenant="bad tenant!")
    assert ei.value.code == protocol.E_BAD_REQUEST
    with pytest.raises(client.ServeError) as ei:
        client.status("r999", _addr(r))
    assert ei.value.code == protocol.E_UNKNOWN_JOB


def test_router_no_backend_when_all_dead(tmp_path):
    """A backend that never answered a poll cannot be placed on: the submit
    gets a structured no-backend, never a hang."""
    folder, _ = _chain_folder(tmp_path)
    r = Router(listen="tcp:127.0.0.1:0", backends=[f"tcp:127.0.0.1:{_dead_port()}"],
               poll_s=30.0)
    r.start()
    try:
        with pytest.raises(client.ServeError) as ei:
            client.submit(folder, _addr(r))
        assert ei.value.code == protocol.E_NO_BACKEND
    finally:
        r.stop()


def test_router_fails_over_to_survivor(tmp_path, make_router):
    """The backend holding a job dies; the next wait through the router
    re-submits it once to the survivor and answers from there; with no
    survivor left, the same job is a structured backend-lost."""
    folder, _ = _chain_folder(tmp_path)
    r, ds = make_router(n=2)
    resp = client.submit(folder, _addr(r), tenant="alice")
    first = resp["backend"]
    victim = next(d for d in ds if _addr(d) == first)
    survivor_name = next(n for n in r._backends if n != first)
    victim.stop()
    st = client.wait(resp["id"], _addr(r), timeout=30)
    assert st["job"]["state"] == "done"
    assert st["backend"] == survivor_name
    stats = client.stats(_addr(r))
    assert stats["jobs"]["failovers"] == 1
    assert stats["backends"][first]["up"] is False
    kinds = [(e["kind"], e.get("outcome")) for e in client.events(50, _addr(r))]
    assert ("router_failover", "resubmitted") in kinds and ("router_backend_down", None) in kinds
    next(d for d in ds if d is not victim).stop()
    with pytest.raises(client.ServeError) as ei:
        client.status(resp["id"], _addr(r))
    assert ei.value.code == protocol.E_BACKEND_LOST


def test_router_metrics_aggregation(tmp_path, make_router):
    """One scrape: the router's families per backend and every backend's own
    series with backend= injected beside its labels."""
    folder, _ = _chain_folder(tmp_path)
    r, ds = make_router()
    resp = client.submit(folder, _addr(r))
    client.wait(resp["id"], _addr(r), timeout=30)
    text = client.metrics(_addr(r))
    for name in r._backends:
        assert f'spgemm_router_backend_up{{backend="{name}"}} 1' in text
    assert f'spgemm_router_jobs_total{{backend="{resp["backend"]}"}} 1' in text
    assert "spgemm_router_failovers_total 0" in text
    relabeled = [ln for ln in text.splitlines()
                 if 'backend="' in ln and not ln.startswith("spgemm_router_")]
    assert relabeled, "no backend-relabeled passthrough series"
    assert f'spgemmd_jobs_terminal_total{{backend="{resp["backend"]}",outcome="done"}} 1' \
        in text
    # profile and slo nest one report per live backend
    assert set(client.profile(_addr(r))) == set(r._backends)
    assert set(client.slo(_addr(r))) == set(r._backends)


def test_router_shutdown_op_stops(tmp_path, make_router):
    r, _ = make_router()
    resp = client.shutdown(_addr(r))
    assert resp["stopping"] is True
    assert r._stop.wait(5.0)


def test_a_wait_longer_than_one_slice_does_not_fail_over(tmp_path, make_router, monkeypatch):
    """A job that outlives several server-side wait slices is waited for
    through the router with no failover: each forwarded wait answers within
    the router's read timeout, which outlasts the daemon's longest slice."""
    assert client.WAIT_SLICE_S <= Daemon.MAX_WAIT_SLICE_S < Router.POLL_TIMEOUT_S + 30.0
    folder, _ = _chain_folder(tmp_path)
    gate = threading.Event()
    r, ds = make_router(runner=lambda job, degraded=False: gate.wait(60))
    monkeypatch.setattr(client, "WAIT_SLICE_S", 0.3)
    resp = client.submit(folder, _addr(r))
    timer = threading.Timer(1.5, gate.set)
    timer.start()
    try:
        st = client.wait(resp["id"], _addr(r), timeout=60)
    finally:
        timer.cancel()
        gate.set()
    assert st["job"]["state"] == "done" and st["backend"] == resp["backend"]
    stats = client.stats(_addr(r))
    assert stats["jobs"]["failovers"] == 0
    assert all(b["up"] for b in stats["backends"].values())
    assert sum(b["jobs_total"] for b in stats["backends"].values()) == 1


# --------------------------------------- the same traffic, both routers --
def _scripted(make_router, tmp_path, cls, first) -> list:
    """One script of submits, waits, re-prices, refusals and two kills
    through a router of cls in front of two fresh port daemons; each step's
    backend as its rank among the backends' sorted names (the routers'
    tie-break), or its error code."""
    placement.clear()
    r, ds = make_router(cls=cls, poll_s=60.0, first=first)  # polls only where asked
    addr = _addr(r)
    names = sorted(r._backends)
    folders = [_chain_folder(tmp_path, seed=s, name=f"s{first}_{s}")[0] for s in range(3)]
    seq = []

    def submit(folder, **kw):
        try:
            resp = client.submit(folder, addr, {"output": str(tmp_path / f"o{first}")}, **kw)
        except client.ServeError as e:
            seq.append(e.code)
            return None
        seq.append(names.index(resp["backend"]))
        return resp["id"]

    def wait(jid):
        try:
            st = client.wait(jid, addr, timeout=30)
        except client.ServeError as e:
            seq.append(e.code)
            return
        seq.append((st["job"]["state"], names.index(st["backend"])))

    # first contacts round-robin per tenant
    for folder, tenant in ((folders[0], "t1"), (folders[0], "t1"), (folders[1], "t2"),
                           (folders[2], "t1"), (folders[1], "t2")):
        wait(submit(folder, tenant=tenant))
    # priced: a cheap folder twice (the least loaded first), a large one
    placement.note_mass(folders[0], 10.0)
    placement.note_mass(folders[1], 2e6)
    r._poll_once()
    jids = [submit(folders[0]), submit(folders[0]), submit(folders[1]), submit(folders[2])]
    for jid in jids:
        wait(jid)
    seq.append(r.book.stats())
    submit(folders[0], tenant="bad tenant!")
    submit(folders[0], trace="XYZ")
    wait("r999")
    # the backend holding a job dies before its wait
    jid = submit(folders[1], tenant="t3")
    holder = names[seq[-1]]
    next(d for d in ds if _addr(d) == holder).stop()
    wait(jid)
    jid = submit(folders[2])
    wait(jid)
    seq.append(client.stats(addr)["jobs"])
    for d in ds:
        d.stop()
    wait(jid)
    submit(folders[0])
    return seq


def test_the_jax_router_and_the_port_router_place_the_same_traffic(tmp_path, make_router):
    theirs = _scripted(make_router, tmp_path, jax_router.Router, 0)
    mine = _scripted(make_router, tmp_path, Router, 2)
    assert mine == theirs
    assert mine[-1] == protocol.E_NO_BACKEND and mine[-2] == protocol.E_BACKEND_LOST
    assert mine[-3] == {"routed": 11, "inflight": 0, "failovers": 1}
    book = next(x for x in mine if isinstance(x, dict) and "book_entries" in x)
    # both in-process daemons gossip the one process-wide book: 2 entries each
    assert book == {"book_entries": 2, "book_hits": 3, "book_misses": 6, "merged": 4}
    # both backends served, and the three refusals came back structured
    assert {0, 1} <= {x for x in mine if isinstance(x, int)}
    assert mine.count(protocol.E_BAD_REQUEST) == 2 and protocol.E_UNKNOWN_JOB in mine


# ------------------------------------------------- real runners, real bytes --
def test_the_router_over_two_port_daemons_gives_the_jax_cli_bytes(tmp_path, make_router,
                                                                   monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    folder, want = _chain_folder(tmp_path, n=4, k=4, seed=3)
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", "SPGEMM_TPU_DELTA": "0"}
    ref = subprocess.run([sys.executable, "-m", "spgemm_tpu.cli", folder, "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert ref.returncode == 0, ref.stderr
    jax_bytes = (tmp_path / "matrix").read_bytes()
    assert jax_bytes == want
    r, ds = make_router(runner=None)
    served = set()
    for i in range(2):  # a first contact, then the submit the book prices
        out = tmp_path / f"routed{i}"
        resp = client.submit(folder, _addr(r), {"output": str(out)}, tenant="t")
        st = client.wait(resp["id"], _addr(r), timeout=120)
        assert st["job"]["state"] == "done", st["job"]
        assert st["job"]["detail"]["device"] == "cpu"
        assert out.read_bytes() == jax_bytes
        served.add(resp["backend"])
        r._poll_once()
    assert r.book.stats()["book_hits"] == 1 and r.book.stats()["book_entries"] == 1


def test_the_fleet_smoke_passes_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "TMPDIR": str(tmp_path)}
    r = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.fleet.fleet_smoke", "--device",
                        "cpu"], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "fleet-smoke: OK on cpu" in r.stdout and "stitched across 3 processes" in r.stdout


def test_the_fleet_smoke_fails_where_the_daemons_cannot_see_a_card(tmp_path):
    """`--device cuda` (the default) on a machine without a card: the
    daemons refuse to start and the smoke exits 1; nothing runs on the
    CPU instead."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the daemons would start")
    env = {**os.environ, "PYTHONPATH": REPO, "TMPDIR": str(tmp_path)}
    r = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.fleet.fleet_smoke"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1 and "exited before listening" in r.stderr, r.stderr[-4000:]
