"""Cross-job batching in the port (ops/symbolic.stack_round_indices,
ops/spgemm.execute_batched, ops/plancache's structure book,
serve/queue.drain_batch, and serve/daemon's batch pickup and
run_chain_jobs), on the CPU, against the JAX package:

  * stacked indices and batched multiplies against the JAX functions and
    against J solo multiplies, under exact, hybrid and mxu and every
    accumulator route; a narrow launch budget and the int32 guard;
  * the six daemon tests of tests/test_serve_batch.py on a port daemon
    (device="cpu"), the first also against the JAX daemon's bytes;
  * the queue's drain and the structure book's LRU against the JAX modules;
  * the JAX client reading `batch` from the port daemon;
  * where no batch may form (delta on, failover, checkpoint_dir, window 0,
    a degraded slice, a canary pickup), a reaped head, a stale book, and a
    batch whose kernel fails (never rerun on the host oracle).

Every daemon and every JAX leg runs with SPGEMM_TPU_DELTA=0: batching needs
it, and it keeps the JAX legs clear of the reference's delta fault.  Inputs
from numpy seeds at small sizes.  Tolerance: zero differing bits."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from spgemm_tpu.ops import plancache as jax_plancache
from spgemm_tpu.ops import symbolic as jax_sym
from spgemm_tpu.ops.spgemm import execute_batched as jax_execute_batched
from spgemm_tpu.ops.spgemm import plan as jax_plan
from spgemm_tpu.serve import client as jax_client
from spgemm_tpu.serve import daemon as jax_daemon
from spgemm_tpu.serve import placement as jax_placement
from spgemm_tpu.serve import queue as jax_queue
from spgemm_tpu.utils import gen as jax_gen
from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxMatrix
from spgemm_tpu_torch import chain
from spgemm_tpu_torch.ops import delta, plancache, warmstore
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.ops import symbolic as sym
from spgemm_tpu_torch.ops.cuda_dense import numeric_round_dense
from spgemm_tpu_torch.ops.cuda_mxu import numeric_round_mxu
from spgemm_tpu_torch.ops.cuda_spgemm import numeric_round
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.serve import client, placement
from spgemm_tpu_torch.serve.daemon import Daemon, journal_parse_line
from spgemm_tpu_torch.serve.queue import Job, JobAbandoned, JobQueue
from spgemm_tpu_torch.utils import failpoints, io_text
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import random_chain
from spgemm_tpu_torch.utils.semantics import chain_oracle
from spgemm_tpu_torch.utils.timers import ENGINE, PhaseTimers

BOOKS = (delta, plancache, failpoints, placement, jax_plancache, jax_placement)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Delta off (batching needs it), every batch, route and serve setting
    at its default, and the process-wide books empty: the structure book
    especially, or one test's recorded structures would give a later
    test's admissions a group key."""
    for name in ("SPGEMM_TPU_FAILPOINTS", "SPGEMM_TPU_WARM_DIR", "SPGEMM_TPU_SERVE_ADDR",
                 "SPGEMM_TPU_SERVE_SLICES", "SPGEMM_TPU_SERVE_BATCH_K",
                 "SPGEMM_TPU_SERVE_BATCH_WINDOW_S", "SPGEMM_TPU_ACCUM_ROUTE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    for mod in BOOKS:
        mod.clear()
    warmstore.reset()
    yield
    for mod in BOOKS:
        mod.clear()
    warmstore.reset()


@pytest.fixture
def batch_env(monkeypatch):
    """Batching armed: window 0.5 s, K 8 (delta is off already)."""
    monkeypatch.setenv("SPGEMM_TPU_SERVE_BATCH_WINDOW_S", "0.5")
    monkeypatch.setenv("SPGEMM_TPU_SERVE_BATCH_K", "8")
    return monkeypatch


@pytest.fixture
def make_daemon(tmp_path):
    """Port daemons on device="cpu", bound to per-test sockets, stopped at
    teardown."""
    daemons = []

    def _make(idx=0, **kw):
        kw.setdefault("device", "cpu")
        kw.setdefault("journal", False)
        d = Daemon(str(tmp_path / f"d{idx}.sock"), **kw)
        d.start()
        daemons.append(d)
        return d

    yield _make
    for d in daemons:
        d.stop()


def _oracle_bytes(mats, k) -> bytes:
    blocks = chain_oracle([m.to_dict() for m in mats], k)
    return io_text.format_matrix(
        BlockSparseMatrix.from_dict(mats[0].rows, mats[-1].cols, k, blocks).prune_zeros())


def _chain_folder(tmp_path, n=3, k=2, seed=7, name="chain_in", dist="full"):
    """A chain input directory and the oracle's bytes of its product."""
    mats = random_chain(n, 4, k, 0.5, np.random.default_rng(seed), dist)
    folder = str(tmp_path / name)
    io_text.write_chain_dir(folder, mats, k)
    return folder, _oracle_bytes(mats, k)


def _prime(folder, fingerprint="fp-test", book=plancache):
    """Record the folder's structure in a structure book: the served-before
    state in which admission gives a job its group key."""
    sig = placement.signature(folder)
    assert sig is not None
    book.note_chain_structure(sig, fingerprint)


def _submit_wait(d, folder, outs, tenant=None, timeout=120.0, **options):
    """One job per output path, submitted back to back, then waited for."""
    ids = [client.submit(folder, d.socket_path, {"output": o, **options}, tenant=tenant)["id"]
           for o in outs]
    return [client.wait(j, d.socket_path, timeout=timeout)["job"] for j in ids]


def _serve_counters(d, since: dict | None = None) -> dict:
    """The `serve` block of the daemon's stats (process-wide ENGINE
    counters), less `since`."""
    now = client.stats(d.socket_path)["serve"]
    return {name: n - (since or {}).get(name, 0) for name, n in now.items()}


def _recording_runners(gate_folder=None):
    """(runner, batch_runner, solo calls, batch calls): runners that record
    the job ids they were given; the runner waits on the returned gate
    while it holds gate_folder's job."""
    gate = threading.Event()
    solo, batches = [], []

    def runner(job, degraded=False):
        if job.folder == gate_folder:
            gate.wait(30)
        solo.append((job.id, degraded))

    def batch_runner(jobs, degraded=False):
        batches.append([j.id for j in jobs])

    return runner, batch_runner, solo, batches, gate


# ------------------------------------------------ stack_round_indices --
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("jobs", [1, 2, 3, 4])
def test_stack_round_indices_equal_the_jax_function(jobs, ndim):
    """Random indices with sentinels in every job's copy: the same array,
    dtype and shape as the JAX function (and, for a 2-D round, as
    stack_on_card, execute_batched's stacking), every sentinel on the shared zero
    tile (the stacked slab's last row) and every real index inside its
    job's block of tiles."""
    rng = np.random.default_rng(jobs * 10 + ndim)
    sentinel = 13
    shape = (5, 7) if ndim == 2 else (3, 5, 7)
    idx = rng.integers(0, sentinel, size=shape).astype(np.int32)
    idx[rng.random(shape) < 0.3] = sentinel
    got = sym.stack_round_indices(idx, sentinel, jobs)
    want = jax_sym.stack_round_indices(idx, sentinel, jobs)
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)
    lead = 1 if ndim == 2 else shape[0]
    assert got.shape == (jobs * lead, *shape[-2:])
    if ndim == 2:  # what execute_batched stacks, on the device
        on_card = engine.stack_on_card(torch.from_numpy(idx), sentinel, jobs)
        assert on_card.dtype == torch.int32 and on_card.is_contiguous()
        assert np.array_equal(on_card.numpy(), want)
    for j in range(jobs):
        copy = got[j * lead:(j + 1) * lead]
        assert np.array_equal(copy == jobs * sentinel, np.broadcast_to(idx == sentinel,
                                                                       copy.shape))
        real = copy[copy != jobs * sentinel]
        assert ((real >= j * sentinel) & (real < (j + 1) * sentinel)).all()


def test_a_padded_stacked_round_skips_every_jobs_sentinels():
    """Kernel 1's plain version on a stacked slab (tiles only, one zero
    tile last) and stacked indices with sentinel-padded slots in every
    job's copy: each job's rows equal its own solo round."""
    rng = np.random.default_rng(5)
    k, n, jobs = 3, 6, 3
    slabs = [rng.integers(0, 1 << 64, size=(n + 1, k, k), dtype=np.uint64) for _ in range(jobs)]
    for s in slabs:
        s[-1] = 0
    pa = rng.integers(0, n, size=(4, 5)).astype(np.int32)
    pb = rng.integers(0, n, size=(4, 5)).astype(np.int32)
    pa[:, 3:] = n  # padded slots
    pb[1, :] = n   # an all-pad key
    t = [torch.from_numpy(s.view(np.int64)) for s in slabs]
    stacked = torch.cat([s[:n] for s in t] + [t[0][n:]])
    got = numeric_round(stacked, stacked, torch.from_numpy(sym.stack_round_indices(pa, n, jobs)),
                        torch.from_numpy(sym.stack_round_indices(pb, n, jobs)))
    for j in range(jobs):
        assert torch.equal(got[j], numeric_round(t[j], t[j], torch.from_numpy(pa),
                                                 torch.from_numpy(pb)))


# ----------------------------------------------------- execute_batched --
def _structure(kind: str, k: int = 2, seed: int = 31):
    """A JAX operand pair of one structure: `random` (shallow classes) or
    `hub` (two rows of fanout 300: dense rounds and twins)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (jax_gen.random_block_sparse(8, 8, k, 0.4, rng, "full"),
                jax_gen.random_block_sparse(8, 8, k, 0.4, rng, "full"))
    fanout, keys = 300, 2
    a_c = np.array([(i, i * fanout + j) for i in range(keys) for j in range(fanout)], np.int64)
    b_c = np.array([(m, 0) for m in range(keys * fanout)], np.int64)
    return (JaxMatrix(rows=keys, cols=keys * fanout, k=k, coords=a_c,
                      tiles=np.zeros((len(a_c), k, k), np.uint64)),
            JaxMatrix(rows=keys * fanout, cols=1, k=k, coords=b_c,
                      tiles=np.zeros((len(b_c), k, k), np.uint64)))


def _value_sets(a, b, jobs: int, dist: str):
    """jobs JAX operand pairs on the structure of (a, b), values from
    seeds 100.."""
    out = []
    for j in range(jobs):
        rng = np.random.default_rng(100 + j)
        out.append(tuple(JaxMatrix(rows=m.rows, cols=m.cols, k=m.k, coords=m.coords,
                                   tiles=jax_gen.random_values(m.tiles.shape, rng, dist))
                         for m in (a, b)))
    return out


def _to_port(pairs):
    return [tuple(DeviceBlockMatrix.from_host(BlockSparseMatrix.from_reference(m), "cpu")
                  for m in pair) for pair in pairs]


def _host(m) -> tuple:
    h = m.to_host()
    return np.asarray(h.coords), np.asarray(h.tiles)


def _same_host(x, y) -> bool:
    (xc, xt), (yc, yt) = _host(x), _host(y)
    return np.array_equal(xc, yc) and np.array_equal(xt, yt)


@pytest.mark.parametrize("route", ["ladder", "dense", "auto"])
@pytest.mark.parametrize("backend", ["exact", "hybrid", "mxu"])
def test_execute_batched_equals_the_jax_function_and_solo(backend, route, monkeypatch):
    """Three jobs on one structure: the port's batched results equal its
    solo executes (bits and val_bound) and the JAX package's
    execute_batched, under each backend and accumulator route (mxu plans
    ladder in both packages; a dense round takes the solo path)."""
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", route)
    a, b = _structure("hub" if route != "ladder" else "random")
    jax_pairs = _value_sets(a, b, 3, "small" if backend == "hybrid" else "full")
    pairs = _to_port(jax_pairs)
    p = engine.plan(*pairs[0], backend=backend)
    solo = [engine.execute(p, x, y) for x, y in pairs]
    got = engine.execute_batched(p, pairs)
    jax_name = "xla" if backend == "exact" else backend
    want = jax_execute_batched(jax_plan(*jax_pairs[0], backend=jax_name, platform="cpu"),
                               jax_pairs)
    assert len(got) == 3
    for g, s, w in zip(got, solo, want):
        assert torch.equal(g.slab, s.slab) and np.array_equal(g.coords, s.coords)
        assert g.val_bound == s.val_bound
        assert (g.rows, g.cols) == (s.rows, s.cols)
        assert _same_host(g, w)


@pytest.mark.parametrize("width", [1, 2])
def test_a_narrow_launch_budget_chunks_the_jobs(width, monkeypatch):
    """LAUNCH_OUT_ELEMENTS cut so that `width` jobs' copies of the widest
    round fit one launch: every round launches ceil(J / its width) times
    (each launch at most `width` jobs wide there), and the bits stay the
    solo ones."""
    jobs = 5
    a, b = _structure("random", seed=8)
    pairs = _to_port(_value_sets(a, b, jobs, "full"))
    p = engine.plan(*pairs[0])
    solo = [engine.execute(p, x, y) for x, y in pairs]
    k, K_max = p.k, max(r.pa.shape[0] for r in p.rounds)
    monkeypatch.setattr(engine, "LAUNCH_OUT_ELEMENTS", K_max * width * k * k)
    calls = []

    def counting(a_slab, b_slab, pa, pb, **kw):
        calls.append(pa.shape)
        return numeric_round(a_slab, b_slab, pa, pb, **kw)

    got = engine.execute_batched(p, pairs, folds=engine.Folds(exact=counting))
    widths = [min(jobs, max(1, K_max * width // r.pa.shape[0])) for r in p.rounds]
    assert len(calls) == sum(-(-jobs // w) for w in widths)
    assert all(len(shape) == 3 and shape[0] <= max(widths) for shape in calls)
    assert any(shape[0] == width for shape in calls)
    for g, s in zip(got, solo):
        assert torch.equal(g.slab, s.slab)


def test_the_int32_guard_takes_the_solo_path(monkeypatch):
    """Stacked slab rows that would pass the int32 index limit: every job
    runs its solo execute (2-D indices, one launch per job and round), with
    the solo bits."""
    jobs = 3
    a, b = _structure("random", seed=9)
    pairs = _to_port(_value_sets(a, b, jobs, "full"))
    p = engine.plan(*pairs[0])
    solo = [engine.execute(p, x, y) for x, y in pairs]
    nnzb = max(len(p.a_coords), len(p.b_coords))
    monkeypatch.setattr(engine, "INDEX_LIMIT", nnzb * jobs + 1)
    shapes = []

    def counting(a_slab, b_slab, pa, pb, **kw):
        shapes.append(tuple(pa.shape))
        return numeric_round(a_slab, b_slab, pa, pb, **kw)

    got = engine.execute_batched(p, pairs, folds=engine.Folds(exact=counting))
    assert len(shapes) == jobs * len(p.rounds) and all(len(s) == 2 for s in shapes)
    for g, s in zip(got, solo):
        assert torch.equal(g.slab, s.slab)


def test_execute_batched_refuses_another_structure_and_empties():
    """Every pair must match the plan; a structurally empty product gives
    one empty result per job; a single pair is a solo execute."""
    a, b = _structure("random", seed=10)
    pairs = _to_port(_value_sets(a, b, 2, "full"))
    p = engine.plan(*pairs[0])
    other = _to_port(_value_sets(*_structure("random", seed=11), 1, "full"))[0]
    with pytest.raises(ValueError, match="block structure"):
        engine.execute_batched(p, [pairs[0], other])
    [one] = engine.execute_batched(p, pairs[:1])
    assert torch.equal(one.slab, engine.execute(p, *pairs[0]).slab)
    ea = BlockSparseMatrix(rows=4, cols=4, k=2, coords=np.array([(0, 0)], np.int64),
                           tiles=np.ones((1, 2, 2), np.uint64))
    eb = BlockSparseMatrix(rows=4, cols=4, k=2, coords=np.array([(1, 1)], np.int64),
                           tiles=np.ones((1, 2, 2), np.uint64))
    empty = [(DeviceBlockMatrix.from_host(ea, "cpu"), DeviceBlockMatrix.from_host(eb, "cpu"))] * 2
    outs = engine.execute_batched(engine.plan(*empty[0]), empty)
    assert [o.nnzb for o in outs] == [0, 0]


def test_dense_rounds_take_solo_fallback(monkeypatch):
    """tests/test_serve_batch.py's dense case on the port: a forced-dense
    plan's 1-D pair streams do not stack, so every job runs its solo
    execute (one dense fold per job and round) with its solo bytes and the
    JAX execute_batched's."""
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", "dense")
    k, K, f = 2, 2, 40
    a_coords = np.array([(i, i * f + j) for i in range(K) for j in range(f)], np.int64)
    b_coords = np.array([(m, 0) for m in range(K * f)], np.int64)

    def _pair(seed):
        r = np.random.default_rng(seed)
        return (JaxMatrix(rows=K, cols=K * f, k=k, coords=a_coords,
                          tiles=r.integers(0, 1 << 64, size=(len(a_coords), k, k),
                                           dtype=np.uint64)),
                JaxMatrix(rows=K * f, cols=1, k=k, coords=b_coords,
                          tiles=r.integers(0, 1 << 64, size=(len(b_coords), k, k),
                                           dtype=np.uint64)))

    jax_pairs = [_pair(s) for s in (1, 2, 3)]
    pairs = _to_port(jax_pairs)
    p = engine.plan(*pairs[0])
    assert any(r.pa.ndim != 2 for r in p.rounds)  # the guard's predicate
    solo = [engine.execute(p, x, y) for x, y in pairs]
    folds_run = []

    def dense(*args, **kw):
        folds_run.append(args[2].dim())
        return numeric_round_dense(*args, **kw)

    got = engine.execute_batched(p, pairs, folds=engine.Folds(dense=dense))
    assert len(folds_run) == len(pairs) * sum(r.route == "dense" for r in p.rounds)
    want = jax_execute_batched(jax_plan(*jax_pairs[0], backend="xla", platform="cpu"),
                               jax_pairs)
    for g, s, w in zip(got, solo, want):
        assert torch.equal(g.slab, s.slab)
        assert _same_host(g, w)


def test_mxu_runs_the_widest_limbs_of_all_jobs():
    """Under mxu one launch serves every job: the limb counts are the
    widest any job's values need (a job of small values beside one of full
    ones), and each job gets its solo field-mode bits."""
    a, b = _structure("random", seed=12)
    small = _value_sets(a, b, 1, "small")
    full = _value_sets(a, b, 1, "full")
    pairs = _to_port(small + full)
    p = engine.plan(*pairs[0], backend="mxu")
    limbs = []

    def mxu(*args, a_limbs, b_limbs):
        limbs.append((a_limbs, b_limbs))
        return numeric_round_mxu(*args, a_limbs=a_limbs, b_limbs=b_limbs)

    got = engine.execute_batched(p, pairs, folds=engine.Folds(mxu=mxu))
    assert set(limbs) == {(10, 10)} and len(limbs) == len(p.rounds)
    for g, (x, y) in zip(got, pairs):
        assert torch.equal(g.slab, engine.execute(p, x, y).slab)


# ------------------------------------------------ ENGINE and the scopes --
def test_one_batched_launch_counts_once_and_in_every_member_scope():
    """The counters a batched launch bumps: once in the registry, once in
    each member's PhaseScope (all open on the executor thread);
    PhaseScope.record feeds that scope alone; zero(prefix) drops only the
    counters it names."""
    timers = PhaseTimers()
    scopes = [timers.scope() for _ in range(3)]
    timers.incr("launches_numeric_round")
    timers.incr("plan_cache_hits")
    scopes[1].record("serve_queue_wait", 0.25)
    assert timers.counter_snapshot()["launches_numeric_round"] == 1
    assert [s.counter_snapshot()["launches_numeric_round"] for s in scopes] == [1, 1, 1]
    assert [s.snapshot().get("serve_queue_wait") for s in scopes] == [None, 0.25, None]
    assert "serve_queue_wait" not in timers.snapshot()
    timers.zero("launches_")
    assert timers.counter_snapshot() == {"plan_cache_hits": 1}
    assert scopes[0].counter_snapshot()["launches_numeric_round"] == 1
    for s in scopes:
        s.close()


# ----------------------------------------------- queue and structure book --
def _queues():
    return JobQueue(64), jax_queue.JobQueue(64)


def _same_jobs(port_q, jax_q, specs):
    for job_id, tenant, group in specs:
        for q, cls in ((port_q, Job), (jax_q, jax_queue.Job)):
            job = cls(job_id, "/f", "/o", {}, tenant=tenant)
            job.group_key = group
            q.submit(job)


@pytest.mark.parametrize("specs,limit", [
    ([("h", "t1", "a"), ("x1", "t1", "b"), ("m1", "t1", "a"), ("m2", "t2", "a"),
      ("x2", "t2", "b"), ("m3", "t3", "a")], 8),
    ([("h", "t1", "a")] + [(f"c{i}", "chatty", "a") for i in range(5)] + [("q", "quiet", "a")], 3),
    ([("h", "t1", "a"), ("x", "t1", None), ("y", "t2", "b")], 4),
], ids=["interleaved", "chatty-capped", "no-mates"])
def test_drain_batch_is_the_jax_drain(specs, limit):
    """The same submits into the port's and the JAX queue: the same head,
    the same mates in the same order (the fair pass, scanning past jobs of
    another group, which keep their places), then the same solo order of
    what is left."""
    port_q, jax_q = _queues()
    _same_jobs(port_q, jax_q, specs)
    heads = [q.next(timeout=0) for q in (port_q, jax_q)]
    assert heads[0].id == heads[1].id == "h"
    got = [[m.id for m in q.drain_batch(limit, 0.0, lambda j: j.group_key == "a")]
           for q in (port_q, jax_q)]
    assert got[0] == got[1]
    rest = [[j.id for j in iter(lambda q=q: q.next(timeout=0), None)]
            for q in (port_q, jax_q)]
    assert rest[0] == rest[1]
    assert len(got[0]) <= limit and not set(got[0]) & set(rest[0])


def test_the_window_bounds_waiting_only():
    """A mate that arrives inside the window joins; queued mates drain at
    once however long the window; an empty drain returns after the window."""
    q = JobQueue(64)
    q.submit(Job("now", "/f", "/o", {}))
    t0 = time.time()
    assert [j.id for j in q.drain_batch(1, 30.0, lambda j: True)] == ["now"]
    assert time.time() - t0 < 5.0
    threading.Timer(0.1, lambda: q.submit(Job("late", "/f", "/o", {}))).start()
    assert [j.id for j in q.drain_batch(1, 10.0, lambda j: True)] == ["late"]
    t0 = time.time()
    assert q.drain_batch(1, 0.2, lambda j: True) == []
    assert 0.15 <= time.time() - t0 < 5.0


def test_the_structure_book_is_the_jax_lru(monkeypatch):
    """The same notes and lookups in both books at a cap of 3: the same
    answers (a lookup refreshes an entry, the least recent goes first, an
    unreadable folder's None signature is never recorded)."""
    monkeypatch.setattr(plancache, "STRUCT_CAP", 3)
    monkeypatch.setattr(jax_plancache, "STRUCT_CAP", 3)
    ops = [("note", "s1", "f1"), ("note", "s2", "f2"), ("note", "s3", "f3"), ("get", "s1"),
           ("note", "s4", "f4"), ("get", "s2"), ("get", "s1"), ("note", None, "f5"),
           ("get", None), ("note", "s3", "f3b"), ("note", "s5", "f5"), ("get", "s4"),
           ("get", "s3"), ("get", "s5"), ("get", "s1")]
    answers = []
    for book in (plancache, jax_plancache):
        got = []
        for op in ops:
            if op[0] == "note":
                book.note_chain_structure(op[1], op[2])
            else:
                got.append(book.chain_structure(op[1]))
        answers.append(got)
    assert answers[0] == answers[1]
    assert answers[0][-4:] == [None, "f3b", "f5", "f1"]


def test_the_chain_fingerprint_reads_structure_only():
    """Values never enter the fingerprint; structure (and chain order) does."""
    mats = random_chain(3, 4, 2, 0.5, np.random.default_rng(3), "full")
    revalued = [BlockSparseMatrix(rows=m.rows, cols=m.cols, k=m.k, coords=m.coords,
                                  tiles=m.tiles + np.uint64(1)) for m in mats]
    fp = plancache.chain_fingerprint([m.coords for m in mats])
    assert fp == plancache.chain_fingerprint([m.coords for m in revalued])
    assert fp != plancache.chain_fingerprint([m.coords for m in mats[::-1]])
    assert fp != plancache.chain_fingerprint([m.coords[:-1] for m in mats])


# ------------------------------------------- tests/test_serve_batch.py --
def test_batched_results_byte_identical_to_solo(tmp_path, batch_env, make_daemon):
    """Co-batched jobs give the bytes of the same submits through an
    unbatched daemon, of the oracle, and of the JAX daemon batching the
    same folder."""
    folder, want = _chain_folder(tmp_path)

    batch_env.setenv("SPGEMM_TPU_SERVE_BATCH_WINDOW_S", "0")  # the executor of PR 14
    d0 = make_daemon(0)
    solo_outs = [str(tmp_path / f"solo{i}") for i in range(3)]
    for j in _submit_wait(d0, folder, solo_outs):
        assert j["state"] == "done", j["error"]
        assert j["batch"] is None
    d0.stop()

    batch_env.setenv("SPGEMM_TPU_SERVE_BATCH_WINDOW_S", "0.5")
    _prime(folder)
    d1 = make_daemon(1)
    before = _serve_counters(d1)
    batch_outs = [str(tmp_path / f"batch{i}") for i in range(3)]
    jobs = _submit_wait(d1, folder, batch_outs)
    assert all(j["state"] == "done" for j in jobs), [j["error"] for j in jobs]
    assert _serve_counters(d1, before)["serve_batches"] >= 1, "no batch formed"
    batched = [j for j in jobs if j["batch"] is not None]
    assert len(batched) >= 2 and len({j["batch"] for j in batched}) == 1

    _prime(folder, book=jax_plancache)
    jd = jax_daemon.Daemon(str(tmp_path / "jax.sock"), journal=False)
    jd.start()
    try:
        jax_outs = [str(tmp_path / f"jax{i}") for i in range(3)]
        ids = [jax_client.submit(folder, jd.socket_path, {"output": o})["id"] for o in jax_outs]
        for jid in ids:
            assert jax_client.wait(jid, jd.socket_path, timeout=300)["job"]["state"] == "done"
    finally:
        jd.stop()
    for o in solo_outs + batch_outs + jax_outs:
        with open(o, "rb") as f:
            assert f.read() == want


def test_mixed_fingerprints_never_cobatch(tmp_path, batch_env, make_daemon):
    """Only jobs of one group key batch: a queue interleaving two groups
    batches each with its own kind, past the interleaved job."""
    folder_a, _ = _chain_folder(tmp_path, seed=7, name="a")
    folder_b, _ = _chain_folder(tmp_path, seed=8, name="b")
    blocker, _ = _chain_folder(tmp_path, seed=9, name="blocker")
    _prime(folder_a, "fp-a")
    _prime(folder_b, "fp-b")  # the blocker has no group key: it runs solo at once
    runner, batch_runner, solo, batches, gate = _recording_runners(blocker)
    d = make_daemon(runner=runner, batch_runner=batch_runner)
    blk = client.submit(blocker, d.socket_path, {"output": "x"})["id"]
    a1 = client.submit(folder_a, d.socket_path, {"output": "x"})["id"]
    b1 = client.submit(folder_b, d.socket_path, {"output": "x"})["id"]
    a2 = client.submit(folder_a, d.socket_path, {"output": "x"})["id"]
    gate.set()
    jobs = {j: client.wait(j, d.socket_path, timeout=60.0)["job"] for j in (blk, a1, b1, a2)}
    assert all(j["state"] == "done" for j in jobs.values())
    assert [a1, a2] in batches
    assert (b1, False) in solo and not any(b1 in call for call in batches)
    assert jobs[a1]["batch"] == jobs[a2]["batch"] is not None
    assert jobs[b1]["batch"] is None


def test_window_bounds_added_latency(tmp_path, batch_env, make_daemon):
    """A lone head waits the window, then runs solo; a mate's queue wait is
    at most the window and the head's execute."""
    folder, _ = _chain_folder(tmp_path)
    _prime(folder)
    window = 0.4
    batch_env.setenv("SPGEMM_TPU_SERVE_BATCH_WINDOW_S", str(window))
    d = make_daemon(runner=lambda job, degraded=False: None,
                    batch_runner=lambda jobs, degraded=False: None)
    t0 = time.time()
    [lone] = _submit_wait(d, folder, [str(tmp_path / "lone")])
    assert lone["state"] == "done" and lone["batch"] is None
    assert time.time() - t0 < window + 10.0
    jobs = _submit_wait(d, folder, [str(tmp_path / "j0"), str(tmp_path / "j1")])
    assert all(j["state"] == "done" for j in jobs)
    assert jobs[0]["batch"] == jobs[1]["batch"] is not None
    head_exec = jobs[0]["detail"]["phases_s"].get("serve_execute", 0.0)
    mate_wait = jobs[1]["detail"]["phases_s"].get("serve_queue_wait")
    assert mate_wait is not None and mate_wait <= window + head_exec + 5.0


def test_per_job_records_stay_individual(tmp_path, batch_env, make_daemon):
    """Each member keeps its own trace id, journal lifecycle and phases.
    Left out until the obs layer is ported: the span trace's batch tags
    and the SLO engine's per-tenant count (tests/test_serve_batch.py:
    222-240)."""
    folder, _ = _chain_folder(tmp_path)
    _prime(folder)
    d = make_daemon(runner=lambda job, degraded=False: None,
                    batch_runner=lambda jobs, degraded=False: None, journal=True)
    jobs = _submit_wait(d, folder, [str(tmp_path / f"o{i}") for i in range(3)], tenant="acme")
    assert all(j["state"] == "done" for j in jobs)
    batched = [j for j in jobs if j["batch"] is not None]
    assert len(batched) >= 2
    assert len({j["trace"] for j in jobs}) == len(jobs)
    for j in batched:
        assert {"serve_queue_wait", "serve_execute"} <= set(j["detail"]["phases_s"])
        assert j["tenant"] == "acme" and j["detail"]["tenant"] == "acme"
    with open(d.journal_path) as f:
        recs = [journal_parse_line(ln.strip()) for ln in f if ln.strip()]
    by_job = {}
    for rec in recs:
        by_job.setdefault(rec["id"], set()).add(rec["event"])
    for j in jobs:
        assert by_job[j["id"]] == {"submit", "done"}


def test_drr_fairness_decides_membership_before_formation(tmp_path, batch_env, make_daemon):
    """With a chatty tenant's jobs queued first, the quiet tenant's job of
    the same structure is in the first batch (K = 4)."""
    folder, _ = _chain_folder(tmp_path)
    blocker, _ = _chain_folder(tmp_path, seed=9, name="blocker")
    _prime(folder)
    batch_env.setenv("SPGEMM_TPU_SERVE_BATCH_K", "4")
    runner, batch_runner, _, batches, gate = _recording_runners(blocker)
    d = make_daemon(runner=runner, batch_runner=batch_runner)
    blk = client.submit(blocker, d.socket_path, {"output": "x"})["id"]
    chatty = [client.submit(folder, d.socket_path, {"output": "x"}, tenant="chatty")["id"]
              for _ in range(5)]
    quiet = client.submit(folder, d.socket_path, {"output": "x"}, tenant="quiet")["id"]
    gate.set()
    for j in [blk] + chatty + [quiet]:
        assert client.wait(j, d.socket_path, timeout=60.0)["job"]["state"] == "done"
    assert batches, "no batch formed"
    assert quiet in batches[0] and len(batches[0]) <= 4


# ------------------------------------------------------- the daemon --
def test_a_first_contact_records_the_structure_then_resubmits_batch(tmp_path, batch_env,
                                                                    make_daemon):
    """No priming: the first submit has no group key and runs solo, and its
    runner records the chain's structure fingerprint; three resubmits then
    batch through run_chain_jobs with the oracle's bytes."""
    folder, want = _chain_folder(tmp_path, n=4, seed=21)
    d = make_daemon()
    [first] = _submit_wait(d, folder, [str(tmp_path / "first")])
    assert first["state"] == "done" and first["batch"] is None
    mats = io_text.read_chain(folder, 0, 3, 2)
    assert plancache.chain_structure(placement.signature(folder)) == \
        plancache.chain_fingerprint([m.coords for m in mats])
    outs = [str(tmp_path / f"again{i}") for i in range(3)]
    before = _serve_counters(d)
    jobs = _submit_wait(d, folder, outs)
    assert all(j["state"] == "done" for j in jobs)
    assert len({j["batch"] for j in jobs}) == 1 and jobs[0]["batch"] is not None
    st = _serve_counters(d, before)
    assert st["serve_batches"] == 1 and st["serve_batched_jobs"] == 3
    for o in outs + [str(tmp_path / "first")]:
        with open(o, "rb") as f:
            assert f.read() == want


def test_the_jax_client_reads_batch_from_the_port_daemon(tmp_path, batch_env, make_daemon):
    folder, want = _chain_folder(tmp_path, seed=22)
    _prime(folder)
    d = make_daemon()
    outs = [str(tmp_path / f"o{i}") for i in range(3)]
    ids = [jax_client.submit(folder, d.socket_path, {"output": o})["id"] for o in outs]
    jobs = [jax_client.wait(j, d.socket_path, timeout=120)["job"] for j in ids]
    assert all(j["state"] == "done" for j in jobs)
    assert {j["batch"] for j in jobs} == {ids[0]}
    for o in outs:
        with open(o, "rb") as f:
            assert f.read() == want


@pytest.mark.parametrize("case", ["window_zero", "delta_on", "failover", "checkpoint_dir"])
def test_no_batch_forms(case, tmp_path, batch_env, make_daemon):
    """Window 0 (the default: PR 14's executor, the histogram untouched),
    SPGEMM_TPU_DELTA=1, and a failover or checkpoint option each run every
    job solo."""
    folder, _ = _chain_folder(tmp_path)
    _prime(folder)
    options = {}
    if case == "window_zero":
        batch_env.setenv("SPGEMM_TPU_SERVE_BATCH_WINDOW_S", "0")
    elif case == "delta_on":
        batch_env.setenv("SPGEMM_TPU_DELTA", "1")
    elif case == "failover":
        options["failover"] = True
    else:
        options["checkpoint_dir"] = str(tmp_path / "ckpt")
    runner, batch_runner, solo, batches, _ = _recording_runners()
    d = make_daemon(runner=runner, batch_runner=batch_runner)
    before = _serve_counters(d)
    jobs = _submit_wait(d, folder, [str(tmp_path / f"o{i}") for i in range(3)], **options)
    assert all(j["state"] == "done" and j["batch"] is None for j in jobs)
    assert not batches and len(solo) == 3
    assert _serve_counters(d, before)["serve_batches"] == 0
    if case == "window_zero":
        assert d._batch_size["count"] == 0


def test_a_degraded_slice_never_batches(tmp_path, batch_env, make_daemon):
    """A slice on the host oracle runs every job solo, degraded."""
    folder, _ = _chain_folder(tmp_path)
    _prime(folder)
    runner, batch_runner, solo, batches, _ = _recording_runners()
    d = make_daemon(runner=runner, batch_runner=batch_runner)
    d.degrade_at_start("a dead card, for the test", "error")
    jobs = _submit_wait(d, folder, [str(tmp_path / f"o{i}") for i in range(3)])
    assert all(j["state"] == "done" and j["batch"] is None for j in jobs)
    assert not batches and [deg for _, deg in solo] == [True, True, True]


def test_a_canary_pickup_never_batches(tmp_path, batch_env, make_daemon):
    """The first pickup after a reinstatement auditions the card alone; the
    next pickup batches what is left."""
    folder, _ = _chain_folder(tmp_path)
    blocker, _ = _chain_folder(tmp_path, seed=9, name="blocker")
    _prime(folder)
    runner, batch_runner, solo, batches, gate = _recording_runners(blocker)
    d = make_daemon(runner=runner, batch_runner=batch_runner)
    blk = client.submit(blocker, d.socket_path, {"output": "x"})["id"]
    deadline = time.time() + 30  # running: its pickup has passed the canary check
    while client.status(blk, d.socket_path)["job"]["state"] != "running" \
            and time.time() < deadline:
        time.sleep(0.01)
    with d._lock:
        d.slices[0].canary = True  # as a live probe's reinstatement leaves it
    ids = [client.submit(folder, d.socket_path, {"output": "x"})["id"] for _ in range(3)]
    gate.set()
    jobs = [client.wait(j, d.socket_path, timeout=60.0)["job"] for j in [blk] + ids]
    assert all(j["state"] == "done" for j in jobs)
    assert (ids[0], False) in solo and jobs[1]["batch"] is None
    assert batches == [ids[1:]]


def test_a_failing_batch_fails_every_member_and_never_reruns_on_the_host(
        tmp_path, batch_env, make_daemon, monkeypatch):
    """execute_batched raising, as a kernel that fails to build or launch
    would: every member fails with the error, no output is written, nothing
    runs on the host oracle and the slice does not degrade."""
    folder, _ = _chain_folder(tmp_path)
    _prime(folder)

    def failing(*args, **kw):
        raise RuntimeError("numeric_round kernel launch failed: CUDA error 209 (injected)")

    oracle_calls = []
    monkeypatch.setattr(chain, "execute_batched", failing)
    for name in ("oracle_multiply", "field_oracle_multiply"):
        real = getattr(chain, name)
        monkeypatch.setattr(chain, name, lambda *a, _real=real, **kw: (
            oracle_calls.append(1), _real(*a, **kw))[1])
    d = make_daemon()
    before = _serve_counters(d)
    outs = [str(tmp_path / f"o{i}") for i in range(3)]
    jobs = _submit_wait(d, folder, outs)
    assert [j["state"] for j in jobs] == ["failed"] * 3
    assert all("CUDA error 209" in j["error"]["message"] for j in jobs)
    assert len({j["batch"] for j in jobs}) == 1 and jobs[0]["batch"] is not None
    assert not oracle_calls and not any(j["detail"]["degraded"] for j in jobs)
    st = client.stats(d.socket_path)
    assert not st["degraded"] and st["slices"][0]["oracle_jobs"] == 0
    assert _serve_counters(d, before)["serve_degrades"] == 0
    assert not any(os.path.exists(o) for o in outs)


def test_a_reaped_head_fails_its_mates(tmp_path, batch_env, make_daemon):
    """The head is the watchdog's job: reaped past its deadline, the batch
    ends at its next heartbeat and every mate fails with the structured
    co-batched error naming the head."""
    folder, _ = _chain_folder(tmp_path)
    _prime(folder)

    def batch_runner(jobs, degraded=False):
        deadline = time.time() + 30
        while jobs[0].state not in ("done", "failed") and time.time() < deadline:
            time.sleep(0.01)
        raise JobAbandoned(jobs[0].id)

    d = make_daemon(batch_runner=batch_runner, job_timeout_s=0.3, wedge_grace_s=60.0)
    jobs = _submit_wait(d, folder, [str(tmp_path / f"o{i}") for i in range(3)])
    assert jobs[0]["state"] == "failed" and jobs[0]["error"]["code"] == "job-timeout"
    for j in jobs[1:]:
        assert j["state"] == "failed" and j["batch"] == jobs[0]["id"]
        assert f"co-batched with job {jobs[0]['id']}" in j["error"]["message"]
    assert not client.stats(d.socket_path)["degraded"]


def test_a_stale_structure_book_runs_each_job_solo(tmp_path, batch_env, make_daemon):
    """Two folders of different structures recorded under one fingerprint
    batch at admission; run_chain_jobs finds their chains differ and runs
    each solo, each with its own oracle's bytes."""
    folder_a, want_a = _chain_folder(tmp_path, seed=31, name="a")
    folder_b, want_b = _chain_folder(tmp_path, seed=32, name="b")
    _prime(folder_a, "fp-same")
    _prime(folder_b, "fp-same")
    d = make_daemon()
    ids = [client.submit(f, d.socket_path, {"output": str(tmp_path / f"{n}.out")})["id"]
           for f, n in ((folder_a, "a"), (folder_b, "b"))]
    jobs = [client.wait(j, d.socket_path, timeout=120)["job"] for j in ids]
    assert all(j["state"] == "done" for j in jobs)
    assert jobs[0]["batch"] == jobs[1]["batch"] is not None
    for name, want in (("a", want_a), ("b", want_b)):
        with open(tmp_path / f"{name}.out", "rb") as f:
            assert f.read() == want
