"""The port's structure-keyed plan cache (ops/plancache.py, wired into
ops/spgemm.plan): hits on a repeated structure, misses on any parameter the
plan depends on and on the operand dims, LRU eviction, the off switch,
read-only cached plans, builds across threads, and a banded chain whose
hits are its multiplies less its distinct operand structures, with the
bytes of the cache off and of the JAX package's chain (SPGEMM_TPU_DELTA=0).
Tolerance: exact."""

import sys
import threading

import numpy as np
import pytest

from spgemm_tpu.chain import chain_product as jax_chain_product
from spgemm_tpu.utils.gen import banded_block_sparse as jax_banded
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops import plancache
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.ops.spgemm import launch_key_cap, plan
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import random_block_sparse
from spgemm_tpu_torch.utils.timers import ENGINE


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    monkeypatch.delenv("SPGEMM_TPU_PLAN_CACHE", raising=False)
    monkeypatch.delenv("SPGEMM_TPU_PLAN_CACHE_CAP", raising=False)
    plancache.clear()
    ENGINE.reset()
    yield
    plancache.clear()


def _pair(seed, dist="full", shape=(6, 6)):
    rng = np.random.default_rng(seed)
    return (random_block_sparse(*shape, 2, 0.5, rng, dist),
            random_block_sparse(*shape, 2, 0.5, rng, dist))


def _revalue(m, seed):
    """m's structure with other values."""
    tiles = np.random.default_rng(seed).integers(0, 1 << 64, size=m.tiles.shape,
                                                 dtype=np.uint64)
    return BlockSparseMatrix(rows=m.rows, cols=m.cols, k=m.k, coords=m.coords.copy(),
                             tiles=tiles)


def test_hit_on_the_same_structure():
    a, b = _pair(1)
    p = plan(a, b)
    assert plan(_revalue(a, 2), _revalue(b, 3)) is p
    assert plancache.stats() == {"hits": 1, "misses": 1, "evictions": 0, "entries": 1}
    assert ENGINE.counters == {"plan_cache_misses": 1, "plan_cache_hits": 1}
    assert ENGINE.counts["plan"] == 2


def _with_dims(m, rows, cols):
    return BlockSparseMatrix(rows=rows, cols=cols, k=m.k, coords=m.coords, tiles=m.tiles)


@pytest.mark.parametrize("change", ["structure", "backend", "round_size", "split", "dims"])
def test_miss_on_anything_the_key_holds(change):
    a, b = _pair(4, "small")
    p = plan(a, b, backend="hybrid")
    if change == "structure":
        a2, b2 = _pair(5, "small")
        q = plan(a2, b2, backend="hybrid")
    elif change == "backend":
        q = plan(a, b, backend="exact")
    elif change == "round_size":
        assert plan(a, b, backend="hybrid", round_size=launch_key_cap(2) + 1) is p  # same cap
        q = plan(a, b, backend="hybrid", round_size=2)
        assert max(r.pa.shape[0] for r in q.rounds) <= 2
    elif change == "split":  # other bounds, another proof split
        big = _revalue(a, 6)
        q = plan(big, b, backend="hybrid")
        assert q.split_fanout != p.split_fanout
    else:  # the same coords under other dims: the reference's delta-store fault
        q = plan(_with_dims(a, a.rows + 2, a.cols), b, backend="hybrid")
    assert q is not p
    assert plancache.stats()["misses"] == 2


def test_lru_eviction_at_the_cap(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE_CAP", "2")
    pairs = [_pair(10 + i) for i in range(3)]
    plans = [plan(*ab) for ab in pairs]
    assert plancache.stats()["evictions"] == 1 and plancache.stats()["entries"] == 2
    assert plan(*pairs[2]) is plans[2] and plan(*pairs[1]) is plans[1]
    assert plan(*pairs[0]) is not plans[0]  # evicted, planned again
    monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE_CAP", "0")
    with pytest.raises(ValueError, match="SPGEMM_TPU_PLAN_CACHE_CAP"):
        plan(*_pair(19))  # a miss stores, and reads the cap


def test_cache_off_never_stores(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE", "0")
    a, b = _pair(20)
    p, q = plan(a, b), plan(a, b)
    assert p is not q
    assert plancache.stats() == {"hits": 0, "misses": 0, "evictions": 0, "entries": 0}
    assert "plan_cache_hits" not in ENGINE.counters
    assert p.join.keys.flags.writeable  # an uncached plan is the caller's alone
    monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE", "2")
    with pytest.raises(ValueError, match="SPGEMM_TPU_PLAN_CACHE must be 0 or 1"):
        plan(a, b)


def test_cached_arrays_are_read_only():
    a, b = _pair(30)
    p = plan(a, b)
    arrays = [p.join.keys, p.join.pair_ptr, p.join.pair_a, p.join.pair_b, p.join.fanouts,
              p.take, p.a_coords, p.b_coords]
    arrays += [x for r in p.rounds for x in (r.key_index, r.pa, r.pb)]
    assert not any(x.flags.writeable for x in arrays)
    with pytest.raises(ValueError, match="read-only"):
        p.join.keys[0, 0] = 7
    assert a.coords.flags.writeable and b.coords.flags.writeable  # the operands' own
    res = DeviceBlockMatrix.from_host(a, "cpu")
    assert np.array_equal(plan(res, b).a_coords, a.coords)


def test_one_miss_per_structure_across_threads():
    """Eight threads plan three structures at once: each structure misses
    once (a key in flight is built by one thread, the others wait for it)
    and every thread gets the same plan object for it."""
    pairs = [_pair(40 + i) for i in range(3)]
    got = {i: [] for i in range(3)}
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            try:
                for j in range(12):
                    i = (t + j) % 3
                    got[i].append(plan(*pairs[i]))
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert plancache.stats()["misses"] == 3 and plancache.stats()["hits"] == 8 * 12 - 3
    assert all(len({id(p) for p in ps}) == 1 for ps in got.values())


def test_two_keys_build_at_once():
    """The lock is not held through a build: key b's build runs while key
    a's is still inside build()."""
    a_started, b_built, out = threading.Event(), threading.Event(), []

    def build_a():
        a_started.set()
        assert b_built.wait(10), "key b's build waited for key a's"
        return "A"

    def build_b():
        b_built.set()
        return "B"

    t = threading.Thread(target=lambda: out.append(plancache.get_or_build("a", build_a)))
    t.start()
    assert a_started.wait(10)
    assert plancache.get_or_build("b", build_b) == ("B", False)
    t.join(timeout=10)
    assert out == [("A", False)]
    assert plancache.get_or_build("a", build_a) == ("A", True)


def test_a_failed_build_leaves_no_key_in_flight():
    def boom():
        raise RuntimeError("build failed")

    with pytest.raises(RuntimeError, match="build failed"):
        plancache.get_or_build("a", boom)
    assert plancache.get_or_build("a", lambda: "A") == ("A", False)
    assert plancache.stats() == {"hits": 0, "misses": 2, "evictions": 0, "entries": 1}


def _distinct_structures(mats) -> int:
    """Distinct (operand structure, dims) pairs over helper2's multiplies."""
    arr = [(m.coords, m.rows, m.cols) for m in mats]
    seen = set()
    while len(arr) > 1:
        nxt = []
        for (ac, ar, acl), (bc, br, bcl) in zip(arr[0::2], arr[1::2]):
            seen.add((ac.tobytes(), bc.tobytes(), ar, acl, br, bcl))
            p = plan(BlockSparseMatrix(ar, acl, 2, ac), BlockSparseMatrix(br, bcl, 2, bc))
            nxt.append((p.join.keys, ar, bcl))
        arr = nxt + arr[len(nxt) * 2:]
    return len(seen)


@pytest.mark.parametrize("ahead", ["0", "2"])
def test_banded_chain_hits_multiplies_less_distinct_structures(ahead, monkeypatch, capsys):
    """Ten banded inputs of one structure, as the Medium chain: 9 multiplies
    over 4 distinct operand structures, so 5 hits and 4 misses, and the
    bytes of the cache off and of the JAX package."""
    jmats = [jax_banded(14, 2, 2, np.random.default_rng(50 + i), "adversarial")
             for i in range(10)]
    mats = [BlockSparseMatrix.from_reference(m) for m in jmats]
    monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE", "0")
    distinct = _distinct_structures(mats)
    off = chain_product(mats, device="cpu")
    monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE", "1")
    monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", ahead)
    ENGINE.reset()
    on = chain_product(mats, device="cpu")
    assert distinct == 4
    assert ENGINE.counters["plan_cache_hits"] == 9 - distinct == 5
    assert ENGINE.counters["plan_cache_misses"] == distinct
    assert on == off
    want = jax_chain_product(jmats, backend="xla")
    assert np.array_equal(on.coords, want.coords) and np.array_equal(on.tiles, want.tiles)
    ENGINE.reset()
    assert chain_product(mats, device="cpu") == on  # warm: every multiply hits
    assert ENGINE.counters == {"plan_cache_hits": 9}


def test_scoped_stats_and_evictions_in_engine(monkeypatch):
    """stats(since=baseline()) counts one job's hits, misses and evictions,
    not the process's; each eviction is also ENGINE's plan_cache_evictions."""
    monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE_CAP", "1")
    a, b = _pair(40)
    plan(a, b)
    base = plancache.baseline()
    ENGINE.reset()
    plan(b, a)  # evicts a x b
    plan(b, a)
    assert plancache.stats(since=base) == {"hits": 1, "misses": 1, "evictions": 1,
                                           "entries": 1}
    assert plancache.stats()["misses"] == 2
    assert ENGINE.counters["plan_cache_evictions"] == 1
    assert len(plancache.entries()) == 1
