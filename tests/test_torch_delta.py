"""Delta recompute in the port (spgemm_tpu_torch/ops/delta.py, the delta
path of ops/spgemm.spgemm_device, the splice of ops/cuda_splice.py): held
against the port with delta off, the JAX package with delta off
(SPGEMM_TPU_DELTA=0, clear of the reference's rows/cols fault), and, for the
counters, the JAX package with delta on over chains whose matrices have
distinct dims.  Inputs from numpy seeds at small sizes.  Tolerance: exact
(bytes) everywhere."""

import contextlib
import io
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgemm_tpu.chain import chain_product as jax_chain_product
from spgemm_tpu.ops import delta as jax_delta
from spgemm_tpu.ops import plancache as jax_plancache
from spgemm_tpu.ops.spgemm import _splice_impl as jax_splice_impl
from spgemm_tpu.ops.spgemm import plan as jax_plan
from spgemm_tpu.ops.spgemm import subplan as jax_subplan
from spgemm_tpu.ops.symbolic import slice_join as jax_slice_join
from spgemm_tpu.utils.gen import random_block_sparse as jax_random_block_sparse
from spgemm_tpu.utils.timers import ENGINE as JAX_ENGINE
from spgemm_tpu_torch import cli
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops import cuda_splice, delta, plancache
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.ops.spgemm import Folds, execute, plan, spgemm_device, subplan
from spgemm_tpu_torch.ops.symbolic import slice_join, symbolic_join
from spgemm_tpu_torch.utils import knobs
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import banded_block_sparse, random_block_sparse
from spgemm_tpu_torch.utils.semantics import spgemm_oracle
from spgemm_tpu_torch.utils.timers import ENGINE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden_chain")
COUNTERS = ("delta_rows_recomputed", "delta_rows_total", "delta_full_fallbacks")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for mod in (delta, plancache, jax_delta, jax_plancache):
        mod.clear()
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "1")
    yield
    for mod in (delta, plancache, jax_delta, jax_plancache):
        mod.clear()


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def _port(mats, monkeypatch, on: bool, **kw):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "1" if on else "0")
    return _quiet(chain_product, mats, device="cpu", **kw)


def _jax(mats, monkeypatch, on: bool):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "1" if on else "0")
    return BlockSparseMatrix.from_reference(
        _quiet(jax_chain_product, [_to_jax(m) for m in mats], backend="xla"))


def _to_jax(m: BlockSparseMatrix):
    from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxBSM

    return JaxBSM(rows=m.rows, cols=m.cols, k=m.k, coords=m.coords.copy(), tiles=m.tiles.copy())


def _edit(m: BlockSparseMatrix, rows) -> BlockSparseMatrix:
    """The same structure, new values in every tile of the given tile-rows."""
    tiles = m.tiles.copy()
    mask = np.isin(m.coords[:, 0], np.asarray(list(rows), np.int64))
    tiles[mask] ^= np.uint64(0x9E3779B97F4A7C15)
    return BlockSparseMatrix(rows=m.rows, cols=m.cols, k=m.k, coords=m.coords, tiles=tiles)


def _shifted_band(n: int, block_dim: int, k: int, bandwidth: int, seed: int) -> list:
    """The Medium chain of distinct structures at a small size: input i's
    band shifted i blocks, so no two multiplies share a structure."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = banded_block_sparse(block_dim, k, bandwidth, rng)
        coords = m.coords + np.array([0, i], m.coords.dtype)
        keep = coords[:, 1] < block_dim
        out.append(BlockSparseMatrix(rows=m.rows, cols=m.cols, k=k, coords=coords[keep],
                                     tiles=m.tiles[keep]))
    return out


def _distinct_dims(seed: int, dims=(7, 5, 9, 6, 8, 4), k: int = 2) -> list:
    """A chain whose matrices all have other dims (the JAX package's delta
    keys leave dims out, so repeated dims could meet its fault)."""
    rng = np.random.default_rng(seed)
    return [BlockSparseMatrix.from_reference(
        jax_random_block_sparse(dims[i], dims[i + 1], k, 0.5, rng, "adversarial"))
        for i in range(len(dims) - 1)]


def _rows_of(m: BlockSparseMatrix) -> np.ndarray:
    return np.unique(m.coords[:, 0])


# ------------------------------------------------------------------ digests --
def test_row_digests_mark_exactly_the_changed_rows_and_equal_the_jax_digests():
    rng = np.random.default_rng(201)
    a = random_block_sparse(8, 8, 2, 0.6, rng, "full")
    dirty = _rows_of(a)[:2]
    a2 = _edit(a, dirty)
    ids1, d1 = delta.row_digests(a.coords, a.tiles)
    ids2, d2 = delta.row_digests(a2.coords, a2.tiles)
    assert np.array_equal(ids1, ids2)
    assert np.array_equal(ids1[d1 != d2], dirty)
    jids, jd = jax_delta.row_digests(a.coords, a.tiles)
    assert np.array_equal(ids1, jids) and np.array_equal(d1, jd)


@pytest.mark.parametrize("workers", [2, 3, 8])
def test_row_digests_on_a_pool_equal_one_thread(workers, monkeypatch):
    monkeypatch.setattr(delta, "PARALLEL_MIN_BYTES", 0)
    a = random_block_sparse(40, 30, 2, 0.5, np.random.default_rng(218), "full")
    one = delta.row_digests(a.coords, a.tiles, workers=1)
    got = delta.row_digests(a.coords, a.tiles, workers=workers)
    assert np.array_equal(got[0], one[0]) and np.array_equal(got[1], one[1])


def test_row_digests_empty_operand():
    ids, digs = delta.row_digests(np.zeros((0, 2), np.int64), np.zeros((0, 2, 2), np.uint64))
    assert len(ids) == 0 and len(digs) == 0


def test_a_stash_goes_with_one_multiply_and_attaches_nothing():
    rng = np.random.default_rng(202)
    a = random_block_sparse(6, 6, 2, 0.6, rng, "full")
    d = DeviceBlockMatrix.from_host(a, "cpu")
    assert d._host is a
    want = delta.row_digests(a.coords, a.tiles)
    got_d, got_a = delta.stash_digests(d, a)
    for got in (got_d, got_a, delta.current_digests(d, got_d)):
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert set(vars(a)) == {"rows", "cols", "k", "coords", "tiles"}
    assert set(vars(d)) == {"rows", "cols", "k", "coords", "slab", "val_bound", "_host"}
    a.tiles[0, 0, 0] ^= np.uint64(1)  # changed in place after the stash was made
    again = delta.current_digests(d)
    assert not np.array_equal(want[1], again[1])
    opaque = DeviceBlockMatrix(rows=d.rows, cols=d.cols, k=2, coords=d.coords, slab=d.slab)
    assert delta.stash_digests(opaque, a)[0] is None


@pytest.mark.parametrize("first", ["opaque partner", "plan cache off"])
def test_digests_made_ahead_never_outlive_their_multiply(first, monkeypatch):
    """The plan-ahead worker hashes a pass's host leaves ahead.  When no
    delta multiply takes those digests (the partner is opaque, so the full
    multiply stores nothing; or the plan cache is off, so no multiply takes
    the delta path), they must not be read later as the leaf's digests:
    after an in-place edit a later multiply would store the old rows as its
    provenance, and once the edit is undone it would return the edited
    result as unchanged."""
    monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", "2")
    rng = np.random.default_rng(218)
    leaves = [random_block_sparse(6, 6, 2, 0.6, rng, "full") for _ in range(5)]
    x, y, z = leaves[1], leaves[3], leaves[4]
    if first == "opaque partner":
        opaque = []
        for m in (leaves[0], leaves[2]):
            d = DeviceBlockMatrix.from_host(m, "cpu")
            opaque.append(DeviceBlockMatrix(rows=d.rows, cols=d.cols, k=2, coords=d.coords,
                                            slab=d.slab))
        _quiet(chain_product, [opaque[0], x, opaque[1], y], device="cpu")
        assert delta.stats()["entries"] == 0  # nothing stored: an opaque operand
    else:
        monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE", "0")
        _quiet(chain_product, [leaves[0], x, leaves[2], y], device="cpu")
        monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE", "1")
    first_values = x.tiles.copy()
    x.tiles[np.isin(x.coords[:, 0], _rows_of(x)[:1])] ^= np.uint64(0x9E3779B97F4A7C15)
    spgemm_device(x, z, device="cpu")  # first contact with x edited in place
    x.tiles[:] = first_values  # the edit undone, in place
    got = spgemm_device(x, z, device="cpu")
    want = spgemm_oracle(x.to_dict(), z.to_dict(), 2)
    assert got.to_host() == BlockSparseMatrix.from_dict(x.rows, z.cols, 2, want)
    assert delta.stats()["rows_recomputed"] > 0  # x's first row is dirty against its edit


# ------------------------------------------------------ slice_join, subplan --
@pytest.mark.parametrize("seed", [203, 204, 205])
def test_slice_join_and_subplan_equal_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    a = random_block_sparse(9, 7, 2, 0.5, rng, "full")
    b = random_block_sparse(7, 8, 2, 0.5, rng, "full")
    join = symbolic_join(a.coords, b.coords)
    keep = rng.random(join.num_keys) < 0.4
    sub, kept = slice_join(join, keep)
    jsub, jkept = jax_slice_join(join, keep)
    for x, y in ((sub.keys, jsub.keys), (sub.pair_ptr, jsub.pair_ptr),
                 (sub.pair_a, jsub.pair_a), (sub.pair_b, jsub.pair_b), (kept, jkept)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    p = plan(a, b)
    sp, kept = subplan(p, keep)
    jp, jkept = jax_subplan(jax_plan(_to_jax(a), _to_jax(b), backend="xla", platform="cpu"),
                            keep)
    assert np.array_equal(kept, jkept)
    for x, y in ((sp.join.keys, jp.join.keys), (sp.join.pair_ptr, jp.join.pair_ptr),
                 (sp.join.pair_a, jp.join.pair_a), (sp.join.pair_b, jp.join.pair_b)):
        assert np.array_equal(x, y)
    # the sub-plan's rows are the full multiply's rows, byte for byte
    da, db = DeviceBlockMatrix.from_host(a, "cpu"), DeviceBlockMatrix.from_host(b, "cpu")
    full = execute(p, da, db)
    part = execute(sp, da, db)
    assert torch.equal(part.slab[:len(kept)], full.slab[torch.from_numpy(kept)])


# ------------------------------------------------------------------- splice --
@pytest.mark.parametrize("n_keys,n_sub,k", [(10, 3, 2), (33, 33, 3), (17, 0, 4), (40, 12, 1)])
def test_splice_ref_equals_the_jax_splice(n_keys, n_sub, k):
    """splice_ref over source_map(idx, take) equals _splice_impl's
    prev.at[idx].set(sub[take]) with the JAX package's ladder padding (pad
    slots write sub's zero row onto the sentinel row)."""
    rng = np.random.default_rng(206 + n_keys)
    prev = rng.integers(0, 2**64, (n_keys + 1, k, k), dtype=np.uint64)
    prev[-1] = 0
    sub = rng.integers(0, 2**64, (n_sub + 1, k, k), dtype=np.uint64)
    sub[-1] = 0
    kept = np.sort(rng.choice(n_keys, n_sub, replace=False)).astype(np.int64)
    rung = max(1, 1 << int(np.ceil(np.log2(max(n_sub, 1)))))
    idx = np.full(rung, n_keys, np.int64)
    idx[:n_sub] = kept
    take = np.full(rung, n_sub, np.int64)
    take[:n_sub] = np.arange(n_sub)
    def planes(x):
        return (jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
                jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)))

    hi, lo = jax_splice_impl(*planes(prev), jnp.asarray(idx), jnp.asarray(take), *planes(sub))
    want = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)
    prev_t = torch.from_numpy(prev.view(np.int64))
    src = torch.from_numpy(cuda_splice.source_map(idx, take, n_keys + 1))
    got = cuda_splice.splice_ref(prev_t, torch.from_numpy(sub.view(np.int64)), src)
    assert np.array_equal(got.numpy().view(np.uint64), want)
    assert np.array_equal(prev_t.numpy().view(np.uint64), prev)  # prev untouched
    before = ENGINE.counter_snapshot().get("launches_splice", 0)
    assert torch.equal(cuda_splice.splice(prev_t, torch.from_numpy(sub.view(np.int64)), src), got)
    # a CPU tensor takes the plain version
    assert ENGINE.counter_snapshot().get("launches_splice", 0) == before


def test_splice_checks_its_operands():
    prev = torch.zeros((4, 2, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="source map"):
        cuda_splice.splice(prev, prev, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError):
        cuda_splice.splice(prev.int(), prev, torch.zeros(4, dtype=torch.int64))


# --------------------------------------------------- whole-chain sequences --
def _sequence(kind: str, mats: list) -> list:
    """Submits after the first: the same inputs, then one edit of leaf 2."""
    m = mats[2]
    rows = _rows_of(m)
    edits = {
        "none": lambda: m,
        "contiguous": lambda: _edit(m, rows[3:6]),
        "spread": lambda: _edit(m, rows[::5]),
        "every_row": lambda: _edit(m, rows),
        "structure": lambda: BlockSparseMatrix(rows=m.rows, cols=m.cols, k=m.k,
                                               coords=m.coords[1:], tiles=m.tiles[1:]),
    }
    edited = list(mats)
    edited[2] = edits[kind]()
    return [mats, mats, edited, edited]


@pytest.mark.parametrize("ahead", ["0", "2"])
@pytest.mark.parametrize("kind", ["none", "contiguous", "spread", "every_row", "structure"])
def test_delta_chain_equals_full_recompute_and_the_jax_package(kind, ahead, monkeypatch):
    """Each submit of a sequence with delta on gives the bytes of the port
    with delta off and of the JAX package with delta off."""
    monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", ahead)
    for i, mats in enumerate(_sequence(kind, _shifted_band(6, 24, 2, 2, 207))):
        got = _port(mats, monkeypatch, True)
        assert got == _port(mats, monkeypatch, False), (kind, i)
        assert got == _jax(mats, monkeypatch, False), (kind, i)


@pytest.mark.parametrize("backend", ["hybrid", "mxu"])
def test_delta_under_hybrid_and_mxu(backend, monkeypatch):
    mats = _shifted_band(5, 20, 2, 2, 208)
    for i, ms in enumerate(_sequence("contiguous", mats)):
        assert _port(ms, monkeypatch, True, backend=backend) == \
            _port(ms, monkeypatch, False, backend=backend), i


def test_counters_equal_the_jax_package(monkeypatch):
    """delta_rows_recomputed, _total and _full_fallbacks of each submit
    equal the JAX package's with delta on, on a chain of distinct dims."""
    mats = _distinct_dims(209)
    rows = _rows_of(mats[1])
    seq = [mats, mats, [mats[0], _edit(mats[1], rows[:1])] + mats[2:],
           [mats[0], _edit(mats[1], rows[-2:])] + mats[2:]]
    for i, ms in enumerate(seq):
        ENGINE.reset()
        JAX_ENGINE.reset()
        got = _port(ms, monkeypatch, True)
        want = _jax(ms, monkeypatch, True)
        assert got == want
        ours = {name: ENGINE.counters.get(name, 0) for name in COUNTERS}
        theirs = {name: JAX_ENGINE.counter_snapshot().get(name, 0) for name in COUNTERS}
        assert ours == theirs, (i, ours, theirs)
    assert delta.stats()["hits"] == jax_delta.stats()["hits"]


def test_shared_structure_keys_fall_back_like_the_jax_package(monkeypatch):
    """A chain of one structure: the multiplies of a level share one key,
    so each diffs against its sibling and recomputes every row, in both
    packages (the bytes stay right)."""
    rng = np.random.default_rng(210)
    mats = [banded_block_sparse(12, 2, 1, rng) for _ in range(6)]
    for _ in range(2):
        ENGINE.reset()
        JAX_ENGINE.reset()
        assert _port(mats, monkeypatch, True) == _jax(mats, monkeypatch, True)
        ours = {name: ENGINE.counters.get(name, 0) for name in COUNTERS}
        theirs = {name: JAX_ENGINE.counter_snapshot().get(name, 0) for name in COUNTERS}
        assert ours == theirs
    assert ours["delta_rows_recomputed"] == ours["delta_rows_total"]


# ---------------------------------------------------------- pinned cases --
def test_the_jax_dims_fault_case_gives_the_right_dims():
    """Two empty 2x2 matrices at k = 2, then two empty 4x4: the JAX package
    answers the second from the first's retained result (2x2); the port's
    key holds the dims."""
    for n in (2, 4, 2):
        e = BlockSparseMatrix(rows=n, cols=n, k=2)
        got = spgemm_device(e, e, device="cpu")
        assert (got.rows, got.cols, got.nnzb) == (n, n, 0)
        assert got.to_host() == BlockSparseMatrix(rows=n, cols=n, k=2)


def test_the_previous_result_is_not_changed_by_a_splice():
    rng = np.random.default_rng(211)
    a = random_block_sparse(10, 10, 2, 0.5, rng, "full")
    b = random_block_sparse(10, 10, 2, 0.5, rng, "full")
    first = spgemm_device(a, b, device="cpu")
    kept = first.slab.clone()
    ENGINE.reset()
    second = spgemm_device(_edit(a, _rows_of(a)[:2]), b, device="cpu")
    assert ENGINE.counts["delta_splice"] == 1
    assert torch.equal(first.slab, kept)
    assert second.slab.data_ptr() != first.slab.data_ptr()
    want = spgemm_oracle(_edit(a, _rows_of(a)[:2]).to_dict(), b.to_dict(), 2)
    assert second.to_host() == BlockSparseMatrix.from_dict(a.rows, b.cols, 2, want)


def _counting_folds():
    from spgemm_tpu_torch.ops.cuda_spgemm import numeric_round

    calls = {"exact": 0, "splice": 0}

    def exact(*args, **kw):
        calls["exact"] += 1
        return numeric_round(*args, **kw)

    def splice(*args):
        calls["splice"] += 1
        return cuda_splice.splice(*args)

    return Folds(exact=exact, splice=splice), calls


def test_an_unchanged_resubmit_launches_nothing():
    rng = np.random.default_rng(212)
    a = random_block_sparse(8, 8, 2, 0.6, rng, "full")
    b = random_block_sparse(8, 8, 2, 0.6, rng, "full")
    folds, calls = _counting_folds()
    first = spgemm_device(a, b, device="cpu", folds=folds)
    n = calls["exact"]
    assert n > 0
    again = spgemm_device(a, b, device="cpu", folds=folds)
    assert again is first and calls == {"exact": n, "splice": 0}
    spgemm_device(_edit(a, _rows_of(a)[:1]), b, device="cpu", folds=folds)
    assert calls["splice"] == 1 and calls["exact"] > n


def test_all_dirty_takes_the_full_multiply():
    rng = np.random.default_rng(213)
    a = random_block_sparse(6, 6, 2, 0.7, rng, "full")
    b = random_block_sparse(6, 6, 2, 0.7, rng, "full")
    spgemm_device(a, b, device="cpu")
    folds, calls = _counting_folds()
    a2 = _edit(a, _rows_of(a))
    got = spgemm_device(a2, b, device="cpu", folds=folds)
    assert calls["splice"] == 0 and calls["exact"] > 0
    assert got.to_host() == BlockSparseMatrix.from_dict(
        a.rows, b.cols, 2, spgemm_oracle(a2.to_dict(), b.to_dict(), 2))
    st = delta.stats()
    assert st["hits"] == 1 and st["rows_recomputed"] == st["rows_total"] > 0


def test_an_evicted_entry_is_a_counted_full_fallback(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA_RETAIN", "1")
    rng = np.random.default_rng(214)
    a = random_block_sparse(6, 6, 2, 0.6, rng, "full")
    b = random_block_sparse(6, 6, 2, 0.6, rng, "full")
    spgemm_device(a, b, device="cpu")
    spgemm_device(b, a, device="cpu")  # evicts a x b's entry
    ENGINE.reset()
    spgemm_device(a, b, device="cpu")
    assert ENGINE.counters["delta_full_fallbacks"] == 1
    st = delta.stats()
    assert st["evictions"] >= 1 and st["fallback_reasons"]["no_entry"] == 3


def test_the_plan_cache_off_bypasses_delta(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE", "0")
    rng = np.random.default_rng(215)
    a = random_block_sparse(6, 6, 2, 0.5, rng, "full")
    spgemm_device(a, a, device="cpu")
    assert delta.stats()["entries"] == 0


def test_a_lineage_gap_falls_back_in_full():
    rng = np.random.default_rng(216)
    a = random_block_sparse(6, 6, 2, 0.6, rng, "full")
    b = random_block_sparse(6, 6, 2, 0.6, rng, "full")
    c = random_block_sparse(6, 6, 2, 0.6, rng, "full")
    da = spgemm_device(a, b, device="cpu")
    spgemm_device(da, c, device="cpu")  # the consumer stores ("tag", key, v1)
    a2 = _edit(a, _rows_of(a)[:1])
    spgemm_device(a2, b, device="cpu")
    a3 = _edit(a2, _rows_of(a)[1:2])
    da3 = spgemm_device(a3, b, device="cpu")  # two versions the consumer never saw
    ENGINE.reset()
    got = spgemm_device(da3, c, device="cpu")
    assert ENGINE.counters["delta_full_fallbacks"] == 1
    assert delta.stats()["fallback_reasons"]["provenance_mismatch"] == 1
    want = spgemm_oracle(da3.to_host().to_dict(), c.to_dict(), 2)
    assert got.to_host() == BlockSparseMatrix.from_dict(a.rows, c.cols, 2, want)


def test_the_worker_stashes_digests_and_the_multiply_takes_them(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", "2")
    mats = _shifted_band(6, 16, 2, 1, 217)
    _quiet(chain_product, mats, device="cpu")  # first contact seeds the store
    stashed, hashed = [], []
    real_stash, real_digests = delta.stash_digests, delta.row_digests

    def stash(a, b):
        stashed.append(threading.current_thread().name)
        return real_stash(a, b)

    def digests(*args, **kw):
        hashed.append(threading.current_thread().name)
        return real_digests(*args, **kw)

    monkeypatch.setattr(delta, "stash_digests", stash)
    monkeypatch.setattr(delta, "row_digests", digests)
    ENGINE.reset()
    _quiet(chain_product, mats, device="cpu")  # unchanged
    assert ENGINE.counters["delta_rows_recomputed"] == 0
    assert stashed == ["chain-planner"] * 3  # the first pass's 3 pairs
    # both operands of each, and the multiplies took them: none hashed again
    assert hashed == ["chain-planner"] * 6
    assert all(set(vars(m)) == {"rows", "cols", "k", "coords", "tiles"} for m in mats)
    monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE", "0")  # no multiply takes the delta path
    stashed.clear()
    _quiet(chain_product, mats, device="cpu")
    assert stashed == []


# --------------------------------------------------------- knobs and CLI --
def test_pin_unless_exported(monkeypatch):
    monkeypatch.delenv("SPGEMM_TPU_DELTA", raising=False)
    restore = knobs.pin_unless_exported("SPGEMM_TPU_DELTA", "0")
    assert os.environ["SPGEMM_TPU_DELTA"] == "0" and knobs.get("SPGEMM_TPU_DELTA") is False
    restore()
    assert "SPGEMM_TPU_DELTA" not in os.environ and knobs.get("SPGEMM_TPU_DELTA") is True
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "1")
    knobs.pin_unless_exported("SPGEMM_TPU_DELTA", "0")()
    assert os.environ["SPGEMM_TPU_DELTA"] == "1"
    with pytest.raises(ValueError, match="SPGEMM_TPU_DELTA"):
        knobs.pin_unless_exported("SPGEMM_TPU_DELTA", "2")
    with pytest.raises(ValueError, match="flag"):
        knobs.pin_unless_exported("SPGEMM_TPU_NO_NATIVE", "1")


def test_the_cli_pins_delta_off_unless_exported(tmp_path, monkeypatch):
    out = str(tmp_path / "matrix")
    monkeypatch.delenv("SPGEMM_TPU_DELTA", raising=False)
    for _ in range(2):
        assert _quiet(cli.run, [GOLDEN, "--device", "cpu", "--output", out]) == 0
    assert delta.stats()["entries"] == 0 and "SPGEMM_TPU_DELTA" not in os.environ
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "1")
    assert _quiet(cli.run, [GOLDEN, "--device", "cpu", "--output", out]) == 0
    assert delta.stats()["entries"] > 0
    with open(out, "rb") as f, open(GOLDEN + "_expected_matrix", "rb") as g:
        assert f.read() == g.read()
