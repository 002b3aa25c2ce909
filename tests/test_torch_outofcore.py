"""The port's out-of-core multiply (ops/spgemm.spgemm_outofcore) on the CPU
against the JAX package's spgemm_outofcore (SPGEMM_TPU_DELTA=0), the port's
resident multiply and the python-int oracles: every backend, pipeline depths
1, 2 and 4, tiny rounds, an empty result, and sub-slabs that hold exactly
their referenced tiles plus the zero tile last.  Tolerance: exact."""

import logging
import re
import threading

import numpy as np
import pytest
import torch

from spgemm_tpu.ops.spgemm import spgemm_outofcore as jax_spgemm_outofcore
from spgemm_tpu.utils.gen import banded_block_sparse, random_block_sparse
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.ops.cuda_spgemm import numeric_round
from spgemm_tpu_torch.ops.spgemm import Folds, spgemm, spgemm_outofcore
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.semantics import field_spgemm_oracle, spgemm_oracle
from spgemm_tpu_torch.utils.timers import ENGINE


@pytest.fixture(autouse=True)
def _jax_delta_off(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")


def _port(m):
    return BlockSparseMatrix.from_reference(m)


def _same(m, w) -> bool:
    return (m.rows, m.cols, m.k) == (w.rows, w.cols, w.k) \
        and np.array_equal(m.coords, w.coords) and np.array_equal(m.tiles, w.tiles)


def _oracle(a, b, fn=spgemm_oracle):
    return BlockSparseMatrix.from_dict(a.rows, b.cols, a.k, fn(a.to_dict(), b.to_dict(), a.k))


def _ooc(a, b, **kw):
    return spgemm_outofcore(_port(a), _port(b), device="cpu", **kw)


@pytest.mark.parametrize("backend,jax_backend,dist", [
    ("exact", "xla", "full"), ("exact", "xla", "adversarial"),
    ("hybrid", "hybrid", "small"), ("hybrid", "hybrid", "full"),
    ("mxu", "mxu", "small")])
def test_outofcore_matches_jax_resident_and_oracle(backend, jax_backend, dist):
    rng = np.random.default_rng(101 + len(dist) + len(backend))
    a = random_block_sparse(8, 8, 4, 0.4, rng, dist)
    b = random_block_sparse(8, 8, 4, 0.4, rng, dist)
    got = _ooc(a, b, backend=backend)
    assert _same(got, jax_spgemm_outofcore(a, b, backend=jax_backend))
    assert got == spgemm(_port(a), _port(b), device="cpu", backend=backend)
    fn = field_spgemm_oracle if backend == "mxu" else spgemm_oracle
    assert got == _oracle(_port(a), _port(b), fn)


def test_outofcore_matches_resident_banded():
    """Banded structure with real tile re-use inside rounds."""
    rng = np.random.default_rng(7)
    a, b = (banded_block_sparse(24, 4, 3, rng, "full") for _ in range(2))
    got = _ooc(a, b)
    assert got == spgemm(_port(a), _port(b), device="cpu")
    assert _same(got, jax_spgemm_outofcore(a, b))


@pytest.mark.parametrize("round_size", [1, 3, 512])
@pytest.mark.parametrize("depth", ["1", "2", "4"])
def test_outofcore_depths_bit_identical(depth, round_size, monkeypatch):
    """SPGEMM_TPU_OOC_DEPTH changes no bit; tiny rounds push many rounds
    through the pipeline so the landing cadence differs between depths."""
    monkeypatch.setenv("SPGEMM_TPU_OOC_DEPTH", depth)
    rng = np.random.default_rng(13)
    a = random_block_sparse(8, 8, 4, 0.5, rng, "adversarial")
    b = random_block_sparse(8, 8, 4, 0.5, rng, "adversarial")
    ENGINE.reset()
    got = _ooc(a, b, round_size=round_size)
    assert got == _oracle(_port(a), _port(b))
    rounds = ENGINE.counters["ooc_rounds"]
    assert ENGINE.counts["stage_prep"] == ENGINE.counts["assembly"] == rounds
    assert ENGINE.counters["ooc_upload_bytes"] > 0
    if round_size == 1:
        assert rounds == got.nnzb  # one key a round


def test_outofcore_tiny_rounds_force_multi_round_pipeline():
    rng = np.random.default_rng(11)
    a = random_block_sparse(10, 10, 2, 0.5, rng, "adversarial")
    b = random_block_sparse(10, 10, 2, 0.5, rng, "adversarial")
    got = _ooc(a, b, round_size=2)
    assert got == _oracle(_port(a), _port(b))
    assert _same(got, jax_spgemm_outofcore(a, b, round_size=2))


def test_outofcore_empty_result():
    a = BlockSparseMatrix(rows=8, cols=8, k=2, coords=np.array([[0, 0]]),
                          tiles=np.ones((1, 2, 2), np.uint64))
    b = BlockSparseMatrix(rows=8, cols=6, k=2, coords=np.array([[1, 1]]),
                          tiles=np.ones((1, 2, 2), np.uint64))
    got = spgemm_outofcore(a, b, device="cpu")  # A's col 0 never meets B's row 1
    assert got.nnzb == 0 and (got.rows, got.cols, got.k) == (8, 6, 2)


@pytest.mark.parametrize("dist", ["small", "full"])
def test_outofcore_hybrid_dispatch(dist, caplog):
    """Small values prove every round onto the limb kernel, full-range ones
    none; both give the oracle's bytes and the log shows the split."""
    rng = np.random.default_rng(17 + len(dist))
    a = random_block_sparse(6, 6, 4, 0.5, rng, dist)
    b = random_block_sparse(6, 6, 4, 0.5, rng, dist)
    with caplog.at_level(logging.INFO, logger="spgemm_tpu_torch.spgemm"):
        got = _ooc(a, b, backend="hybrid")
    assert got == _oracle(_port(a), _port(b))
    m = re.search(r"hybrid mxu=(\d+)/(\d+)", caplog.text)
    mxu, total = int(m.group(1)), int(m.group(2))
    assert total > 0 and mxu == (total if dist == "small" else 0)


@pytest.mark.parametrize("depth", ["1", "2"])
def test_subslabs_hold_exactly_their_tiles_and_the_zero_tile_last(depth, monkeypatch):
    """Every slab a launch receives holds the round's referenced tiles once
    each, in slab order, and the zero tile last, which only sentinel slots
    name: no padding, so the kernels skip those slots."""
    monkeypatch.setenv("SPGEMM_TPU_OOC_DEPTH", depth)
    rng = np.random.default_rng(19)
    a = _port(banded_block_sparse(64, 2, 1, rng, "full"))
    b = _port(banded_block_sparse(64, 2, 1, rng, "full"))
    seen = []

    def spy(a_sub, b_sub, pa, pb, **kw):
        for slab, idx, op in ((a_sub, pa, a), (b_sub, pb, b)):
            last = slab.shape[0] - 1
            assert not slab[last].any()  # the zero tile last
            real = torch.unique(idx[idx != last])
            assert torch.equal(real, torch.arange(last, dtype=real.dtype))  # each row named
            rows = slab[:last].numpy().view(np.uint64)
            where = np.searchsorted(op.tiles[:, 0, 0], rows[:, 0, 0])  # unique first elements
            assert np.array_equal(op.tiles[where], rows)  # operand tiles, in slab order
            assert np.all(np.diff(where) > 0)
        seen.append((a_sub.shape[0], b_sub.shape[0]))
        return numeric_round(a_sub, b_sub, pa, pb, **kw)

    # each operand's tiles sorted by their first element (distinct in uniform
    # uint64 values), so a slab row's place in its operand is a searchsorted
    for m in (a, b):
        m.tiles = m.tiles[np.argsort(m.tiles[:, 0, 0])]
        assert len(np.unique(m.tiles[:, 0, 0])) == m.nnzb
    got = spgemm_outofcore(a, b, device="cpu", round_size=16, folds=Folds(exact=spy))
    assert got == _oracle(a, b)
    assert len(seen) > 1 and max(s[0] for s in seen) < a.nnzb and max(s[1] for s in seen) < b.nnzb


def test_chain_of_outofcore_multiplies_matches_resident(capsys):
    mats = [_port(banded_block_sparse(12, 2, 1, np.random.default_rng(40 + i), "adversarial"))
            for i in range(5)]
    want = chain_product(mats, device="cpu")
    got = chain_product(mats, device="cpu", multiply=spgemm_outofcore)
    assert isinstance(got, BlockSparseMatrix) and got == want
    assert chain_product(mats, device="cpu", multiply=spgemm_outofcore, keep_device=True) == want
    assert chain_product(mats, device="cpu", multiply=spgemm) == want


def test_a_failed_launch_raises_and_stops_both_threads():
    rng = np.random.default_rng(23)
    a = random_block_sparse(8, 8, 2, 0.5, rng, "full")
    b = random_block_sparse(8, 8, 2, 0.5, rng, "full")
    calls = []

    def fold(*args, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("launch failed")
        return numeric_round(*args, **kw)

    with pytest.raises(RuntimeError, match="launch failed"):
        _ooc(a, b, round_size=2, folds=Folds(exact=fold))
    assert not [t for t in threading.enumerate() if t.name.startswith("ooc-")]


def test_a_failed_stage_raises(monkeypatch):
    rng = np.random.default_rng(24)
    a = random_block_sparse(8, 8, 2, 0.5, rng, "full")
    b = random_block_sparse(8, 8, 2, 0.5, rng, "full")
    real = np.searchsorted
    calls = []

    def searchsorted(*args, **kw):
        calls.append(1)
        if threading.current_thread().name.startswith("ooc-staging") and len(calls) > 4:
            raise MemoryError("staging failed")
        return real(*args, **kw)

    monkeypatch.setattr(engine.np, "searchsorted", searchsorted)
    with pytest.raises(MemoryError, match="staging failed"):
        _ooc(a, b, round_size=2)
    assert not [t for t in threading.enumerate() if t.name.startswith("ooc-")]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipeline_bounds_rounds_in_flight(depth):
    """engine._pipeline on stand-in stages: launches in round order, at most
    `depth` rounds staged and not launched, at most `depth` launched and not
    landed; depth 1 runs stage, launch and land in turn."""
    lock, log, state = threading.Lock(), [], {"staged": 0, "launched": 0, "landed": 0}

    def note(event, rnd):
        with lock:
            state[event] += 1
            log.append((event, rnd))
            assert state["staged"] - state["launched"] <= depth
            assert state["launched"] - state["landed"] <= depth

    def stage(rnd):
        note("staged", rnd)
        return rnd

    def launch(rnd, staged):
        assert staged == rnd
        note("launched", rnd)
        return (rnd,)

    def land(rnd):
        note("landed", rnd)

    engine._pipeline(list(range(9)), stage, launch, land, depth)
    assert [r for e, r in log if e == "launched"] == list(range(9))
    assert sorted(r for e, r in log if e == "landed") == list(range(9))
    if depth == 1:
        assert log == [(e, r) for r in range(9) for e in ("staged", "launched", "landed")]
