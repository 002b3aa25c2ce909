"""The sampled structure estimator in the port (spgemm_tpu_torch/ops/
estimate.py) and the deferred plans it routes (ops/spgemm.plan,
SpgemmPlan.ensure_exact): estimates equal the JAX package's field by field,
and plans and bytes are the same with the estimator on and off.  Inputs from
numpy seeds at small sizes.  Tolerance: exact (the estimates' floats are the
same numpy arithmetic in both packages)."""

import contextlib
import io
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from spgemm_tpu.ops import estimate as jax_estimate
from spgemm_tpu.utils import knobs as jax_knobs
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops import delta, estimate, plancache
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.ops.spgemm import plan
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import banded_block_sparse, random_block_sparse
from spgemm_tpu_torch.utils.timers import ENGINE


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    plancache.clear()
    delta.clear()
    estimate.clear()
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "1")  # the port's default is off
    yield
    plancache.clear()
    delta.clear()


def _coords_only(rows, cols, k, coords):
    return SimpleNamespace(rows=rows, cols=cols, k=k, coords=coords, nnzb=len(coords))


def _band(block_dim, bandwidth, shift=0):
    r = np.arange(block_dim)[:, None]
    c = np.arange(block_dim)[None, :]
    coords = np.argwhere(np.abs(r - c + shift) <= bandwidth).astype(np.int64)
    return coords


def _structures():
    rng = np.random.default_rng(300)
    skew_rows = np.repeat(np.arange(80), np.where(np.arange(80) % 9 == 0, 40, 1))
    skew = np.unique(np.stack([skew_rows, rng.integers(0, 60, len(skew_rows))], 1), axis=0)
    return {
        "band": (_band(120, 3), _band(120, 2, 1)),
        "random": (random_block_sparse(90, 70, 1, 0.1, rng).coords,
                   random_block_sparse(70, 60, 1, 0.1, rng).coords),
        "skewed": (skew, random_block_sparse(60, 50, 1, 0.2, rng).coords),
        "small": (_band(30, 2), _band(30, 2)),
        "empty_b": (_band(60, 1), np.zeros((0, 2), np.int64)),
        "disjoint": (_band(60, 0), np.array([[100, 3]], np.int64)),
    }


@pytest.mark.parametrize("name", list(_structures()))
@pytest.mark.parametrize("sample_rows", [None, 7, 200])
def test_maybe_estimate_equals_the_jax_package(name, sample_rows):
    a, b = _structures()[name]
    ours = estimate.maybe_estimate(a, b, sample_rows=sample_rows)
    theirs = jax_estimate.maybe_estimate(a, b, sample_rows=sample_rows)
    assert (ours is None) == (theirs is None)
    if ours is None:
        return
    for field in ("total_rows", "sampled_rows", "scale", "est_keys", "est_pairs",
                  "est_max_fanout", "class_hist", "skew", "confidence"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert np.array_equal(ours.row_mass, theirs.row_mass)
    assert estimate.predicted_route(ours) == jax_estimate.predicted_route(theirs)
    assert estimate.pair_mass(a, b) == jax_estimate.pair_mass(a, b)


def test_chain_mass_equals_the_jax_package():
    coords = [c for pair in _structures().values() for c in pair][:6]
    assert estimate.chain_mass(coords) == jax_estimate.chain_mass(coords)


def _arrays(p):
    yield from (p.join.keys, p.join.pair_ptr, p.join.pair_a, p.join.pair_b, p.take)
    for r in p.rounds:
        yield from (r.key_index, r.pa, r.pb, np.array([r.max_fanout]))


@pytest.mark.parametrize("backend", ["exact", "hybrid", "mxu"])
@pytest.mark.parametrize("round_size", [None, 40])
def test_plans_are_the_same_with_the_estimator_on_and_off(backend, round_size, monkeypatch):
    rng = np.random.default_rng(301)
    a = banded_block_sparse(100, 2, 3, rng, "small")
    b = banded_block_sparse(100, 2, 2, rng, "small")
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "0")
    off = plan(a, b, backend=backend, round_size=round_size)
    assert not off.is_deferred and off.plan_route == "exact"
    plancache.clear()
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "1")
    ENGINE.reset()
    on = plan(a, b, backend=backend, round_size=round_size)
    assert on.is_deferred and on.plan_route == "estimated" and on.join is None
    assert ENGINE.counters["est_hits"] == 1 and estimate.stats()["hits"] == 1
    on.ensure_exact()
    assert not on.is_deferred and "plan_exact" in ENGINE.snapshot()
    assert all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(_arrays(on), _arrays(off), strict=True))
    assert plan(a, b, backend=backend, round_size=round_size) is on  # the cached, promoted plan


def test_a_low_confidence_estimate_joins_inline(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_EST_CONFIDENCE", "2")  # above 1: never confident
    rng = np.random.default_rng(302)
    a = banded_block_sparse(80, 2, 2, rng)
    ENGINE.reset()
    p = plan(a, a)
    assert not p.is_deferred and p.plan_route == "exact" and p.estimate is not None
    assert ENGINE.counters["est_fallbacks"] == 1 and "join_fallback" in ENGINE.snapshot()


def test_a_small_structure_is_not_estimated():
    a = banded_block_sparse(20, 2, 1, np.random.default_rng(303))
    ENGINE.reset()
    p = plan(a, a)
    assert p.estimate is None and not p.is_deferred
    assert "est_hits" not in ENGINE.counters and "est_fallbacks" not in ENGINE.counters


def test_ensure_exact_builds_once_across_threads_and_freezes(monkeypatch):
    calls = []
    real = engine.symbolic_join
    monkeypatch.setattr(engine, "symbolic_join",
                        lambda *a: calls.append(threading.current_thread().name) or real(*a))
    a = banded_block_sparse(90, 2, 2, np.random.default_rng(304))
    p = plan(a, a)
    assert p.is_deferred and calls == []
    threads = [threading.Thread(target=p.ensure_exact) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1
    late = [p.join.keys, p.join.pair_a, p.join.pair_b, p.take]
    late += [x for r in p.rounds for x in (r.key_index, r.pa, r.pb)]
    assert not any(x.flags.writeable for x in late)  # added late, read-only all the same
    assert a.coords.flags.writeable  # the caller's own coords are not


def test_a_dense_class_prediction_is_counted_as_a_route_mismatch(monkeypatch):
    """Under the ladder route a sample whose fanout class reaches the dense
    floor counts est_route_mismatch (the JAX rule; the other cases are in
    tests/test_torch_dense.py)."""
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", "ladder")
    rows = np.repeat(np.arange(60), 300)
    a = _coords_only(60, 300, 1, np.stack([rows, np.tile(np.arange(300), 60)], 1))
    b = _coords_only(300, 1, 1, np.stack([np.arange(300), np.zeros(300, np.int64)], 1))
    ENGINE.reset()
    p = plan(a, b)
    assert estimate.predicted_route(p.estimate) == "dense"
    p.ensure_exact()
    assert ENGINE.counters["est_route_mismatch"] == 1
    ENGINE.reset()
    plancache.clear()
    plan(a, b, backend="mxu").ensure_exact()  # mxu predicts no route
    assert "est_route_mismatch" not in ENGINE.counters


@pytest.mark.parametrize("ahead", ["0", "2"])
def test_chain_bytes_are_the_same_with_the_estimator_on_and_off(ahead, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", ahead)
    rng = np.random.default_rng(305)
    mats = []
    for i in range(5):
        m = banded_block_sparse(70, 2, 2, rng, "adversarial")
        keep = m.coords[:, 1] + i < 70
        mats.append(BlockSparseMatrix(rows=m.rows, cols=m.cols, k=2,
                                      coords=m.coords[keep] + np.array([0, i]),
                                      tiles=m.tiles[keep]))
    results = {}
    for on in ("0", "1"):
        monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", on)
        plancache.clear()
        delta.clear()
        ENGINE.reset()
        with contextlib.redirect_stdout(io.StringIO()):
            results[on] = chain_product(mats, device="cpu")
        if on == "1":
            assert ENGINE.counters["est_hits"] == 4
            assert not any(p.is_deferred for _, p in plancache.entries())
    assert results["0"] == results["1"]


def test_the_port_defaults_the_estimator_off(monkeypatch):
    """A deliberate difference: the JAX package defaults it on."""
    monkeypatch.delenv("SPGEMM_TPU_PLAN_ESTIMATE", raising=False)
    assert estimate.enabled() is False and jax_knobs.get("SPGEMM_TPU_PLAN_ESTIMATE") is True
    ENGINE.reset()
    p = plan(banded_block_sparse(100, 2, 3, np.random.default_rng(308), "small"),
             banded_block_sparse(100, 2, 2, np.random.default_rng(309), "small"))
    assert not p.is_deferred and p.plan_route == "exact" and p.estimate is None
    assert "est_hits" not in ENGINE.counters and estimate.stats()["hits"] == 0


def test_estimator_stats_and_clear(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_EST_SAMPLE_ROWS", "10")
    st = estimate.stats()
    assert st["sample_rows"] == 10 and st["enabled"] is True
    assert st["confidence_threshold"] == 0.5 and st["hits"] == 0
    plan(banded_block_sparse(30, 2, 1, np.random.default_rng(306)),
         banded_block_sparse(30, 2, 1, np.random.default_rng(307)))
    assert estimate.stats()["hits"] == 1
    estimate.clear()
    assert estimate.stats()["hits"] == 0
