"""The dense accumulator route in the port (SPGEMM_TPU_ACCUM_ROUTE: the
segmented fold ops/cuda_dense.py, the dense rounds of ops/symbolic.py, the
gate of ops/crossover.py and the dispatch of ops/spgemm.py) against the
JAX package: the plain fold against numeric_round_dense_impl, the planner's
rounds and twins against plan_rounds(..., batch=True, route=...), spgemm and
the proof gate's dispatch counts under every route against the JAX spgemm,
and all against the numpy oracle.  The JAX legs run with SPGEMM_TPU_DELTA=0
and a cleared plan cache per route (its route is jit-static, not in its
cache key).  Inputs from numpy seeds at small sizes.  Tolerance: zero
differing bits.

On the CPU the wrapper runs the plain version; the kernel itself is checked
on the card by chip_smoke.py and tests/test_torch_cuda.py."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgemm_tpu.obs import events as jax_events
from spgemm_tpu.ops import plancache as jax_plancache
from spgemm_tpu.ops import symbolic as jax_sym
from spgemm_tpu.ops import u64 as jax_u64
from spgemm_tpu.ops.spgemm import numeric_round_dense_impl
from spgemm_tpu.ops.spgemm import plan as jax_plan
from spgemm_tpu.ops.spgemm import spgemm as jax_spgemm
from spgemm_tpu.utils import gen as jax_gen
from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxMatrix
from spgemm_tpu.utils.semantics import spgemm_oracle
from spgemm_tpu.utils.timers import ENGINE as JAX_ENGINE
from spgemm_tpu_torch.ops import crossover, cuda_dense, delta, estimate, plancache
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.ops import symbolic as sym
from spgemm_tpu_torch.ops import u64, warmstore
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.ops.mxu_spgemm import safe_exact_bound
from spgemm_tpu_torch.ops.spgemm import plan, spgemm, spgemm_device, spgemm_outofcore, subplan
from spgemm_tpu_torch.utils import gen
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.timers import ENGINE

ROUTES = ("ladder", "dense", "auto")
MAX = (1 << 64) - 1
EDGE = np.array([0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
                 (1 << 63) - 1, 1 << 63, MAX - 2, MAX - 1, MAX], dtype=np.uint64)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    plancache.clear()
    jax_plancache.clear()
    delta.clear()
    yield
    plancache.clear()
    jax_plancache.clear()


# ---------------------------------------------- structures (tests/test_spgemm.py) --
def _hub_pair(k=4, keys=2, fanout=300, seed=170, dist="full"):
    """`keys` hub output rows of the given fanout.  Fanout 300 lands in
    class 384, a padded-MAC ratio of 1.28, past DENSE_RATIO_GATE."""
    rng = np.random.default_rng(seed)
    a_coords = np.array([(i, i * fanout + j) for i in range(keys) for j in range(fanout)],
                        np.int64)
    b_coords = np.array([(m, 0) for m in range(keys * fanout)], np.int64)
    a = JaxMatrix(rows=keys, cols=keys * fanout, k=k, coords=a_coords,
                  tiles=jax_gen.random_values((len(a_coords), k, k), rng, dist))
    b = JaxMatrix(rows=keys * fanout, cols=1, k=k, coords=b_coords,
                  tiles=jax_gen.random_values((len(b_coords), k, k), rng, dist))
    return a, b


def _skew_pair(k=2, seed=7):
    rng = np.random.default_rng(seed)
    return (jax_gen.powerlaw_block_sparse(32, k, 3.0, rng, "adversarial"),
            jax_gen.powerlaw_block_sparse(32, k, 3.0, rng, "adversarial"))


def _shallow_pair(k=4, seed=3):
    """Every fanout class below DENSE_MIN_CLASS: auto attaches no twin."""
    rng = np.random.default_rng(seed)
    return (jax_gen.random_block_sparse(6, 6, k, 0.4, rng, "adversarial"),
            jax_gen.random_block_sparse(6, 6, k, 0.4, rng, "adversarial"))


def _empty_pair(k=4, seed=9):
    """Structurally empty product (A's cols never meet B's rows)."""
    rng = np.random.default_rng(seed)
    a = JaxMatrix(rows=2, cols=4, k=k, coords=np.array([(0, 0), (1, 1)], np.int64),
                  tiles=rng.integers(0, 1 << 64, size=(2, k, k), dtype=np.uint64))
    b = JaxMatrix(rows=4, cols=2, k=k, coords=np.array([(2, 0), (3, 1)], np.int64),
                  tiles=rng.integers(0, 1 << 64, size=(2, k, k), dtype=np.uint64))
    return a, b


PAIRS = {"hub": _hub_pair, "skew": _skew_pair, "shallow": _shallow_pair, "empty": _empty_pair}


def _planner_structures():
    """Coordinate pairs of tests/test_torch_planner.py's kinds, and the
    hub pairs, whose deep classes make dense rounds and twins."""
    rng = np.random.default_rng(11)
    out = {
        "random": (jax_gen.random_block_sparse(12, 12, 2, 0.3, rng),
                   jax_gen.random_block_sparse(12, 12, 2, 0.3, rng)),
        "banded": (jax_gen.banded_block_sparse(40, 2, 3, rng),
                   jax_gen.banded_block_sparse(40, 2, 2, rng)),
        "hub3x300": _hub_pair(keys=3),
        "hub_wide": _hub_pair(keys=5, fanout=260),
    }
    for name, make in PAIRS.items():
        out[name] = make()
    hub = np.concatenate([np.stack([np.zeros(64, np.int64), np.arange(64)], 1),
                          np.array([[5, 3], [9, 60]])])
    b_c = np.stack([np.arange(64), np.arange(64) % 7], 1)
    out["hub64"] = (hub[np.lexsort((hub[:, 1], hub[:, 0]))], b_c)
    return {name: tuple(getattr(m, "coords", m) for m in pair) for name, pair in out.items()}


STRUCTURES = _planner_structures()


def _port(m):
    return BlockSparseMatrix.from_reference(m)


def _oracle(a, b):
    return BlockSparseMatrix.from_dict(a.rows, b.cols, a.k,
                                       spgemm_oracle(a.to_dict(), b.to_dict(), a.k))


def _same(port_m, jax_m) -> bool:
    return (port_m.rows, port_m.cols, port_m.k) == (jax_m.rows, jax_m.cols, jax_m.k) \
        and np.array_equal(port_m.coords, jax_m.coords) \
        and port_m.tiles.tobytes() == jax_m.tiles.tobytes()


# ----------------------------------------------------------- the plain fold --
def _slab(rng, n_tiles: int, k: int) -> np.ndarray:
    """(n_tiles + 1, k, k) uint64, half EDGE values, sentinel zero tile last."""
    edge = EDGE[rng.integers(0, len(EDGE), size=(n_tiles + 1, k, k))]
    full = rng.integers(0, 1 << 64, size=(n_tiles + 1, k, k), dtype=np.uint64)
    tiles = np.where(rng.random((n_tiles + 1, k, k)) < 0.5, edge, full)
    tiles[-1] = 0
    return tiles


def _stream(rng, n_rows: int, L: int, real: int, n_tiles: int, layout: str):
    """(pa, pb, seg) of length L: `real` slots on rows (contiguous runs in
    row order, or cycling over the rows), a share of them sentinel pairs,
    the rest pad slots on the scratch row n_rows."""
    pa = np.full(L, n_tiles, np.int32)
    pb = np.full(L, n_tiles, np.int32)
    seg = np.full(L, n_rows, np.int32)
    pa[:real] = rng.integers(0, n_tiles, size=real)
    pb[:real] = rng.integers(0, n_tiles, size=real)
    side = rng.integers(0, 5, size=real)  # 0: a's sentinel, 1: b's, else a real pair
    pa[:real][side == 0] = n_tiles
    pb[:real][side == 1] = n_tiles
    if n_rows:
        seg[:real] = (np.sort(rng.integers(0, n_rows, size=real)) if layout == "contiguous"
                      else np.arange(real) % n_rows)
    return pa, pb, seg


def _jax_dense(a, b, pa, pb, seg, n_rows):
    k = a.shape[-1]
    zeros = jnp.zeros((n_rows + 1, k, k), jnp.uint32)
    args = [*jax_u64.u64_to_hilo(a), *jax_u64.u64_to_hilo(b)]
    oh, ol = numeric_round_dense_impl(*map(jnp.asarray, args), jnp.asarray(pa),
                                      jnp.asarray(pb), jnp.asarray(seg), zeros, zeros)
    return jax_u64.hilo_to_u64(np.asarray(oh), np.asarray(ol))


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", ["contiguous", "cycling"])
@pytest.mark.parametrize("n_rows,L,real", [(6, 24, 19), (3, 8, 0), (0, 8, 0), (5, 16, 16)],
                         ids=["mixed", "all_pad", "no_rows", "no_pad"])
def test_plain_fold_matches_jax_dense_impl(k, layout, n_rows, L, real):
    rng = np.random.default_rng(1000 * k + L + real)
    a, b = _slab(rng, 9, k), _slab(rng, 9, k)
    pa, pb, seg = _stream(rng, n_rows, L, real, 9, layout)
    want = _jax_dense(a, b, pa, pb, seg, n_rows)
    args = (u64.u64_to_t(a), u64.u64_to_t(b), *map(torch.from_numpy, (pa, pb, seg)), n_rows)
    got = cuda_dense.numeric_round_dense_ref(*args)
    assert got.shape == (n_rows, k, k)
    assert np.array_equal(u64.t_to_u64(got), want)
    launches = ENGINE.counter_snapshot().get("launches_dense_fold", 0)
    assert np.array_equal(u64.t_to_u64(cuda_dense.numeric_round_dense(*args)), want)
    # CPU tensors: the plain version, no launch
    assert ENGINE.counter_snapshot().get("launches_dense_fold", 0) == launches
    if layout == "contiguous":  # the planner's layout with its row offsets
        row_ptr = torch.from_numpy(np.searchsorted(seg[:real], np.arange(n_rows + 1)))
        assert np.array_equal(u64.t_to_u64(cuda_dense.numeric_round_dense_ref(
            *args, row_ptr=row_ptr)), want)


def test_plain_fold_refuses_what_the_kernel_does_not_take():
    a = torch.zeros((3, 2, 2), dtype=torch.int64)
    ix = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        cuda_dense.numeric_round_dense(a, a, ix.long(), ix, ix, 2)
    with pytest.raises(ValueError, match="one \\(L,\\) shape"):
        cuda_dense.numeric_round_dense(a, a, ix, ix[:4], ix, 2)
    with pytest.raises(ValueError, match="row_ptr"):
        cuda_dense.numeric_round_dense(a, a, ix, ix, ix, 2,
                                       row_ptr=torch.zeros(2, dtype=torch.int64))


# ------------------------------------------------------------- the planner --
def _round_equal(g, w) -> None:
    assert g.route == w.route
    assert np.array_equal(g.key_index, w.key_index)
    assert np.array_equal(g.pa, w.pa) and g.pa.dtype == np.int32
    assert np.array_equal(g.pb, w.pb)
    assert (g.max_fanout, g.real_pairs, g.out_rows) == (w.max_fanout, w.real_pairs, w.out_rows)
    if w.route == "dense":
        assert g.n_rows == w.n_rows and np.array_equal(g.seg, w.seg)
        real = g.real_pairs
        assert np.array_equal(g.row_ptr, np.searchsorted(g.seg[:real], np.arange(g.n_rows + 1)))
        assert g.row_ptr[-1] == real
    assert (g.dense_alt is None) == (w.dense_alt is None)
    if w.dense_alt is not None:
        _round_equal(g.dense_alt, w.dense_alt)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("cap", [None, 3])
@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_plan_rounds_match_jax_on_every_route(name, cap, route):
    a, b = STRUCTURES[name]
    join = sym.symbolic_join(a, b)
    got = sym.plan_rounds(join, len(a), len(b), key_cap=8192 if cap is None else cap,
                          route=route)
    want = jax_sym.plan_rounds(jax_sym.symbolic_join(a, b), a_sentinel=len(a),
                               b_sentinel=len(b), round_size=cap, batch=True, route=route)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _round_equal(g, w)
    assert np.array_equal(sym.assembly_permutation(got, join.num_keys),
                          jax_sym.assembly_permutation(want, join.num_keys))
    if name in ("hub", "hub3x300", "hub_wide") and route != "ladder":  # classes >= 256
        assert any(r.route == "dense" or r.dense_alt is not None for r in got)


def test_plan_rounds_reads_the_knob_and_refuses_an_unknown_route(monkeypatch):
    a, b = STRUCTURES["hub3x300"]
    join = sym.symbolic_join(a, b)
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", "dense")
    assert all(r.route == "dense" for r in sym.plan_rounds(join, len(a), len(b)))
    with pytest.raises(ValueError, match="accumulator route"):
        sym.plan_rounds(join, len(a), len(b), route="stream")
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", "stream")
    with pytest.raises(ValueError, match="SPGEMM_TPU_ACCUM_ROUTE"):
        sym.plan_rounds(join, len(a), len(b))


def test_stream_pad_matches_jax():
    for n in list(range(0, 300)) + [1000, 4097, 65537]:
        assert sym._stream_pad(n) == jax_sym._stream_pad(n)
    assert sym.DENSE_MIN_CLASS == jax_sym.DENSE_MIN_CLASS


# ------------------------------------------------------ multiplies and gates --
@pytest.mark.parametrize("backend", ["exact", "hybrid"])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_spgemm_matches_jax_and_the_oracle_on_every_route(name, route, backend, monkeypatch):
    a, b = PAIRS[name]()
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", route)
    ENGINE.reset()
    JAX_ENGINE.reset()
    got = spgemm(_port(a), _port(b), device="cpu", backend=backend)
    want = jax_spgemm(a, b, backend="xla" if backend == "exact" else "hybrid")
    assert _same(got, want)
    assert got == _oracle(_port(a), _port(b))
    # the proof gate's dispatch: the same rounds go dense in both packages
    assert ENGINE.counters.get("route_dense", 0) == \
        JAX_ENGINE.counter_snapshot().get("route_dense", 0)
    if name == "hub" and route != "ladder":
        assert ENGINE.counters["route_dense"] >= 1


@pytest.mark.parametrize("fanout,dense", [(300, True), (256, False), (230, False), (200, True)])
def test_proof_gate_follows_the_padded_ratio_as_jax(fanout, dense, monkeypatch):
    """Three hub keys: class 384 at fanout 300 and class 256 at fanout 200
    ship 1.28 slots per real pair (dense); class 256 at fanout 256 and 230
    ship 1.0 and 1.11 (ladder).  Both packages dispatch the same rounds
    dense."""
    a, b = _hub_pair(fanout=fanout, keys=3)
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", "auto")
    p = plan(_port(a), _port(b))
    twins = [r for r in p.rounds if r.dense_alt is not None]
    assert twins
    decided = [r.padded_mac_ratio() >= crossover.DENSE_RATIO_GATE for r in twins]
    ENGINE.reset()
    JAX_ENGINE.reset()
    rounds_before = dict(engine.rounds_by_kernel)
    got = spgemm(_port(a), _port(b), device="cpu")
    want = jax_spgemm(a, b, backend="xla")
    assert _same(got, want)
    n_dense = ENGINE.counters.get("route_dense", 0)
    assert n_dense == JAX_ENGINE.counter_snapshot().get("route_dense", 0) == sum(decided)
    assert (n_dense > 0) == dense
    assert engine.rounds_by_kernel["dense"] - rounds_before["dense"] == n_dense


def test_auto_gate_times_once_per_key_and_routes_to_the_winner(monkeypatch, tmp_path):
    monkeypatch.setenv("SPGEMM_TPU_HYBRID_GATE", "auto")
    monkeypatch.setenv("SPGEMM_TPU_CROSSOVER_CACHE", str(tmp_path))
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", "auto")
    timed = []

    def fake_time(fn, args, device, repeats=2):
        leg = "dense" if len(args) == 7 else "ladder"
        if leg == "dense":  # the timing stream: contiguous rows, offsets given
            seg, n_rows, row_ptr = args[4:]
            assert torch.equal(seg[:int(row_ptr[-1])], torch.sort(seg[:int(row_ptr[-1])]).values)
            assert int(row_ptr[-1]) == int((seg < n_rows).sum())
        timed.append(leg)
        return 1.0 if leg == "dense" else 2.0

    monkeypatch.setattr(crossover, "_time_call", fake_time)
    a, b = _hub_pair()
    ENGINE.reset()
    got = spgemm(_port(a), _port(b), device="cpu")
    assert got == _oracle(_port(a), _port(b))
    assert timed == ["ladder", "dense"] and ENGINE.counters["route_dense"] == 1
    entries = crossover.entries()
    assert list(entries) == ["dense-v1:cpu:mod:k4:K2:P384"]
    spgemm(_port(a), _port(b), device="cpu")  # a cache hit: nothing timed again
    assert len(timed) == 2
    json_entries = json.loads((tmp_path / crossover.CACHE_FILE).read_text())
    assert json_entries == {"dense-v1:cpu:mod:k4:K2:P384": {"ladder_s": 2.0, "dense_s": 1.0}}


def test_dense_gate_reads_a_persisted_ranking_and_the_proof_ratio(monkeypatch, tmp_path):
    """The JAX package's test_dense_gate_cache_hit_skips_measurement."""
    monkeypatch.setenv("SPGEMM_TPU_CROSSOVER_CACHE", str(tmp_path))
    key = "dense-v1:cpu:mod:k4:K256:P384"
    shape = dict(key=key, k=4, K=256, P=384, real_pairs=2048, device="cpu")

    def _boom(*_a, **_k):
        raise AssertionError("kernel measurement ran on a cache hit")

    for ladder_s, dense_s, wins in ((1.0, 0.1, True), (0.1, 1.0, False)):
        (tmp_path / crossover.CACHE_FILE).write_text(
            json.dumps({key: {"ladder_s": ladder_s, "dense_s": dense_s}}))
        crossover._CACHE.clear()
        assert crossover.dense_wins(_boom, _boom, policy="auto", padded_ratio=1.0,
                                    **shape) is wins
    assert crossover.dense_wins(_boom, _boom, policy="proof", padded_ratio=1.28, **shape)
    assert not crossover.dense_wins(_boom, _boom, policy="proof", padded_ratio=1.1, **shape)


def test_mxu_plans_ladder_and_outofcore_stays_ladder(monkeypatch):
    a, b = _hub_pair()
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", "dense")
    assert plan(_port(a), _port(b), backend="mxu").route == "ladder"
    for backend, route in (("mxu", "dense"), ("exact", "stream")):
        with pytest.raises(ValueError, match="accumulator route"):
            plan(_port(a), _port(b), backend=backend, route=route)
    ENGINE.reset()
    got = spgemm_outofcore(_port(a), _port(b), device="cpu", round_size=1)
    assert "route_dense" not in ENGINE.counters
    assert got == _oracle(_port(a), _port(b))


def test_plan_cache_key_separates_routes(monkeypatch):
    a, b = _port(_hub_pair()[0]), _port(_hub_pair()[1])
    plans = {}
    for route in ROUTES:
        monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", route)
        ENGINE.reset()
        plans[route] = plan(a, b)
        assert ENGINE.counters["plan_cache_misses"] == 1, route  # never another route's plan
        assert plans[route].route == route
    assert plans["dense"].rounds[0].route == "dense"
    assert plans["ladder"].rounds[0].dense_alt is None
    assert plans["auto"].rounds[0].dense_alt is not None
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", "dense")
    ENGINE.reset()
    assert plan(a, b) is plans["dense"] and ENGINE.counters["plan_cache_hits"] == 1


@pytest.mark.parametrize("route", ["dense", "auto"])
def test_subplan_keeps_the_route(route, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", route)
    a, b = _hub_pair(keys=3)
    parent = plan(_port(a), _port(b))
    keep = np.zeros(parent.join.num_keys, bool)
    keep[[0, 2]] = True
    sub, kept = subplan(parent, keep)
    assert sub.route == route and list(kept) == [0, 2]
    if route == "dense":
        assert all(r.route == "dense" for r in sub.rounds)
    else:
        assert all(r.dense_alt is not None for r in sub.rounds)
    da, db = (DeviceBlockMatrix.from_host(_port(m), "cpu") for m in (a, b))
    got = engine.execute(sub, da, db)
    full = engine.execute(parent, da, db)
    assert torch.equal(got.slab[:-1], full.slab[torch.from_numpy(kept)])


def test_hybrid_forced_dense_keeps_the_proof_and_val_bound(monkeypatch):
    """A forced-dense round still counts as proven under hybrid, so the
    result's val_bound is the proven bound and the next multiply keeps its
    proof."""
    a, b = (DeviceBlockMatrix.from_host(_port(m), "cpu")
            for m in _hub_pair(dist="small", keys=3))
    bounds = {}
    for route in ("ladder", "dense"):
        monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", route)
        ENGINE.reset()
        res = spgemm_device(a, b, device="cpu", backend="hybrid")
        bounds[route] = (res.val_bound, res.to_host())
        assert (ENGINE.counters.get("route_dense", 0) > 0) == (route == "dense")
    want = safe_exact_bound(a.bound(), b.bound(), 300, 4)
    assert want is not None and bounds["dense"][0] == bounds["ladder"][0] == want
    assert bounds["dense"][1] == bounds["ladder"][1]


# ------------------------------------------------------------ the estimator --
def _hub_row_missed(k=2, seed=91):
    """64 A tile-rows, row 5 a 300-wide hub, the rest fanout 4: a 4-row
    evenly spaced sample never lands on the hub (the JAX package's
    test_estimator_route_misprediction_is_telemetry_only)."""
    rng = np.random.default_rng(seed)
    coords, base = [], 0
    for r in range(64):
        f = 300 if r == 5 else 4
        coords += [(r, base + j) for j in range(f)]
        base += f
    a_c = np.array(coords, np.int64)
    b_c = np.array([(m, 0) for m in range(base)], np.int64)
    a = JaxMatrix(rows=64, cols=base, k=k, coords=a_c,
                  tiles=rng.integers(0, 1 << 64, size=(len(a_c), k, k), dtype=np.uint64))
    b = JaxMatrix(rows=base, cols=1, k=k, coords=b_c,
                  tiles=rng.integers(0, 1 << 64, size=(len(b_c), k, k), dtype=np.uint64))
    return a, b


def _all_hubs(k=1):
    """Every A row a 300-wide hub: the sample predicts dense."""
    rows = np.repeat(np.arange(60), 300)
    a_c = np.stack([rows, np.tile(np.arange(300), 60)], 1)
    b_c = np.stack([np.arange(300), np.zeros(300, np.int64)], 1)
    rng = np.random.default_rng(5)
    return (JaxMatrix(rows=60, cols=300, k=k, coords=a_c,
                      tiles=rng.integers(0, 1 << 64, size=(len(a_c), k, k), dtype=np.uint64)),
            JaxMatrix(rows=300, cols=1, k=k, coords=b_c,
                      tiles=rng.integers(0, 1 << 64, size=(len(b_c), k, k), dtype=np.uint64)))


@pytest.mark.parametrize("make,route,mismatch", [
    (_hub_row_missed, "auto", True),    # predicted ladder, real dense
    (_all_hubs, "auto", False),         # predicted dense, real dense
    (_all_hubs, "ladder", True),        # predicted dense, real ladder
    (_hub_row_missed, "ladder", False),  # predicted ladder, real ladder
])
def test_route_mismatch_follows_the_jax_rule(make, route, mismatch, monkeypatch):
    estimate.clear()
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", route)
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "1")
    monkeypatch.setenv("SPGEMM_TPU_EST_SAMPLE_ROWS", "4")
    a, b = make()
    ENGINE.reset()
    p = plan(_port(a), _port(b)).ensure_exact()
    assert p.estimate is not None
    assert ENGINE.counters.get("est_route_mismatch", 0) == int(mismatch)
    jax_events.LOG.clear()
    jax_plan(a, b, backend="xla", platform="cpu").ensure_exact()
    jax_drift = [e for e in jax_events.LOG.tail(200) if e["kind"] == "accum_route_mismatch"]
    assert len(jax_drift) == int(mismatch)
    assert spgemm(_port(a), _port(b), device="cpu") == _oracle(_port(a), _port(b))


# ---------------------------------------------------------- codec and store --
def _plan_arrays(p):
    yield from (p.join.keys, p.join.pair_ptr, p.join.pair_a, p.join.pair_b, p.take)
    for r in p.rounds:
        yield from r.arrays()


@pytest.mark.parametrize("route", ROUTES)
def test_plan_codec_round_trips_with_twins(route, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", route)
    a, b = _hub_pair(keys=3)
    p = plan(_port(a), _port(b), backend="hybrid")
    arrays = sym.plan_to_arrays(p)
    assert int(arrays["codec"]) == sym.PLAN_CODEC_VERSION == 2
    back = sym.plan_from_arrays(arrays, fingerprint=p.fingerprint)
    assert (back.route, back.backend, back.split_fanout) == (route, "hybrid", p.split_fanout)
    assert [(r.route, r.n_rows, r.real_pairs, r.max_fanout, r.dense_alt is None)
            for r in back.rounds] == [(r.route, r.n_rows, r.real_pairs, r.max_fanout,
                                       r.dense_alt is None) for r in p.rounds]
    assert all(u.dtype == v.dtype and np.array_equal(u, v)
               for u, v in zip(_plan_arrays(back), _plan_arrays(p), strict=True))
    if route == "auto":
        assert any(r.dense_alt is not None for r in back.rounds)
    for r_back, r in zip(back.rounds, p.rounds, strict=True):
        _round_equal(r_back, r)


def test_a_v1_plan_entry_is_a_counted_miss(monkeypatch, tmp_path):
    """A plan the codec of version 1 wrote (no route fields) is never half
    read: the warm store counts it and the plan is made cold."""
    monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", str(tmp_path / "warm"))
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", "auto")
    warmstore.reset()
    try:
        a, b = (_port(m) for m in _hub_pair())
        want = plan(a, b)
        [name] = [n for n in os.listdir(warmstore.directory()) if n.startswith("plan-")]
        path = os.path.join(warmstore.directory(), name)
        with np.load(path) as z:
            payload = {key: z[key] for key in z.files
                       if not (key == "route" or key.endswith(("_route", "_seg", "_row_ptr"))
                               or "_alt_" in key)}
        payload["codec"] = np.int64(1)
        np.savez(path, **payload)
        plancache.clear()
        ENGINE.reset()
        got = plan(a, b)
        assert ENGINE.counters["warm_corrupt"] == 1 and "warm_hits" not in ENGINE.counters
        assert all(np.array_equal(u, v) for u, v in zip(_plan_arrays(got), _plan_arrays(want),
                                                         strict=True))
    finally:
        warmstore.reset()


# ---------------------------------------------------------------- generator --
def test_powerlaw_block_sparse_matches_jax():
    for seed, dim, k, avg in ((5, 64, 2, 3.0), (20260, 128, 1, 8.0)):
        got = gen.powerlaw_block_sparse(dim, k, avg, np.random.default_rng(seed))
        want = jax_gen.powerlaw_block_sparse(dim, k, avg, np.random.default_rng(seed))
        assert (got.rows, got.cols, got.k) == (want.rows, want.cols, want.k)
        assert np.array_equal(got.coords, want.coords)
        assert got.tiles.tobytes() == want.tiles.tobytes()
