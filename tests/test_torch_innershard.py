"""The port's inner-dimension sharded multiply (parallel/innershard.spgemm_inner
over ["cpu"] * n) on the CPU against the JAX package's spgemm_inner (on the
conftest's 8 virtual devices, a mesh of the first n) and the field-mode
oracle; the plain versions of the field-mode kernels (ops/cuda_field: F1
field_fold, F3 field_fold_scatter, F2 addmod_field_) and the field helpers
of ops/u64 against python-int arithmetic mod 2^64 - 1 on the edge values;
the all-reduce at every position count.  The JAX side runs with
SPGEMM_TPU_DELTA=0 (ROADMAP.md, faults).  Tolerance: none; every comparison
is byte equality."""

import itertools

import jax
import numpy as np
import pytest
import torch

from spgemm_tpu.ops import u64 as jax_u64
from spgemm_tpu.parallel.innershard import spgemm_inner as jax_inner
from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxMatrix
from spgemm_tpu.utils.gen import powerlaw_block_sparse, random_block_sparse
from spgemm_tpu_torch.ops import cuda_field, plancache, u64
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.parallel import innershard
from spgemm_tpu_torch.parallel.innershard import butterfly_allreduce_modadd, spgemm_inner
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.semantics import field_spgemm_oracle
from spgemm_tpu_torch.utils.timers import ENGINE

MAX = (1 << 64) - 1
EDGE = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
        (1 << 63) - 1, 1 << 63, MAX - 2, MAX - 1, MAX]


@pytest.fixture(autouse=True)
def _jax_delta_off(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")


def _port(m):
    return BlockSparseMatrix.from_reference(m)


def _same(x, y) -> bool:
    return (x.rows, x.cols, x.k) == (y.rows, y.cols, y.k) \
        and np.array_equal(x.coords, y.coords) and np.array_equal(x.tiles, y.tiles)


def _oracle(a, b) -> BlockSparseMatrix:
    return BlockSparseMatrix.from_dict(a.rows, b.cols, a.k,
                                       field_spgemm_oracle(a.to_dict(), b.to_dict(), a.k))


def _mesh(n):
    return jax.make_mesh((n,), ("inner",), devices=jax.devices()[:n])


def _pair(structure: str, dist: str):
    rng = np.random.default_rng({"random": 710, "powerlaw": 711}[structure])
    if structure == "random":
        return (random_block_sparse(9, 9, 4, 0.4, rng, dist),
                random_block_sparse(9, 9, 4, 0.4, rng, dist))
    return (powerlaw_block_sparse(48, 8, 3.0, rng, dist),
            powerlaw_block_sparse(48, 8, 3.0, rng, dist))


@pytest.mark.parametrize("structure", ["random", "powerlaw"])
@pytest.mark.parametrize("dist", ["small", "full", "adversarial"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_inner_is_the_jax_one_and_the_field_oracle(n, dist, structure):
    a, b = _pair(structure, dist)
    got = spgemm_inner(_port(a), _port(b), devices=["cpu"] * n)
    assert _same(got, jax_inner(a, b, mesh=_mesh(n)))
    assert got.prune_zeros() == _oracle(_port(a), _port(b)).prune_zeros()


def _row_by_column(J: int, k: int, seed: int, hi: int = 1 << 64):
    rng = np.random.default_rng(seed)
    a = JaxMatrix(rows=k, cols=J * k, k=k,
                  coords=np.stack([np.zeros(J, np.int64), np.arange(J, dtype=np.int64)], 1),
                  tiles=rng.integers(0, hi, size=(J, k, k), dtype=np.uint64))
    b = JaxMatrix(rows=J * k, cols=k, k=k,
                  coords=np.stack([np.arange(J, dtype=np.int64), np.zeros(J, np.int64)], 1),
                  tiles=rng.integers(0, hi, size=(J, k, k), dtype=np.uint64))
    return a, b


@pytest.mark.parametrize("n", [3, 8])
def test_a_deep_key_cut_over_positions(n):
    """One key of 80 pairs (a 1 x 80 row by an 80 x 1 column) cut over n
    positions, full-range values: the slices and the all-reduce."""
    a, b = _row_by_column(80, 2, 720)
    got = spgemm_inner(_port(a), _port(b), devices=["cpu"] * n)
    assert _same(got, jax_inner(a, b, mesh=_mesh(n)))
    assert got == _oracle(_port(a), _port(b))


def test_fewer_keys_than_devices():
    rng = np.random.default_rng(721)
    k = 4
    a = JaxMatrix.from_blocks(8, 8, k, [(0, 0), (1, 1)],
                              rng.integers(0, MAX, (2, k, k), dtype=np.uint64))
    b = JaxMatrix.from_blocks(8, 8, k, [(0, 1), (1, 0)],
                              rng.integers(0, MAX, (2, k, k), dtype=np.uint64))
    got = spgemm_inner(_port(a), _port(b), devices=["cpu"] * 8)
    assert got.nnzb == 2
    assert _same(got, jax_inner(a, b, mesh=_mesh(8)))


def test_an_empty_join_gives_the_jax_empty_matrix():
    k = 2
    a = JaxMatrix.from_blocks(6, 4, k, [(0, 0)], np.ones((1, k, k), np.uint64))
    b = JaxMatrix.from_blocks(4, 6, k, [(1, 1)], np.ones((1, k, k), np.uint64))
    got = spgemm_inner(_port(a), _port(b), devices=["cpu"] * 3)
    assert got.nnzb == 0 and _same(got, jax_inner(a, b, mesh=_mesh(3)))


def test_round_size_a_plan_and_device_operands_keep_the_bytes():
    """No bit depends on the chunking: the plan cache's ladder plan (its
    rounds, the default), a smaller round size, an explicit plan, and
    device operands whose value bound picks the route."""
    plancache.clear()
    a, b = (_port(m) for m in _pair("random", "full"))
    want = _oracle(a, b).prune_zeros()
    c0 = ENGINE.counter_snapshot()
    for _ in range(3):
        assert spgemm_inner(a, b, devices=["cpu"] * 2).prune_zeros() == want
    c1 = ENGINE.counter_snapshot()
    assert c1.get("plan_cache_misses", 0) - c0.get("plan_cache_misses", 0) == 1
    assert c1.get("plan_cache_hits", 0) - c0.get("plan_cache_hits", 0) == 2
    for rs in (3, 1):
        assert spgemm_inner(a, b, devices=["cpu"] * 2, round_size=rs).prune_zeros() == want
    plan = engine.plan(a, b, route="ladder")
    assert spgemm_inner(a, b, devices=["cpu"] * 3, plan=plan).prune_zeros() == want
    da, db = (DeviceBlockMatrix.from_host(m, "cpu") for m in (a, b))
    assert spgemm_inner(da, db, devices=["cpu"] * 2).prune_zeros() == want
    other = _port(random_block_sparse(9, 9, 4, 0.4, np.random.default_rng(712), "full"))
    with pytest.raises(ValueError, match="different block structure"):
        spgemm_inner(other, b, devices=["cpu"], plan=plan)
    plancache.clear()


@pytest.mark.parametrize("small_values", [True, False])
def test_the_small_route_is_taken_on_its_proof_only(small_values, monkeypatch):
    dist = "small" if small_values else "full"
    a, b = (_port(m) for m in _pair("random", dist))
    seen = []

    def fold(a_slab, b_slab, pa, pb, small=False):
        seen.append(small)
        return cuda_field.field_fold(a_slab, b_slab, pa, pb, small=small)

    monkeypatch.setattr(innershard, "fold_pairs_field", fold)
    got = spgemm_inner(a, b, devices=["cpu"] * 2)
    assert seen and set(seen) == {small_values}
    assert got.prune_zeros() == _oracle(a, b).prune_zeros()


def test_operands_below_2_32_reads_a_value_bound_first():
    a, b = (_port(m) for m in _pair("random", "small"))
    assert u64.operands_below_2_32(a, b) == jax_u64.operands_below_2_32(a, b) is True
    big = _port(_pair("random", "full")[0])
    assert u64.operands_below_2_32(a, big) == jax_u64.operands_below_2_32(a, big) is False
    da = DeviceBlockMatrix.from_host(a, "cpu")
    da.val_bound = 1 << 32  # a loose bound is believed: no reduction runs
    assert not u64.operands_below_2_32(da, b)
    da.val_bound = None
    assert u64.operands_below_2_32(da, b) and da.val_bound == int(a.tiles.max())
    empty = BlockSparseMatrix(rows=4, cols=4, k=4)
    assert u64.operands_below_2_32(empty, big) is False and u64.operands_below_2_32(empty)


def test_engine_phases_of_an_inner_multiply():
    a, b = (_port(m) for m in _pair("random", "full"))
    p0 = ENGINE.snapshot()
    spgemm_inner(a, b, devices=["cpu"] * 2)
    p1 = ENGINE.snapshot()
    for name in ("plan", "upload", "numeric_dispatch", "assembly"):
        assert p1.get(name, 0) > p0.get(name, 0), name


# ------------------------------------------------------- the plain folds --

def _t(values) -> torch.Tensor:
    return u64.u64_to_t(np.asarray(values, dtype=np.uint64))


def test_field_helpers_match_python_ints_and_jax_on_edge_values():
    pairs = np.array(list(itertools.product(EDGE, EDGE)), dtype=np.uint64)
    x, y = _t(pairs[:, 0]), _t(pairs[:, 1])
    xs, ys = pairs[:, 0].tolist(), pairs[:, 1].tolist()
    assert u64.t_to_u64(u64.mulmod_field(x, y)).tolist() == \
        [(p * q) % MAX for p, q in zip(xs, ys)]
    add = torch.zeros_like(x).copy_(x)
    assert u64.t_to_u64(cuda_field.addmod_field_ref_(add, y)).tolist() == \
        [(p + q) % MAX for p, q in zip(xs, ys)]
    triples = np.array(list(itertools.product(EDGE, EDGE, EDGE)), dtype=np.uint64)
    acc, a, b = (_t(triples[:, i]) for i in range(3))
    got = u64.t_to_u64(u64.mac_field(acc, a, b))
    assert got.tolist() == [(s + p * q) % MAX for s, p, q in triples.tolist()]
    jh, jl = jax_u64.mac_field(*jax_u64.u64_to_hilo(triples[:, 0]),
                               *jax_u64.u64_to_hilo(triples[:, 1]),
                               *jax_u64.u64_to_hilo(triples[:, 2]))
    assert np.array_equal(got, jax_u64.hilo_to_u64(jh, jl))
    below = triples[(triples[:, 1] < 1 << 32) & (triples[:, 2] < 1 << 32)]
    acc, a, b = (_t(below[:, i]) for i in range(3))
    assert u64.t_to_u64(u64.mac_field_b32(acc, a, b)).tolist() == \
        [(s + p * q) % MAX for s, p, q in below.tolist()]
    # a sum landing on 2^64 - 1 reads 0
    assert u64.t_to_u64(cuda_field.addmod_field_ref_(_t([MAX - 1]), _t([1]))).tolist() == [0]


def _slab(tiles: np.ndarray) -> torch.Tensor:
    """Tiles plus the zero sentinel tile last."""
    k = tiles.shape[-1]
    return _t(np.concatenate([tiles, np.zeros((1, k, k), np.uint64)]))


def _fold_oracle(a_tiles, b_tiles, pa, pb, a_sent, b_sent) -> np.ndarray:
    K, P = pa.shape
    k = a_tiles.shape[-1]
    out = np.zeros((K, k, k), np.uint64)
    for key in range(K):
        acc = np.zeros((k, k), object)
        for p in range(P):
            if pa[key, p] == a_sent or pb[key, p] == b_sent:
                continue
            acc = acc + a_tiles[pa[key, p]].astype(object).dot(b_tiles[pb[key, p]].astype(object))
        out[key] = (acc % MAX).astype(np.uint64)
    return out


def _edge_tiles(rng, n, k, small=False) -> np.ndarray:
    pool = [v for v in EDGE if v < 1 << 32] if small else EDGE
    return np.array(rng.choice(pool, size=(n, k, k)), dtype=np.uint64)


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("small", [False, True])
def test_field_fold_plain_version_on_edge_values_and_sentinels(k, small):
    rng = np.random.default_rng(730 + k)
    n_a, n_b, K, P = 9, 7, 6, 5
    a_t, b_t = _edge_tiles(rng, n_a, k, small), _edge_tiles(rng, n_b, k, small)
    pa = rng.integers(0, n_a + 1, (K, P)).astype(np.int32)  # n_a: the sentinel
    pb = rng.integers(0, n_b + 1, (K, P)).astype(np.int32)
    pa[0] = n_a      # an all-sentinel key
    pb[1, ::2] = n_b  # one-sided sentinels between real slots
    want = _fold_oracle(a_t, b_t, pa, pb, n_a, n_b)
    a_s, b_s = _slab(a_t), _slab(b_t)
    got = cuda_field.field_fold(a_s, b_s, torch.from_numpy(pa), torch.from_numpy(pb), small=small)
    assert np.array_equal(u64.t_to_u64(got), want)
    # the full route is legal on any values: the same bits
    full = cuda_field.field_fold_ref(a_s, b_s, torch.from_numpy(pa), torch.from_numpy(pb))
    assert np.array_equal(u64.t_to_u64(full), want)


def test_field_fold_collapses_a_sum_of_2_64_minus_1_to_zero():
    """Two products whose sum is 2^64 - 1 exactly: (2^32 - 1)^2 and
    2^33 - 2, each below 2^64 - 1, both routes."""
    k = 1
    a_t = np.array([[[(1 << 32) - 1]], [[(1 << 33) - 2]]], np.uint64)
    b_t = np.array([[[(1 << 32) - 1]], [[1]]], np.uint64)
    pa = torch.tensor([[0, 1]], dtype=torch.int32)
    pb = torch.tensor([[0, 1]], dtype=torch.int32)
    assert ((1 << 32) - 1) ** 2 + (1 << 33) - 2 == MAX
    for small in (False, True):
        got = cuda_field.field_fold(_slab(a_t), _slab(b_t), pa, pb, small=small)
        assert u64.t_to_u64(got).tolist() == [[[0]]]


def test_field_fold_with_no_pairs_or_no_keys():
    k = 2
    a_s = _slab(np.ones((3, k, k), np.uint64))
    got = cuda_field.field_fold(a_s, a_s, torch.zeros((4, 0), dtype=torch.int32),
                                torch.zeros((4, 0), dtype=torch.int32))
    assert got.shape == (4, k, k) and not got.any()
    got = cuda_field.field_fold(a_s, a_s, torch.zeros((0, 3), dtype=torch.int32),
                                torch.zeros((0, 3), dtype=torch.int32))
    assert got.shape == (0, k, k)


@pytest.mark.parametrize("k,small", [(1, False), (1, True), (2, False), (4, True)])
def test_field_fold_plain_version_past_the_pair_depth_limit(k, small):
    """A key of J pairs with J * k > 2^17 (kernel 2's wrapper refuses such a
    round; F1 takes it) and sentinel slots among them, beside a key of
    sentinels only: the field oracle's tile, and zeros."""
    rng = np.random.default_rng(745 + k)
    J = (1 << 17) // k + 9
    hi = 1 << 32 if small else 1 << 64
    a_t, b_t = (rng.integers(0, hi, (J, k, k), dtype=np.uint64) for _ in range(2))
    a_t[0], b_t[0] = (1 << 32) - 1 if small else MAX - 1, (1 << 32) - 1 if small else MAX
    slots = rng.permutation(J).astype(np.int32)
    pa = np.concatenate([slots, np.full(5, J, np.int32)])  # J: the sentinel
    pb = np.concatenate([slots, rng.integers(0, J, 5).astype(np.int32)])
    pa, pb = (np.stack([x, np.full_like(x, J)]) for x in (pa, pb))  # key 1: sentinels only
    assert pa.shape[1] * k > 1 << 17
    a = BlockSparseMatrix(rows=k, cols=J * k, k=k, tiles=a_t,
                          coords=np.stack([np.zeros(J, np.int64), np.arange(J)], 1))
    b = BlockSparseMatrix(rows=J * k, cols=k, k=k, tiles=b_t,
                          coords=np.stack([np.arange(J), np.zeros(J, np.int64)], 1))
    want = field_spgemm_oracle(a.to_dict(), b.to_dict(), k)[(0, 0)]
    got = cuda_field.field_fold(_slab(a_t), _slab(b_t), torch.from_numpy(pa),
                                torch.from_numpy(pb), small=small)
    assert np.array_equal(u64.t_to_u64(got), np.stack([want, np.zeros((k, k), np.uint64)]))


@pytest.mark.parametrize("tail", [False, True])
def test_field_fold_scatter_plain_version_skips_the_dummy_row(tail):
    """Cells in CSR form added into their rows; the dummy row (the
    accumulator's last, which the ring keeps and no cell names) is never
    written.  With `tail`, cells of 1 to 4 pairs with sentinel slots among
    them, and a cell of sentinels only."""
    rng = np.random.default_rng(740)
    k, n_a, n_b, rows_acc = 4, 6, 5, 7
    a_t, b_t = _edge_tiles(rng, n_a, k), _edge_tiles(rng, n_b, k)
    rows = np.array([2, 0, 5, 3], np.int32)
    counts = np.array([3, 1, 4, 2]) if tail else np.ones(4, np.int64)
    cell_ptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    pa = rng.integers(0, n_a + 1, cell_ptr[-1]).astype(np.int32)  # n_a: the sentinel
    pb = rng.integers(0, n_b + 1, cell_ptr[-1]).astype(np.int32)
    if tail:
        pa[cell_ptr[3]: cell_ptr[4]] = n_a  # a cell of sentinel slots only
    start = _edge_tiles(rng, rows_acc, k)
    start[-1] = MAX - 5  # the dummy row's stale value must survive
    acc = _t(start).clone()  # _t shares start's memory
    cuda_field.field_fold_scatter(acc, _slab(a_t), _slab(b_t), torch.from_numpy(rows),
                                  torch.from_numpy(cell_ptr), torch.from_numpy(pa),
                                  torch.from_numpy(pb))
    want = start.copy()
    for c, r in enumerate(rows):
        cut = slice(cell_ptr[c], cell_ptr[c + 1])
        folded = _fold_oracle(a_t, b_t, pa[None, cut], pb[None, cut], n_a, n_b)[0]
        want[r] = ((start[r].astype(object) + folded.astype(object)) % MAX).astype(np.uint64)
    assert np.array_equal(u64.t_to_u64(acc), want)


@pytest.mark.parametrize("n", range(1, 9))
def test_the_all_reduce_leaves_the_field_sum_at_every_position(n):
    rng = np.random.default_rng(750 + n)
    vals = [_edge_tiles(rng, 3, 2) for _ in range(n)]
    total = sum(v.astype(object) for v in vals) % MAX
    out = butterfly_allreduce_modadd([_t(v) for v in vals])
    for t in out:
        assert np.array_equal(u64.t_to_u64(t), total.astype(np.uint64))
