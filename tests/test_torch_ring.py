"""The port's ring multiply (parallel/ring.spgemm_ring over ["cpu"] * n) on
the CPU against the JAX package's spgemm_ring (on the conftest's 8 virtual
devices, a mesh of the first n) and the field-mode oracle; plan_ring's
arrays against the JAX package's at both mass-balance settings;
SPGEMM_TPU_RING_OVERLAP 0 and 1 on a repeated device; the hop probe, the
ENGINE phases and counters; SpgemmPlan.ring_schedule; ring_cells' CSR
against the rank lists and tail it is built from, the plain F3 on it against
the rank-list fold, and one F3 call a step and position; the ring knobs parsed
as the JAX registry parses them.  The JAX side runs with SPGEMM_TPU_DELTA=0
(ROADMAP.md, faults).  Tolerance: none; every comparison is byte
equality."""

import jax
import numpy as np
import pytest
import torch

from spgemm_tpu.ops.symbolic import JoinResult as JaxJoin
from spgemm_tpu.parallel.ring import RANK_UNROLL_MAX as JAX_RANK_UNROLL_MAX
from spgemm_tpu.parallel.ring import plan_ring as jax_plan_ring
from spgemm_tpu.parallel.ring import spgemm_ring as jax_ring
from spgemm_tpu.utils import knobs as jax_knobs
from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxMatrix
from spgemm_tpu.utils.gen import banded_block_sparse, powerlaw_block_sparse, random_block_sparse
from spgemm_tpu_torch.ops import cuda_field, u64
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.ops.symbolic import JoinResult, symbolic_join
from spgemm_tpu_torch.parallel import ring
from spgemm_tpu_torch.parallel.ring import RANK_UNROLL_MAX, plan_ring, spgemm_ring
from spgemm_tpu_torch.utils import knobs
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.semantics import field_spgemm_oracle
from spgemm_tpu_torch.utils.timers import ENGINE


@pytest.fixture(autouse=True)
def _jax_delta_off(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    monkeypatch.delenv("SPGEMM_TPU_RING_OVERLAP", raising=False)


def _port(m):
    return BlockSparseMatrix.from_reference(m)


def _same(x, y) -> bool:
    return (x.rows, x.cols, x.k) == (y.rows, y.cols, y.k) \
        and np.array_equal(x.coords, y.coords) and np.array_equal(x.tiles, y.tiles)


def _oracle(a, b) -> BlockSparseMatrix:
    return BlockSparseMatrix.from_dict(a.rows, b.cols, a.k,
                                       field_spgemm_oracle(a.to_dict(), b.to_dict(), a.k))


def _mesh(n):
    return jax.make_mesh((n,), ("ring",), devices=jax.devices()[:n])


def _pair(structure: str, dist: str):
    rng = np.random.default_rng({"random": 760, "powerlaw": 761}[structure])
    if structure == "random":
        return (random_block_sparse(9, 9, 4, 0.4, rng, dist),
                random_block_sparse(9, 9, 4, 0.4, rng, dist))
    return (powerlaw_block_sparse(48, 8, 3.0, rng, dist),
            powerlaw_block_sparse(48, 8, 3.0, rng, dist))


@pytest.mark.parametrize("structure", ["random", "powerlaw"])
@pytest.mark.parametrize("dist", ["small", "full", "adversarial"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_ring_is_the_jax_one_and_the_field_oracle(n, dist, structure):
    a, b = _pair(structure, dist)
    got = spgemm_ring(_port(a), _port(b), devices=["cpu"] * n)
    assert _same(got, jax_ring(a, b, mesh=_mesh(n)))
    assert got.prune_zeros() == _oracle(_port(a), _port(b)).prune_zeros()


@pytest.mark.parametrize("overlap", ["0", "1"])
def test_a_deep_cell_spills_into_the_tail(overlap, monkeypatch):
    """A 1 x 80 row by an 80 x 1 column: at n = 8 each (key, slab) cell holds
    10 pairs, past RANK_UNROLL_MAX, so the tail trip carries the spill."""
    monkeypatch.setenv("SPGEMM_TPU_RING_OVERLAP", overlap)
    rng = np.random.default_rng(762)
    k, J = 2, 80
    a = JaxMatrix(rows=k, cols=J * k, k=k,
                  coords=np.stack([np.zeros(J, np.int64), np.arange(J, dtype=np.int64)], 1),
                  tiles=rng.integers(0, 1 << 64, size=(J, k, k), dtype=np.uint64))
    b = JaxMatrix(rows=J * k, cols=k, k=k,
                  coords=np.stack([np.arange(J, dtype=np.int64), np.zeros(J, np.int64)], 1),
                  tiles=rng.integers(0, 1 << 64, size=(J, k, k), dtype=np.uint64))
    pa, pb = _port(a), _port(b)
    tail = plan_ring(symbolic_join(pa.coords, pb.coords), pb.nnzb, 8)[3]
    assert tail is not None and tail[1].shape[-1] == J // 8 - RANK_UNROLL_MAX
    got = spgemm_ring(pa, pb, devices=["cpu"] * 8)
    assert _same(got, jax_ring(a, b, mesh=_mesh(8)))
    assert got == _oracle(pa, pb)


def test_fewer_keys_than_devices():
    rng = np.random.default_rng(763)
    k = 4
    a = JaxMatrix.from_blocks(8, 8, k, [(0, 0), (1, 1)],
                              rng.integers(0, 1 << 64, (2, k, k), dtype=np.uint64))
    b = JaxMatrix.from_blocks(8, 8, k, [(0, 1), (1, 0)],
                              rng.integers(0, 1 << 64, (2, k, k), dtype=np.uint64))
    got = spgemm_ring(_port(a), _port(b), devices=["cpu"] * 8)
    assert got.nnzb == 2
    assert _same(got, jax_ring(a, b, mesh=_mesh(8)))


def test_an_empty_join_gives_the_jax_empty_matrix():
    k = 2
    a = JaxMatrix.from_blocks(6, 4, k, [(0, 0)], np.ones((1, k, k), np.uint64))
    b = JaxMatrix.from_blocks(4, 6, k, [(1, 1)], np.ones((1, k, k), np.uint64))
    got = spgemm_ring(_port(a), _port(b), devices=["cpu"] * 3)
    assert got.nnzb == 0 and _same(got, jax_ring(a, b, mesh=_mesh(3)))


def _synthetic_join(seed: int, n_keys: int, nnzb_b: int, n_dev: int, deep: bool):
    """A join with random fanouts, one key deep in slab 0 when `deep` (the
    JAX package's test_plan_ring_packing_matches_naive_oracle)."""
    rng = np.random.default_rng(seed)
    fanouts = rng.integers(0, 7, size=n_keys)
    fat = int(fanouts.argmax())
    if deep:
        fanouts[fat] = RANK_UNROLL_MAX + 4
    pair_ptr = np.concatenate(([0], np.cumsum(fanouts))).astype(np.int64)
    total = int(pair_ptr[-1])
    keys = np.stack(np.divmod(np.arange(n_keys, dtype=np.int64), 7), axis=1)
    pair_a = rng.integers(0, nnzb_b, size=total).astype(np.int32)
    pair_b = rng.integers(0, nnzb_b, size=total).astype(np.int32)
    if deep:
        pair_b[pair_ptr[fat]: pair_ptr[fat + 1]] = \
            rng.integers(0, max(1, nnzb_b // n_dev), size=fanouts[fat]).astype(np.int32)
    return keys, pair_ptr, pair_a, pair_b


def _equal_schedules(x, y) -> bool:
    (kc1, sb1, r1, t1, s1, k1), (kc2, sb2, r2, t2, s2, k2) = x, y
    same = (s1, k1) == (s2, k2) and np.array_equal(sb1, sb2) and len(kc1) == len(kc2) \
        and all(np.array_equal(p, q) for p, q in zip(kc1, kc2)) and len(r1) == len(r2) \
        and (t1 is None) == (t2 is None)
    trips = list(zip(r1, r2)) + ([(t1, t2)] if t1 is not None else [])
    return same and all(np.array_equal(p, q) and p.dtype == q.dtype
                        for u, v in trips for p, q in zip(u, v))


@pytest.mark.parametrize("mass_balance", [False, True])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
@pytest.mark.parametrize("deep", [False, True])
def test_plan_ring_arrays_are_the_jax_ones(mass_balance, n_dev, deep):
    assert RANK_UNROLL_MAX == JAX_RANK_UNROLL_MAX
    keys, pair_ptr, pair_a, pair_b = _synthetic_join(770 + n_dev, 37, 53, n_dev, deep)
    mine = plan_ring(JoinResult(keys, pair_ptr, pair_a, pair_b), 53, n_dev,
                     mass_balance=mass_balance)
    theirs = jax_plan_ring(JaxJoin(keys=keys, pair_ptr=pair_ptr, pair_a=pair_a, pair_b=pair_b),
                           53, n_dev, mass_balance=mass_balance)
    assert _equal_schedules(mine, theirs)
    assert (mine[3] is not None) == deep


@pytest.mark.parametrize("mass_balance", ["0", "1"])
def test_plan_ring_reads_the_estimator_knob_on_a_powerlaw_join(mass_balance, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", mass_balance)
    a, b = (_port(m) for m in _pair("powerlaw", "small"))
    join = symbolic_join(a.coords, b.coords)
    jjoin = JaxJoin(keys=join.keys, pair_ptr=join.pair_ptr, pair_a=join.pair_a,
                    pair_b=join.pair_b)
    assert _equal_schedules(plan_ring(join, b.nnzb, 4), jax_plan_ring(jjoin, b.nnzb, 4))


@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("dist", ["small", "full"])
def test_overlap_on_and_off_are_bit_identical_on_a_repeated_device(n, dist, monkeypatch):
    """Under overlap every hop is issued before the folds of its step: a hop
    that wrote the buffer a fold reads would change the bits here."""
    a, b = (_port(m) for m in _pair("powerlaw", dist))
    monkeypatch.setenv("SPGEMM_TPU_RING_OVERLAP", "0")
    off = spgemm_ring(a, b, devices=["cpu"] * n)
    monkeypatch.setenv("SPGEMM_TPU_RING_OVERLAP", "1")
    on = spgemm_ring(a, b, devices=["cpu"] * n)
    assert _same(on, off) and on.prune_zeros() == _oracle(a, b).prune_zeros()


def test_the_overlap_knob_is_validated_before_any_work(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_RING_OVERLAP", "yes")
    with pytest.raises(ValueError, match="SPGEMM_TPU_RING_OVERLAP"):
        ring.overlap_enabled()
    a, b = (_port(m) for m in _pair("random", "small"))
    with pytest.raises(ValueError, match="SPGEMM_TPU_RING_OVERLAP"):
        spgemm_ring(a, b, devices=["cpu"])


@pytest.mark.parametrize("name, values", [
    ("SPGEMM_TPU_RING_OVERLAP", (None, "", "0", "1", " 1 ", "2", "yes")),
    ("SPGEMM_TPU_RING_HOP_PROBE", (None, "0", "1", "x")),
])
def test_the_ring_knobs_parse_like_jax(name, values, monkeypatch):
    mine, theirs = knobs.REGISTRY[name], jax_knobs.REGISTRY[name]
    assert (mine.kind, mine.default, mine.minimum, mine.tuned) == (
        theirs.kind, theirs.default, theirs.minimum, False)
    for value in values:
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
        try:
            want = jax_knobs.get(name)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                knobs.get(name)
            assert str(got.value) == str(e)
            continue
        assert knobs.get(name) == want, value


def test_the_hop_probe_runs_once_a_shape_and_is_recorded_every_call(monkeypatch):
    a, b = (_port(m) for m in _pair("random", "full"))
    ring._HOP_PROBE_CACHE.clear()
    hops = []
    real_hop = ring._hop
    monkeypatch.setattr(ring, "_hop", lambda *args: hops.append(args) or real_hop(*args))
    ENGINE.reset()
    try:
        for n in (3, 3, 2):
            spgemm_ring(a, b, devices=["cpu"] * n)
        snap, counters = ENGINE.snapshot(), ENGINE.counter_snapshot()
        assert ENGINE.count_snapshot()["ring_hop"] == 3
        assert len(ring._HOP_PROBE_CACHE) == 2
        # two probes, and n - 1 hops a multiply (the last step has none)
        assert len(hops) == 2 + (3 - 1) * 2 + (2 - 1)
        for phase in ("ring_plan", "ring_hop", "ring_fold", "upload", "assembly"):
            assert snap.get(phase, -1) >= 0, phase
        assert counters["ring_steps"] == 3 + 3 + 2
        monkeypatch.setenv("SPGEMM_TPU_RING_HOP_PROBE", "0")
        ENGINE.reset()
        spgemm_ring(a, b, devices=["cpu"] * 4)
        assert "ring_hop" not in ENGINE.snapshot()
        assert len(ring._HOP_PROBE_CACHE) == 2
    finally:
        ENGINE.reset()
        ring._HOP_PROBE_CACHE.clear()


def test_a_plans_ring_schedule_is_memoized_by_the_mass_balance_flag(monkeypatch):
    a, b = (_port(m) for m in _pair("powerlaw", "full"))
    plan = engine.plan(a, b, route="ladder")
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "0")
    flat = plan.ring_schedule(b.nnzb, 4)
    assert plan.ring_schedule(b.nnzb, 4) is flat
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "1")
    mass = plan.ring_schedule(b.nnzb, 4)
    assert mass is not flat and plan.ring_schedule(b.nnzb, 4) is mass
    assert _equal_schedules(mass, plan_ring(plan.join, b.nnzb, 4, mass_balance=True))
    want = _oracle(a, b).prune_zeros()
    assert spgemm_ring(a, b, devices=["cpu"] * 4, plan=plan).prune_zeros() == want
    for x in plan.freeze().ring_schedule(b.nnzb, 3)[2][0]:
        assert not x.flags.writeable
    other = _port(random_block_sparse(9, 9, 8, 0.4, np.random.default_rng(764), "full"))
    with pytest.raises(ValueError):
        spgemm_ring(other, b, devices=["cpu"], plan=plan)


def _deep_pair():
    """A 1 x 80 row by an 80 x 1 column: one key, whose (key, slab) cells
    hold 80 / n pairs, past RANK_UNROLL_MAX at n <= 8."""
    rng = np.random.default_rng(765)
    k, J = 2, 80
    a = JaxMatrix(rows=k, cols=J * k, k=k,
                  coords=np.stack([np.zeros(J, np.int64), np.arange(J, dtype=np.int64)], 1),
                  tiles=rng.integers(0, 1 << 64, size=(J, k, k), dtype=np.uint64))
    b = JaxMatrix(rows=J * k, cols=k, k=k,
                  coords=np.stack([np.arange(J, dtype=np.int64), np.zeros(J, np.int64)], 1),
                  tiles=rng.integers(0, 1 << 64, size=(J, k, k), dtype=np.uint64))
    return a, b


def _join_case(case: str):
    if case == "deep":
        return _deep_pair()
    if case == "banded":
        rng = np.random.default_rng(766)
        return banded_block_sparse(40, 4, 3, rng, "full"), banded_block_sparse(40, 4, 3, rng, "full")
    return _pair("powerlaw", "full")


def _trip_pairs(sched, d: int, s: int) -> list:
    """(row, pa, pb, rank) of every real pair of plan_ring's (d, s) lists:
    the rank lists, then the tail."""
    _, _, ranks, tail, _, k_max = sched
    out = []
    for r, (rows, pa, pb) in enumerate(ranks):
        out += [(int(rows[d, s, c]), int(pa[d, s, c]), int(pb[d, s, c]), r)
                for c in range(rows.shape[-1]) if rows[d, s, c] != k_max]
    if tail is not None:
        rows, pa, pb = tail
        out += [(int(rows[d, s, c]), int(pa[d, s, c, p]), int(pb[d, s, c, p]),
                 RANK_UNROLL_MAX + p)
                for c in range(rows.shape[-1]) for p in range(pa.shape[-1]) if pa[d, s, c, p] >= 0]
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("case", ["banded", "powerlaw", "deep"])
def test_ring_cells_hold_the_rank_lists_and_tail_pairs(case, n):
    """Each (position, slab) list of the CSR holds the same (row, pa, pb)
    multiset as plan_ring's rank lists and tail there, each cell's pairs in
    rank order, its rows unique and never the dummy row."""
    a, b = (_port(m) for m in _join_case(case))
    sched = plan_ring(symbolic_join(a.coords, b.coords), b.nnzb, n)
    cells = ring.ring_cells(sched[2], sched[3], n, sched[5])
    if case == "deep" and n == 8:
        assert sched[3] is not None
    assert cells.group_ptr.shape == (n * n + 1,) and cells.group_ptr[-1] == len(cells.rows)
    assert cells.cell_ptr[0] == 0 and cells.cell_ptr[-1] == len(cells.pa) == len(cells.pb)
    assert (np.diff(cells.cell_ptr) >= 1).all() and (np.diff(cells.group_ptr) >= 0).all()
    assert cells.rows.dtype == cells.pa.dtype == cells.pb.dtype == np.int32
    for d in range(n):
        for s in range(n):
            want = _trip_pairs(sched, d, s)
            c0, c1 = cells.group_ptr[d * n + s], cells.group_ptr[d * n + s + 1]
            rows = cells.rows[c0:c1]
            assert len(set(rows.tolist())) == len(rows) and (rows != sched[5]).all()
            got = [(int(rows[c - c0]), int(cells.pa[p]), int(cells.pb[p]))
                   for c in range(c0, c1) for p in range(cells.cell_ptr[c], cells.cell_ptr[c + 1])]
            assert sorted(got) == sorted(w[:3] for w in want)
            # within a cell, the pairs come in rank order
            assert got == [w[:3] for w in sorted(want, key=lambda w: (w[0], w[3]))]


def _acc_start(rng, rows: int, k: int) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 1 << 64, (rows, k, k), dtype=np.uint64).view(np.int64))


def _rank_list_fold(acc, a_slab, b_slab, trip, d: int, s: int, dummy: int, a_sent: int):
    """The fold of plan_ring's trip at (d, s) as separate scatter-adds: one
    field_fold_ref of its real cells, added into their rows."""
    rows, pa, pb = (np.asarray(x[d, s]) for x in trip)
    keep = rows != dummy
    pa = np.where(pa < 0, a_sent, pa).astype(np.int32)
    pa, pb = (torch.from_numpy(np.ascontiguousarray(x[keep] if x.ndim == 2 else x[keep, None]))
              for x in (pa, pb))
    folded = cuda_field.field_fold_ref(a_slab, b_slab, pa, pb)
    idx = torch.from_numpy(rows[keep]).long()
    acc.index_copy_(0, idx, u64.collapse_max(u64.addmod_field(acc.index_select(0, idx), folded)))


@pytest.mark.parametrize("overlap", ["0", "1"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_the_csr_fold_is_the_rank_list_fold_and_the_jax_ring(n, overlap, monkeypatch):
    """The plain F3 on each (position, slab) CSR list gives the bits of
    plan_ring's rank lists and tail folded one trip at a time, and the ring
    that runs it gives the JAX package's bytes."""
    monkeypatch.setenv("SPGEMM_TPU_RING_OVERLAP", overlap)
    ja, jb = _deep_pair() if n == 4 else _pair("powerlaw", "full")
    a, b = _port(ja), _port(jb)
    key_chunks, slab_bounds, ranks, tail, s_max, k_max = sched = \
        plan_ring(symbolic_join(a.coords, b.coords), b.nnzb, n)
    cells = ring.ring_cells(ranks, tail, n, k_max)
    k = a.k
    a_slab = torch.from_numpy(np.concatenate([a.tiles, np.zeros((1, k, k), np.uint64)])
                              .view(np.int64))
    rng = np.random.default_rng(780 + n)
    for d in range(n):
        rows, cell_ptr, pa, pb, bounds = cells.position(d)
        for s in range(n):
            b_np = np.zeros((s_max + 1, k, k), np.uint64)
            b_np[: slab_bounds[s + 1] - slab_bounds[s]] = b.tiles[slab_bounds[s]: slab_bounds[s + 1]]
            b_slab = torch.from_numpy(b_np.view(np.int64))
            start = _acc_start(rng, k_max + 1, k)
            got, want = start.clone(), start.clone()
            c0, c1 = bounds[s], bounds[s + 1]
            cuda_field.field_fold_scatter(got, a_slab, b_slab, torch.from_numpy(rows[c0:c1]),
                                          torch.from_numpy(cell_ptr[c0: c1 + 1]),
                                          torch.from_numpy(pa), torch.from_numpy(pb))
            for trip in ranks + ([tail] if tail is not None else []):
                _rank_list_fold(want, a_slab, b_slab, trip, d, s, k_max, a.nnzb)
            assert torch.equal(got, want) and torch.equal(got[-1], start[-1])
    assert n != 4 or sched[3] is not None
    got = spgemm_ring(a, b, devices=["cpu"] * n)
    assert _same(got, jax_ring(ja, jb, mesh=_mesh(n)))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_f3_runs_once_a_step_and_position_with_cells(n, monkeypatch):
    """One F3 call a (step, position) whose list has cells, none for an
    empty list: at most n^2 a multiply."""
    a, b = (_port(m) for m in _pair("powerlaw", "small"))
    calls = []
    real = cuda_field.field_fold_scatter
    monkeypatch.setattr(cuda_field, "field_fold_scatter",
                        lambda *args, **kw: calls.append(args[3].shape[0]) or real(*args, **kw))
    got = spgemm_ring(a, b, devices=["cpu"] * n)
    assert got.prune_zeros() == _oracle(a, b).prune_zeros()
    sched = plan_ring(symbolic_join(a.coords, b.coords), b.nnzb, n)
    cells = ring.ring_cells(sched[2], sched[3], n, sched[5])
    sizes = np.diff(cells.group_ptr)
    assert len(calls) == int((sizes > 0).sum()) <= n * n
    assert sorted(calls) == sorted(sizes[sizes > 0].tolist())


def test_ring_cells_are_memoized_with_the_schedule_and_frozen_with_the_plan(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "0")
    a, b = (_port(m) for m in _pair("powerlaw", "full"))
    plan = engine.plan(a, b, route="ladder")
    cells = plan.ring_cells(b.nnzb, 4)
    assert plan.ring_cells(b.nnzb, 4) is cells
    sched = plan.ring_schedule(b.nnzb, 4)
    want = ring.ring_cells(sched[2], sched[3], 4, sched[5])
    assert all(np.array_equal(x, y) for x, y in zip(cells.arrays(), want.arrays()))
    frozen = plan.freeze().ring_cells(b.nnzb, 3)
    assert plan.ring_cells(b.nnzb, 3) is frozen
    assert not any(x.flags.writeable for x in frozen.arrays())
    assert spgemm_ring(a, b, devices=["cpu"] * 3, plan=plan).prune_zeros() == \
        _oracle(a, b).prune_zeros()
