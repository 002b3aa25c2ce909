"""The port's ring multiply (parallel/ring.spgemm_ring over ["cpu"] * n) on
the CPU against the JAX package's spgemm_ring (on the conftest's 8 virtual
devices, a mesh of the first n) and the field-mode oracle; plan_ring's
arrays against the JAX package's at both mass-balance settings;
SPGEMM_TPU_RING_OVERLAP 0 and 1 on a repeated device; the hop probe, the
ENGINE phases and counters; SpgemmPlan.ring_schedule; the ring knobs parsed
as the JAX registry parses them.  The JAX side runs with SPGEMM_TPU_DELTA=0
(ROADMAP.md, faults).  Tolerance: none; every comparison is byte
equality."""

import jax
import numpy as np
import pytest

from spgemm_tpu.ops.symbolic import JoinResult as JaxJoin
from spgemm_tpu.parallel.ring import RANK_UNROLL_MAX as JAX_RANK_UNROLL_MAX
from spgemm_tpu.parallel.ring import plan_ring as jax_plan_ring
from spgemm_tpu.parallel.ring import spgemm_ring as jax_ring
from spgemm_tpu.utils import knobs as jax_knobs
from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxMatrix
from spgemm_tpu.utils.gen import powerlaw_block_sparse, random_block_sparse
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
