"""The port's host planner (spgemm_tpu_torch/ops/symbolic.py) against the JAX
package's: symbolic_join, plan_rounds (ladder layout, round-batched) and
assembly_permutation are array-equal at the same budgets.  Tolerance: exact."""

import numpy as np
import pytest

from spgemm_tpu.ops import symbolic as jax_sym
from spgemm_tpu.utils.gen import banded_block_sparse, random_block_sparse
from spgemm_tpu_torch.ops import symbolic as sym
from spgemm_tpu_torch.ops.spgemm import launch_key_cap, plan


def _structures():
    rng = np.random.default_rng(11)
    out = {
        "random": (random_block_sparse(12, 12, 2, 0.3, rng), random_block_sparse(12, 12, 2, 0.3, rng)),
        "dense": (random_block_sparse(6, 6, 2, 1.0, rng), random_block_sparse(6, 6, 2, 1.0, rng)),
        "banded": (banded_block_sparse(40, 2, 3, rng), banded_block_sparse(40, 2, 2, rng)),
    }
    # hub fanout: one A row meeting every row of B, beside sparse rows
    hub = np.concatenate([np.stack([np.zeros(64, np.int64), np.arange(64)], 1),
                          np.array([[5, 3], [9, 60]])])
    b_c = np.stack([np.arange(64), np.arange(64) % 7], 1)
    out["hub"] = (hub[np.lexsort((hub[:, 1], hub[:, 0]))], b_c)
    out["no_match"] = (np.array([[0, 1]]), np.array([[0, 0]]))
    out["empty_a"] = (np.zeros((0, 2), np.int64), b_c)
    return {name: tuple(getattr(m, "coords", m) for m in pair) for name, pair in out.items()}


STRUCTURES = _structures()


def _join_equal(j, w):
    return all(np.array_equal(getattr(j, f), getattr(w, f))
               for f in ("keys", "pair_ptr", "pair_a", "pair_b"))


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_symbolic_join_matches_jax(name):
    a, b = STRUCTURES[name]
    assert _join_equal(sym.symbolic_join(a, b), jax_sym.symbolic_join(a, b))


@pytest.mark.parametrize("cap", [None, 3, 16])
@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_plan_rounds_and_assembly_match_jax(name, cap):
    a, b = STRUCTURES[name]
    join = sym.symbolic_join(a, b)
    sa, sb = len(a), len(b)
    got = sym.plan_rounds(join, sa, sb, key_cap=8192 if cap is None else cap)
    want = jax_sym.plan_rounds(jax_sym.symbolic_join(a, b), a_sentinel=sa,
                               b_sentinel=sb, round_size=cap, batch=True,
                               route="ladder")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.key_index, w.key_index)
        assert np.array_equal(g.pa, w.pa) and g.pa.dtype == np.int32
        assert np.array_equal(g.pb, w.pb)
        assert g.out_rows == w.out_rows
    assert np.array_equal(sym.assembly_permutation(got, join.num_keys),
                          jax_sym.assembly_permutation(want, join.num_keys))


def test_launch_key_cap_bounds_output_slab():
    for k in (1, 2, 32, 64, 4096):
        cap = launch_key_cap(k)
        assert cap >= 1
        assert cap * k * k <= max(1 << 25, k * k)


def test_plan_refuses_mismatched_operands():
    rng = np.random.default_rng(3)
    from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
    a = BlockSparseMatrix.from_reference(random_block_sparse(6, 6, 2, 0.5, rng))
    b = BlockSparseMatrix.from_reference(random_block_sparse(6, 6, 2, 0.5, rng))
    p = plan(a, b)
    with pytest.raises(ValueError, match="block structure"):
        p.check_operands(b, a)
    with pytest.raises(ValueError, match="tile size"):
        plan(a, BlockSparseMatrix(rows=4, cols=4, k=4))
