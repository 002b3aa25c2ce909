"""The port's host utilities (spgemm_tpu_torch/utils) against the JAX
package's: the same seed gives the same generated matrices, the text reader
and writer round-trip the golden inputs byte-identically, and the port's
oracle equals the JAX package's.  Tolerance: exact."""

import os

import numpy as np
import pytest

from spgemm_tpu.utils import gen as jax_gen
from spgemm_tpu.utils import io_text as jax_io
from spgemm_tpu.utils import semantics as jax_sem
from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxMatrix
from spgemm_tpu_torch.utils import gen, io_text, semantics
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _same(m, w):
    return (m.rows, m.cols, m.k) == (w.rows, w.cols, w.k) \
        and np.array_equal(m.coords, w.coords) and np.array_equal(m.tiles, w.tiles)


@pytest.mark.parametrize("dist", ["full", "small", "adversarial"])
def test_generators_match_jax_from_one_seed(dist):
    a = gen.random_chain(3, 5, 2, 0.4, np.random.default_rng(8), dist)
    b = jax_gen.random_chain(3, 5, 2, 0.4, np.random.default_rng(8), dist)
    assert all(_same(x, y) for x, y in zip(a, b))
    a = gen.banded_block_sparse(30, 4, 3, np.random.default_rng(9), dist)
    b = jax_gen.banded_block_sparse(30, 4, 3, np.random.default_rng(9), dist)
    assert _same(a, b)


@pytest.mark.parametrize("name", ["golden_chain", "golden_wrap"])
def test_text_round_trip_matches_jax(name, tmp_path):
    folder = os.path.join(DATA, name)
    n, k = io_text.read_size(folder)
    ours = io_text.read_chain(folder, 0, n - 1, k, max_workers=2)
    theirs = jax_io.read_chain(folder, 0, n - 1, k)
    assert all(_same(x, y) for x, y in zip(ours, theirs))
    for x, y in zip(ours, theirs):
        assert io_text.format_matrix(x) == jax_io.format_matrix(y)
    io_text.write_chain_dir(str(tmp_path), ours, k)
    for i in range(n):
        with open(os.path.join(folder, f"matrix{i + 1}"), "rb") as f, \
                open(tmp_path / f"matrix{i + 1}", "rb") as g:
            assert io_text.read_matrix(g.name, k) == io_text.read_matrix(f.name, k)


def test_oracle_and_container_match_jax():
    rng = np.random.default_rng(12)
    a, b = jax_gen.random_chain(2, 4, 2, 0.6, rng, "adversarial")
    ours = semantics.spgemm_oracle(a.to_dict(), b.to_dict(), 2)
    theirs = jax_sem.spgemm_oracle(a.to_dict(), b.to_dict(), 2)
    assert ours.keys() == theirs.keys()
    assert all(np.array_equal(ours[key], theirs[key]) for key in ours)
    m = BlockSparseMatrix.from_dict(a.rows, b.cols, 2, ours)
    assert _same(m.prune_zeros(), JaxMatrix.from_dict(a.rows, b.cols, 2, theirs).prune_zeros())
    assert _same(BlockSparseMatrix.from_reference(a), a)


def test_malformed_inputs_raise(tmp_path):
    (tmp_path / "size").write_text("3\n")
    with pytest.raises(ValueError, match="size"):
        io_text.read_size(str(tmp_path))
    (tmp_path / "m").write_text("4 4\n2\n0 0\n1 2\n")
    with pytest.raises(ValueError, match="expected"):
        io_text.read_matrix(str(tmp_path / "m"), 2)
