"""The port's multiply and chain (ops/spgemm.py, chain.py) on the CPU against
the JAX package's spgemm(backend="xla") / chain_product and the numpy oracle.
The JAX side runs with SPGEMM_TPU_DELTA=0: its delta store keys results by
structure without the operand dims (ROADMAP.md, faults).  Tolerance: exact."""

import os

import numpy as np
import pytest

from spgemm_tpu.chain import chain_product as jax_chain_product
from spgemm_tpu.ops.spgemm import spgemm as jax_spgemm
from spgemm_tpu.utils import io_text as jax_io
from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxMatrix
from spgemm_tpu.utils.gen import random_block_sparse, random_chain
from spgemm_tpu.utils.semantics import chain_oracle, spgemm_oracle
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.ops.spgemm import spgemm, spgemm_device
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MAX = (1 << 64) - 1
EDGE = np.array([0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
                 (1 << 63) - 1, 1 << 63, MAX - 2, MAX - 1, MAX], dtype=np.uint64)


@pytest.fixture(autouse=True)
def _jax_delta_off(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")


def _port(m):
    return BlockSparseMatrix.from_reference(m)


def _same(port_m, jax_m):
    return (port_m.rows, port_m.cols, port_m.k) == (jax_m.rows, jax_m.cols, jax_m.k) \
        and np.array_equal(port_m.coords, jax_m.coords) \
        and np.array_equal(port_m.tiles, jax_m.tiles)


def _edge_matrix(rng, dim, k, density):
    m = random_block_sparse(dim, dim, k, density, rng)
    m.tiles[:] = EDGE[rng.integers(0, len(EDGE), size=m.tiles.shape)]
    return m


def _check_pair(a, b):
    got = spgemm(_port(a), _port(b), device="cpu")
    want = jax_spgemm(a, b, backend="xla")
    oracle = JaxMatrix.from_dict(a.rows, b.cols, a.k, spgemm_oracle(a.to_dict(), b.to_dict(), a.k))
    assert _same(got, want)
    assert _same(got, oracle)


def test_golden_wrap_pair():
    mats = jax_io.read_chain(os.path.join(DATA, "golden_wrap"), 0, 1, 4)
    _check_pair(*mats)


@pytest.mark.parametrize("seed,k,dim,density", [(1, 2, 6, 0.5), (2, 4, 5, 0.6), (3, 1, 9, 0.3)])
def test_random_edge_pairs(seed, k, dim, density):
    rng = np.random.default_rng(seed)
    _check_pair(_edge_matrix(rng, dim, k, density), _edge_matrix(rng, dim, k, density))


@pytest.mark.parametrize("case", ["empty_a", "empty_b", "no_match"])
def test_empty_operands(case):
    rng = np.random.default_rng(5)
    a = random_block_sparse(4, 4, 2, 0.5, rng)
    b = random_block_sparse(4, 4, 2, 0.5, rng)
    empty = JaxMatrix(rows=8, cols=8, k=2)
    if case == "empty_a":
        a = empty
    elif case == "empty_b":
        b = empty
    else:
        a = JaxMatrix.from_blocks(8, 8, 2, [[0, 3]], a.tiles[:1])
        b = JaxMatrix.from_blocks(8, 8, 2, [[2, 0]], b.tiles[:1])
    got = spgemm_device(_port(a), _port(b), device="cpu")
    assert got.nnzb == 0 and tuple(got.slab.shape) == (1, 2, 2) and not got.slab.any()
    _check_pair(a, b)


def test_hub_fanout():
    """One output row whose keys contract 48 tile pairs each, beside thin keys."""
    rng = np.random.default_rng(9)
    a_c = np.concatenate([[[0, j] for j in range(48)], [[3, 7]]])
    b_c = np.concatenate([[[j, c] for j in range(48) for c in (0, 5)]])
    a = JaxMatrix.from_blocks(4 * 2, 48 * 2, 2, a_c, EDGE[rng.integers(0, 11, (len(a_c), 2, 2))])
    b = JaxMatrix.from_blocks(48 * 2, 6 * 2, 2, b_c, EDGE[rng.integers(0, 11, (len(b_c), 2, 2))])
    _check_pair(a, b)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_chain_matches_jax_and_oracle(n, capsys):
    rng = np.random.default_rng(40 + n)
    mats = random_chain(n, 5, 2, 0.5, rng)
    got = chain_product([_port(m) for m in mats], device="cpu")
    want = jax_chain_product(mats, backend="xla")
    assert _same(got, want)
    oracle = chain_oracle([m.to_dict() for m in mats], 2)
    assert _same(got, JaxMatrix.from_dict(mats[0].rows, mats[-1].cols, 2, oracle))


def test_chain_prints_helper2_progress_and_keeps_device(capsys):
    rng = np.random.default_rng(50)
    mats = [_port(m) for m in random_chain(5, 4, 2, 0.5, rng)]
    res = chain_product(mats, device="cpu", keep_device=True)
    assert isinstance(res, DeviceBlockMatrix) and res.device.type == "cpu"
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["multiplying 0 1", "multiplying 2 3", "multiplying 0 1",
                     "multiplying 0 1"]
    with pytest.raises(ValueError):
        chain_product([], device="cpu")


def test_cuda_without_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    m = _port(random_block_sparse(3, 3, 2, 0.5, np.random.default_rng(1)))
    with pytest.raises(RuntimeError, match="cuda"):
        spgemm(m, m)  # default device is cuda: no fallback to the CPU
