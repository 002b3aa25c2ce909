"""The port's u64 helpers on torch int64 bit-views against the JAX package's
python-int and numpy oracles, over every triple of the SURVEY.md section 2.9
trigger set.  Tolerance: exact (integer equality)."""

import itertools

import numpy as np
import pytest

from spgemm_tpu.utils.semantics import addmod_np, mulmod_np, scalar_mac
from spgemm_tpu_torch.ops import u64

MAX = (1 << 64) - 1
# the same trigger set as tests/test_property.py's EDGE
EDGE = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
        (1 << 63) - 1, 1 << 63, MAX - 2, MAX - 1, MAX]
TRIPLES = np.array(list(itertools.product(EDGE, EDGE, EDGE)), dtype=np.uint64)


def test_bit_view_round_trip():
    x = TRIPLES.reshape(-1)
    t = u64.u64_to_t(x)
    assert str(t.dtype) == "torch.int64"
    assert np.array_equal(u64.t_to_u64(t), x)


def test_mac_matches_scalar_mac_on_edge_triples():
    acc, a, b = (u64.u64_to_t(TRIPLES[:, i]) for i in range(3))
    got = u64.t_to_u64(u64.mac(acc, a, b))
    want = np.array([scalar_mac(int(s), int(x), int(y)) for s, x, y in TRIPLES.tolist()],
                    dtype=np.uint64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("op,ref", [(u64.mulmod, mulmod_np), (u64.addmod, addmod_np)],
                         ids=["mulmod", "addmod"])
def test_step_matches_numpy_oracle_on_edge_pairs(op, ref):
    pairs = np.array(list(itertools.product(EDGE, EDGE)), dtype=np.uint64)
    got = u64.t_to_u64(op(u64.u64_to_t(pairs[:, 0]), u64.u64_to_t(pairs[:, 1])))
    assert np.array_equal(got, ref(pairs[:, 0], pairs[:, 1]))


def test_mulmod_is_scalar_mac_from_zero():
    pairs = np.array(list(itertools.product(EDGE, EDGE)), dtype=np.uint64)
    got = u64.t_to_u64(u64.mulmod(u64.u64_to_t(pairs[:, 0]), u64.u64_to_t(pairs[:, 1])))
    want = np.array([scalar_mac(0, int(x), int(y)) for x, y in pairs.tolist()], np.uint64)
    assert np.array_equal(got, want)
