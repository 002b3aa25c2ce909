"""The frozen structure's counts, the roofline's Medium bound, and the
structure against the port's own generator."""

import numpy as np
import pytest
from _tiny import REPO

from portbench import roofline
from portbench.reference.chain_exact import join
from portbench.structures import banded

MEDIUM = {"kind": "banded", "n": 10, "block_dim": 1111, "bandwidth": 4, "k": 32}


def _chain_counts(leaves):
    arr, pairs, mults = list(leaves), 0, 0
    while len(arr) > 1:
        nxt = []
        for i in range(0, len(arr) - 1, 2):
            jn = join(arr[i], arr[i + 1])
            pairs, mults = pairs + jn.pairs, mults + 1
            nxt.append(jn.keys)
        if len(arr) % 2:
            nxt.append(arr[-1])
        arr = nxt
    return mults, pairs, len(arr[0])


def test_medium_counts():
    import json
    config = json.loads((REPO / "portbench/configs/report-medium.json").read_text())
    assert config["structure"] == MEDIUM
    leaves = banded.build(MEDIUM)
    assert sum(len(c) for c in leaves) == 99790
    assert _chain_counts(leaves) == (9, 3488611, 88351)


def test_roofline_reproduces_the_medium_bound():
    work = roofline.chain_work(banded.build(MEDIUM), 32)
    assert work.pairs == 3488611
    least, bound = roofline.least_seconds(work)
    assert bound == "ops"
    assert round(least * 1e3, 3) == 61.423
    assert roofline.least_seconds(work.scaled(4))[0] == pytest.approx(4 * least)


def test_roofline_counts_bytes_once_each():
    # one multiply of two 2-tile matrices with 3 output keys, k = 2
    a = np.array([[0, 0], [1, 0]])
    b = np.array([[0, 0], [0, 1]])
    work = roofline.chain_work([a, b], 2)
    assert work.pairs == 4
    assert work.bytes == (2 + 2 + 4) * 2 * 2 * 8


@pytest.mark.parametrize("block_dim,bandwidth", [(1, 0), (5, 1), (9, 4), (30, 3)])
def test_band_is_the_ports_banded_structure(block_dim, bandwidth):
    from spgemm_tpu_torch.utils.gen import banded_block_sparse
    want = banded_block_sparse(block_dim, 1, bandwidth, np.random.default_rng(0)).coords
    assert np.array_equal(banded.band(block_dim, bandwidth), want)
