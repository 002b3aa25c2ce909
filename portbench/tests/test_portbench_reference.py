"""The plain reference against the port's numpy oracle (python ints, the
reference's own semantics) on corner values, and the whole harness with the
port on the CPU at a tiny size: every cell comes out correct."""

import numpy as np
import pytest
import torch
from _tiny import run

from portbench.reference import chain_exact
from portbench.structures import banded


def _tiles(coords, k, rng, dist):
    from spgemm_tpu_torch.utils.gen import random_values
    return random_values((len(coords), k, k), rng, dist)


def _skewed(block_dim, avg_per_row, seed):
    """A power-law structure (the port's generator) and its transpose, both
    sorted by (row, col): their product's hub keys fold many pairs."""
    from spgemm_tpu_torch.utils.gen import powerlaw_block_sparse
    a = powerlaw_block_sparse(block_dim, 1, avg_per_row, np.random.default_rng(seed)).coords
    t = a[:, ::-1]
    return a, np.ascontiguousarray(t[np.lexsort((t[:, 1], t[:, 0]))])


@pytest.mark.parametrize("dist", ["full", "adversarial", "small"])
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_reference_matches_the_oracle(dist, n):
    from spgemm_tpu_torch.utils.semantics import chain_oracle
    k = 3
    rng = np.random.default_rng(n * 7 + len(dist))
    coords = banded.band(6, 1)
    mats = [(coords, _tiles(coords, k, rng, dist)) for _ in range(n)]
    want = chain_oracle([{tuple(map(int, c)): t for c, t in zip(cs, ts)} for cs, ts in mats], k)
    got_coords, got_tiles = chain_exact.chain_product(
        [(cs, torch.from_numpy(ts.view(np.int64))) for cs, ts in mats], key_block=4)
    assert [tuple(map(int, c)) for c in got_coords] == sorted(want)
    got = got_tiles.numpy().view(np.uint64)
    for i, key in enumerate(sorted(want)):
        assert np.array_equal(got[i], want[key]), key


def test_reference_matches_the_oracle_on_skewed_rows():
    # power-law rows: hub keys fold many pairs, others one
    from spgemm_tpu_torch.utils.semantics import spgemm_oracle
    k = 2
    rng = np.random.default_rng(11)
    a, b = _skewed(25, 3.0, 4)
    ta, tb = _tiles(a, k, rng, "adversarial"), _tiles(b, k, rng, "adversarial")
    want = spgemm_oracle({tuple(map(int, c)): t for c, t in zip(a, ta)},
                         {tuple(map(int, c)): t for c, t in zip(b, tb)}, k)
    keys, tiles = chain_exact.multiply((a, torch.from_numpy(ta.view(np.int64))),
                                       (b, torch.from_numpy(tb.view(np.int64))), key_block=7)
    assert [tuple(map(int, c)) for c in keys] == sorted(want)
    for i, key in enumerate(sorted(want)):
        assert np.array_equal(tiles[i].numpy().view(np.uint64), want[key])


@pytest.mark.parametrize("cell", ["medium.sweep", "medium.batch4"])
def test_the_port_on_the_cpu_is_correct(tmp_path, monkeypatch, cell):
    result, lines = run(tmp_path, cell, monkeypatch)
    assert result["correct"] is True, lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert lines[0].startswith("portbench: host ms a chain: ")
    assert lines[1:] == ["check bad_keys 0 limit 0", "check bad_tiles 0 limit 0",
                     "check failed 0 limit 0"]
    assert list(result)[-1] == "checks"
    want = {"medium.sweep": {"chain_s", "chain_p95_s", "device_peak_gib", "setup_s"},
            "medium.batch4": {"chain_s.batch", "device_peak_gib", "setup_s"}}[cell]
    assert set(result["metrics"]) == want


@pytest.mark.parametrize("cell,suffix", [("medium.sweep", ""), ("medium.batch4", ".batch")])
def test_a_traced_run_on_the_cpu_reads_its_layers(tmp_path, monkeypatch, cell, suffix):
    result, _ = run(tmp_path, cell, monkeypatch, trace=True)
    assert result["correct"] is True
    assert set(result["metrics"]) >= {"plan_ms" + suffix, "device_idle" + suffix}
    assert result["metrics"]["plan_ms" + suffix]["value"] > 0
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert len(result["breakdown"]["device_ops"]) <= 10
    assert len(result["breakdown"]["idle_gaps"]) <= 10


def test_the_same_seed_draws_the_same_leaves():
    from portbench.leaves import Leaves, request_seed
    coords = [banded.band(5, 1)] * 2
    a = Leaves.alloc(coords, 3, 2, torch.device("cpu"))
    b = Leaves.alloc(coords, 3, 2, torch.device("cpu"))
    a.draw(2 ** 33 + 5, 7)
    b.draw(2 ** 33 + 5, 7)
    assert torch.equal(a.buf, b.buf)
    b.draw(2 ** 33 + 5, 8)
    assert not torch.equal(a.buf, b.buf)
    for chain in a.slabs():
        for slab in chain:
            assert not slab[-1].any() and slab[:-1].ne(0).any()
    assert request_seed(-1, 0) != request_seed(1, 0)
    assert (a.buf < 0).any() and (a.buf > 0).any()  # all 64 bits drawn


def test_the_all_ones_test_finds_exactly_the_all_ones_products():
    g = torch.Generator().manual_seed(3)
    a = torch.empty((6, 3, 3), dtype=torch.int64).random_(-2 ** 63, None, generator=g)
    b = torch.empty((6, 3, 3), dtype=torch.int64).random_(-2 ** 63, None, generator=g)
    a[:, 0, 0] |= 1  # odd
    assert not chain_exact.all_ones_product(a, b)
    b[4, 0, 2] = chain_exact.neg_inverse(a)[4, 0, 0]
    assert int(a[4, 0, 0] * b[4, 0, 2]) == -1
    assert chain_exact.all_ones_product(a, b, chunk=2)
    a[4, 0, 0] += 1  # even: no product of it is all ones
    assert not chain_exact.all_ones_product(a, b)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["full", "adversarial"])
def test_the_reference_on_the_card_is_the_reference_on_the_cpu(card, dist):
    rng = np.random.default_rng(5)
    a, b = _skewed(200, 4.0, 4)
    ta, tb = _tiles(a, 32, rng, dist), _tiles(b, 32, rng, dist)
    host = chain_exact.multiply((a, torch.from_numpy(ta.view(np.int64))),
                                (b, torch.from_numpy(tb.view(np.int64))), key_block=512)
    dev = chain_exact.multiply((a, torch.from_numpy(ta.view(np.int64)).cuda()),
                               (b, torch.from_numpy(tb.view(np.int64)).cuda()), key_block=512)
    assert np.array_equal(host[0], dev[0])
    assert torch.equal(host[1], dev[1].cpu())
