"""`--ranks P` in the port (spgemm_tpu_torch/parallel/chainpart.py and the
CLI) against the JAX package's chainpart and CLI on the CPU, with the JAX
delta store off (SPGEMM_TPU_DELTA=0, ROADMAP.md faults); the ranks over a
device list (chain_product_on_devices, `--shard chain`) against the JAX
package's on the conftest's virtual devices and against
chain_product_partitioned.  Tolerance: byte equality of ./matrix and
equality of the `multiplying` lines."""

import io
import os
import contextlib

import numpy as np
import pytest

import jax

from spgemm_tpu import cli as jax_cli
from spgemm_tpu.parallel.chainpart import chain_product_on_devices as jax_on_devices
from spgemm_tpu.parallel.chainpart import partition_chain as jax_partition_chain
from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxMatrix
from spgemm_tpu_torch import cli
from spgemm_tpu_torch.chain import chain_product, oracle_multiply
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.ops.spgemm import spgemm_outofcore
from spgemm_tpu_torch.parallel import chainpart
from spgemm_tpu_torch.parallel.chainpart import (chain_product_on_devices,
                                                 chain_product_partitioned, partition_chain)
from spgemm_tpu_torch.utils import io_text
from spgemm_tpu_torch.utils.gen import random_chain

# (n, P) whose bytes differ from P = 1 on the chains below (adversarial
# values: the fold's non-associativity shows only near 2^64 - 1)
DIFFERS = [(3, 2), (5, 3), (9, 8)]


@pytest.fixture(autouse=True)
def _jax_delta_off(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")


def _chain(n):
    return random_chain(n, 4, 2, 0.5, np.random.default_rng(500 + n), "adversarial")


@pytest.fixture(scope="module")
def chain_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("chains")
    dirs = {}
    for n in range(1, 10):
        dirs[n] = str(root / f"chain{n}")
        io_text.write_chain_dir(dirs[n], _chain(n), 2)
    return dirs


@pytest.mark.parametrize("p", range(1, 13))
def test_partition_chain_matches_jax(p):
    for n in range(1, 21):
        assert partition_chain(n, p) == jax_partition_chain(n, p), (n, p)
    assert partition_chain(3, p + 3) == [(0, 2)] + [None] * (p + 2)  # the q == 0 branch


def _run(fn, folder, out, *extra) -> tuple[bytes, list[str]]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn([folder, "--device", "cpu", "--output", out, *extra]) == 0
    with open(out, "rb") as f:
        return f.read(), buf.getvalue().splitlines()


@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("n", range(1, 10))
def test_cli_ranks_matches_jax_cli(n, p, chain_dirs, tmp_path):
    got, lines = _run(cli.run, chain_dirs[n], str(tmp_path / "port"), "--ranks", str(p))
    want, want_lines = _run(jax_cli.run, chain_dirs[n], str(tmp_path / "jax"), "--ranks", str(p))
    assert got == want
    assert lines[:-1] == want_lines[:-1]
    assert lines[-1].startswith("time taken ")
    if (n, p) in DIFFERS:
        p1, _ = _run(cli.run, chain_dirs[n], str(tmp_path / "p1"))
        assert got != p1  # the partition changes the bytes: the test is not vacuous


@pytest.mark.parametrize("multiply", [None, spgemm_outofcore], ids=["resident", "ooc"])
def test_partitioned_in_memory_and_checkpoint_dirs(multiply, tmp_path, capsys):
    mats = _chain(9)
    want = chain_product_partitioned(mats, 8, multiply=multiply, device="cpu")
    capsys.readouterr()
    ck = str(tmp_path / "ck")
    got = chain_product_partitioned(mats, 8, multiply=multiply, device="cpu", checkpoint_dir=ck)
    assert got == want
    # ranks 0-6 hold one matrix each (no pass), rank 7 two (one pass); the
    # combine reduces 8 partials in three passes
    assert sorted(os.listdir(ck)) == ["combine", "rank7"]
    assert sorted(os.listdir(os.path.join(ck, "rank7"))) == ["pass_1.npz"]
    assert sorted(os.listdir(os.path.join(ck, "combine"))) == ["pass_1.npz", "pass_2.npz",
                                                               "pass_3.npz"]
    dev = chain_product_partitioned(mats, 8, multiply=multiply, device="cpu", keep_device=True)
    assert isinstance(dev, DeviceBlockMatrix) == (multiply is None)
    assert (dev.to_host() if multiply is None else dev) == want
    assert chain_product_partitioned(mats, 1, multiply=multiply, device="cpu") == \
        chain_product(mats, multiply=multiply, device="cpu")
    with pytest.raises(ValueError, match="num_parts"):
        chain_product_partitioned(mats, 0, device="cpu")


def _jax(m):
    return JaxMatrix(rows=m.rows, cols=m.cols, k=m.k, coords=m.coords, tiles=m.tiles)


@pytest.mark.parametrize("n, p, n_dev", [(9, 8, 3), (9, 3, 3), (5, 3, 2), (3, 8, 4), (2, 5, 2),
                                         (7, None, 4), (1, None, 2)])
def test_on_devices_is_the_jax_one_and_partitioned_at_the_same_p(n, p, n_dev, capsys):
    """Adversarial values (the partition changes the bytes), P explicit and
    by default the device count, N < P (rank 0 alone) and one matrix."""
    mats = _chain(n)
    got = chain_product_on_devices(mats, ["cpu"] * n_dev, num_parts=p)
    lines = capsys.readouterr().out
    want = chain_product_partitioned(mats, p or n_dev, device="cpu")
    assert capsys.readouterr().out == lines
    assert got == want
    theirs = jax_on_devices([_jax(m) for m in mats], jax.devices()[:n_dev], num_parts=p)
    assert np.array_equal(got.coords, theirs.coords) and np.array_equal(got.tiles, theirs.tiles)


def test_on_devices_checkpoints_each_rank_and_the_combine(tmp_path, capsys):
    mats = _chain(9)
    want = chain_product_partitioned(mats, 8, device="cpu")
    ck = str(tmp_path / "ck")
    assert chain_product_on_devices(mats, ["cpu"] * 3, num_parts=8, checkpoint_dir=ck) == want
    assert sorted(os.listdir(ck)) == ["combine", "rank7"]
    assert sorted(os.listdir(os.path.join(ck, "combine"))) == ["pass_1.npz", "pass_2.npz",
                                                               "pass_3.npz"]
    # a second run resumes from the snapshots and gives the same bytes
    assert chain_product_on_devices(mats, ["cpu"] * 3, num_parts=8, checkpoint_dir=ck) == want


def test_a_rank_on_the_host_oracle_sends_the_combine_there(monkeypatch, capsys):
    """A rank that failed over returns a host partial: the combine then runs
    on the host oracle, with the reference's bytes."""
    mats = _chain(9)
    want = chain_product_partitioned(mats, 3, device="cpu")
    calls = []
    real = chainpart.chain_product

    def fake(matrices, **kw):
        calls.append(kw.get("multiply"))
        out = real(matrices, **kw)
        return out.to_host() if len(calls) == 2 else out  # rank 1 "failed over"

    monkeypatch.setattr(chainpart, "chain_product", fake)
    assert chain_product_on_devices(mats, ["cpu"] * 3, num_parts=3, failover=True) == want
    assert calls[-1] is oracle_multiply and len(calls) == 4


def test_partitioned_sends_the_combine_to_the_host_after_a_failover(monkeypatch, capsys):
    """`--ranks P` and `--shard chain` share one failover rule: a rank that
    failed over on one device also sends the combine to the host oracle."""
    mats = _chain(9)
    want = chain_product_partitioned(mats, 3, device="cpu")
    calls = []
    real = chainpart.chain_product

    def fake(matrices, **kw):
        calls.append(kw.get("multiply"))
        out = real(matrices, **kw)
        return out.to_host() if len(calls) == 1 else out  # rank 0 "failed over"

    monkeypatch.setattr(chainpart, "chain_product", fake)
    assert chain_product_partitioned(mats, 3, device="cpu", failover=True) == want
    assert calls[-1] is oracle_multiply and len(calls) == 4
