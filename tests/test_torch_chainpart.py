"""`--ranks P` in the port (spgemm_tpu_torch/parallel/chainpart.py and the
CLI) against the JAX package's chainpart and CLI on the CPU, with the JAX
delta store off (SPGEMM_TPU_DELTA=0, ROADMAP.md faults).  Tolerance: byte
equality of ./matrix and equality of the `multiplying` lines."""

import io
import os
import contextlib

import numpy as np
import pytest

from spgemm_tpu import cli as jax_cli
from spgemm_tpu.parallel.chainpart import partition_chain as jax_partition_chain
from spgemm_tpu_torch import cli
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.ops.spgemm import spgemm_outofcore
from spgemm_tpu_torch.parallel.chainpart import chain_product_partitioned, partition_chain
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
