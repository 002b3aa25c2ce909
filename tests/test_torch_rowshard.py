"""The port's output-sharded multiply (parallel/rowshard.spgemm_sharded over
["cpu"] * n) on the CPU against the JAX package's spgemm_sharded (on the
conftest's 8 virtual devices, default_mesh(n)) and the port's own
spgemm_device; the plan's memoized rowshard_rounds; the device lists of
parallel/mesh; and `--shard keys` in the port's CLI against the golden files
and the JAX CLI.  The JAX side runs with SPGEMM_TPU_DELTA=0 (ROADMAP.md,
faults).  Tolerance: zero differing bytes."""

import contextlib
import io
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

from spgemm_tpu.chain import chain_product as jax_chain_product
from spgemm_tpu.parallel.mesh import default_mesh
from spgemm_tpu.parallel.rowshard import spgemm_sharded as jax_sharded
from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxMatrix
from spgemm_tpu.utils.gen import random_block_sparse, random_chain
from spgemm_tpu_torch import cli as port_cli
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops import plancache
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.parallel import mesh
from spgemm_tpu_torch.parallel.rowshard import spgemm_sharded
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.timers import ENGINE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


@pytest.fixture(autouse=True)
def _jax_delta_off(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")


def _port(m):
    return BlockSparseMatrix.from_reference(m)


def _same(x, y) -> bool:
    return (x.rows, x.cols, x.k) == (y.rows, y.cols, y.k) \
        and np.array_equal(x.coords, y.coords) and np.array_equal(x.tiles, y.tiles)


def _pair(dist: str, seed: int = 5, dim: int = 12, k: int = 4, density: float = 0.4):
    return random_chain(2, dim, k, density, np.random.default_rng(seed), dist)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("dist", ["full", "small", "adversarial"])
def test_the_sharded_multiply_is_the_jax_one_and_spgemm_device(dist, n):
    a, b = _pair(dist)
    got = spgemm_sharded(_port(a), _port(b), devices=["cpu"] * n)
    assert _same(got, jax_sharded(a, b, mesh=default_mesh(n)))
    assert _same(got, engine.spgemm_device(_port(a), _port(b), device="cpu").to_host())


def test_fewer_keys_than_devices():
    """Two output keys over 8 shards: six shards hold only sentinel rows,
    whose tiles are cut away."""
    rng = np.random.default_rng(3)
    k = 4
    a = JaxMatrix.from_blocks(8, 8, k, [(0, 0), (1, 1)],
                              rng.integers(0, 1 << 63, (2, k, k), dtype=np.uint64))
    b = JaxMatrix.from_blocks(8, 8, k, [(0, 1), (1, 0)],
                              rng.integers(0, 1 << 63, (2, k, k), dtype=np.uint64))
    got = spgemm_sharded(_port(a), _port(b), devices=["cpu"] * 8)
    assert got.nnzb == 2
    assert _same(got, jax_sharded(a, b, mesh=default_mesh(8)))
    assert _same(got, engine.spgemm_device(_port(a), _port(b), device="cpu").to_host())


def test_an_empty_join_gives_the_jax_empty_matrix():
    k = 2
    a = JaxMatrix.from_blocks(6, 4, k, [(0, 0)], np.ones((1, k, k), np.uint64))
    b = JaxMatrix.from_blocks(4, 6, k, [(1, 1)], np.ones((1, k, k), np.uint64))
    got = spgemm_sharded(_port(a), _port(b), devices=["cpu"] * 3)
    want = jax_sharded(a, b, mesh=default_mesh(3))
    assert got.nnzb == 0 and _same(got, want)


def test_a_reused_plan_memoizes_its_rowshard_rounds():
    """The plan kwarg's join and schedule are reused: one schedule per round
    size, the default the card's launch cap, ladder rounds within it, the
    same bytes at every round size and with or without the plan."""
    a, b = (_port(m) for m in _pair("full", seed=9, dim=16))
    plan = engine.plan(a, b)
    cap = engine.launch_key_cap(a.k)
    first = plan.rowshard_rounds()
    assert plan.rowshard_rounds() is first and plan.rowshard_rounds(cap) is first
    assert plan.rowshard_rounds(10 * cap) is first  # capped at the launch cap
    small = plan.rowshard_rounds(3)
    assert plan.rowshard_rounds(3) is small and len(small) > len(first)
    assert all(r.route == "ladder" and r.pa.ndim == 2 and len(r.key_index) <= 3 for r in small)
    want = engine.spgemm_device(a, b, device="cpu").to_host()
    for rs in (None, 3, 1):
        got = spgemm_sharded(a, b, devices=["cpu"] * 3, plan=plan, round_size=rs)
        assert _same(got, want)
    assert _same(spgemm_sharded(a, b, devices=["cpu"] * 3, round_size=2), want)
    other = _port(_pair("full", seed=10, dim=16)[0])
    with pytest.raises(ValueError, match="different block structure"):
        spgemm_sharded(other, b, devices=["cpu"], plan=plan)


def test_without_a_plan_the_plan_caches_ladder_plan_is_reused():
    """No plan kwarg: the plan cache's ladder plan (ops/spgemm.plan), whose
    own rounds are the rowshard schedule, so a repeated structure plans
    nothing again; its bytes are spgemm_device's."""
    plancache.clear()
    a, b = (_port(m) for m in _pair("full", seed=12, dim=16))
    want = engine.spgemm_device(a, b, device="cpu").to_host()
    c0 = ENGINE.counter_snapshot()
    for _ in range(3):
        assert _same(spgemm_sharded(a, b, devices=["cpu"] * 2), want)
    c1 = ENGINE.counter_snapshot()
    assert c1.get("plan_cache_misses", 0) - c0.get("plan_cache_misses", 0) == 1
    assert c1.get("plan_cache_hits", 0) - c0.get("plan_cache_hits", 0) == 2
    ladder = engine.plan(a, b, route="ladder")
    assert ladder.rowshard_rounds() is ladder.rounds
    fresh = engine.plan(a, b, route="dense")
    assert [r.key_index.tolist() for r in fresh.rowshard_rounds()] == \
        [r.key_index.tolist() for r in ladder.rounds]
    plancache.clear()


def test_a_frozen_plans_schedule_is_frozen():
    a, b = (_port(m) for m in _pair("full", seed=11))
    plan = engine.plan(a, b).freeze()
    for rnd in plan.rowshard_rounds(2):
        assert not rnd.pa.flags.writeable and not rnd.key_index.flags.writeable
    got = spgemm_sharded(a, b, devices=["cpu"] * 2, plan=plan, round_size=2)
    assert _same(got, engine.spgemm_device(a, b, device="cpu").to_host())


def test_each_shard_of_each_round_is_one_counted_fold():
    a, b = (_port(m) for m in _pair("full", seed=12, dim=16))
    rounds = len(engine.plan(a, b).rowshard_rounds(4))
    seen = []

    def fold(a_slab, b_slab, pa, pb, **kw):
        seen.append((a_slab.device.type, pa.shape, pb.shape))
        return engine.KERNELS.exact(a_slab, b_slab, pa, pb, **kw)

    before = ENGINE.counter_snapshot().get("rowshard_round", 0)
    got = spgemm_sharded(a, b, devices=["cpu"] * 3, round_size=4,
                         folds=engine.Folds(exact=fold))
    assert ENGINE.counter_snapshot().get("rowshard_round", 0) - before == 3 * rounds
    assert len(seen) == 3 * rounds and {s[0] for s in seen} == {"cpu"}
    # every round's shards share one row count: the keys padded to a multiple of 3
    assert all(pa == pb and pa[0] * 3 >= 1 for _, pa, pb in seen)
    assert _same(got, engine.spgemm_device(a, b, device="cpu").to_host())


def test_device_operands_are_fetched_and_the_chain_runs_sharded():
    """A DeviceBlockMatrix operand is fetched first; a chain through the
    sharded multiply gives the JAX chain's bytes through its own."""
    mats = random_chain(5, 10, 4, 0.4, np.random.default_rng(21), "full")
    port = [_port(m) for m in mats]
    dev = DeviceBlockMatrix.from_host(port[0], "cpu")
    assert _same(spgemm_sharded(dev, port[1], devices=["cpu"] * 2),
                 spgemm_sharded(port[0], port[1], devices=["cpu"] * 2))
    with contextlib.redirect_stdout(io.StringIO()):
        got = chain_product(port, device="cpu",
                            multiply=partial(spgemm_sharded, devices=["cpu"] * 3))
        want = jax_chain_product(mats, multiply=partial(jax_sharded, mesh=default_mesh(3)))
        plain = chain_product(port, device="cpu")
    assert _same(got, want) and _same(got, plain)


def test_a_cuda_device_without_a_card_raises_and_nothing_runs_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    a, b = (_port(m) for m in _pair("full"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        spgemm_sharded(a, b, devices=["cuda:0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spgemm_sharded(a, b)  # the default devices are the visible cards
    with pytest.raises(ValueError, match="tile size"):
        spgemm_sharded(a, _port(random_block_sparse(12, 12, 2, 0.4, np.random.default_rng(1))),
                       devices=["cpu"])


def test_the_device_lists_of_slices(monkeypatch):
    pool = mesh.slice_pool("1x2+1", 3)
    assert mesh.slice_devices(pool[0], "cpu") == [torch.device("cpu")] * 2
    assert mesh.slice_device_names(pool[0], "cuda") == ["cuda:0", "cuda:1"]
    assert mesh.slice_device_names(pool[1], "cuda") == ["cuda:2"]
    assert mesh.default_devices(device_type="cpu") == [torch.device("cpu")]
    assert mesh.default_devices(4, device_type="cpu") == [torch.device("cpu")] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.slice_devices(pool[0]) == [torch.device("cuda:0"), torch.device("cuda:1")]
    assert mesh.default_devices() == [torch.device("cuda:0"), torch.device("cuda:1")]
    # a position past the visible cards is refused, as in the JAX package
    with pytest.raises(mesh.SliceSpecError, match="position 2 but only 2 devices"):
        mesh.slice_devices(pool[1])
    with pytest.raises(mesh.SliceSpecError, match="only 2 devices"):
        mesh.default_devices(3)


def _cli(module, folder, cwd, *extra):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-m", module, folder, *extra], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("name", ["golden_chain", "golden_wrap"])
def test_cli_shard_keys_writes_the_golden_and_jax_cli_bytes(name, tmp_path):
    folder = os.path.join(DATA, name)
    port = _cli("spgemm_tpu_torch.cli", folder, tmp_path, "--shard", "keys", "--device", "cpu",
                "--output", "port.matrix")
    assert port.returncode == 0, port.stderr
    ref = _cli("spgemm_tpu.cli", folder, tmp_path, "--shard", "keys", "--device", "cpu",
               "--output", "jax.matrix")
    assert ref.returncode == 0, ref.stderr
    got = (tmp_path / "port.matrix").read_bytes()
    with open(os.path.join(DATA, f"{name}_expected_matrix"), "rb") as f:
        assert got == f.read()
    assert got == (tmp_path / "jax.matrix").read_bytes()
    assert port.stdout.splitlines()[:-1] == ref.stdout.splitlines()[:-1]


def _run_port(folder, out, *extra) -> tuple[bytes, str]:
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        assert port_cli.run([folder, "--device", "cpu", "--output", str(out), *extra]) == 0
    return out.read_bytes(), err.getvalue()


def test_cli_shard_keys_with_ranks_stream_and_backends(tmp_path):
    """--ranks works with --shard keys (the bytes at P); --stream and
    --out-of-core are noted on stderr and change nothing; the sharded fold
    is the exact one, which hybrid gives too, and --backend mxu, whose
    field-mode bytes differ from it, is refused (the JAX CLI drops the
    backend there without a word)."""
    folder = os.path.join(DATA, "golden_wrap")
    ranks, _ = _run_port(folder, tmp_path / "r.matrix", "--ranks", "2")
    ranks_keys, _ = _run_port(folder, tmp_path / "rk.matrix", "--ranks", "2", "--shard", "keys")
    assert ranks_keys == ranks
    plain, _ = _run_port(folder, tmp_path / "p.matrix")
    streamed, err = _run_port(folder, tmp_path / "s.matrix", "--shard", "keys", "--stream")
    assert streamed == plain and "--shard keys already keeps chain partials" in err
    hybrid, _ = _run_port(folder, tmp_path / "hybrid.matrix", "--shard", "keys",
                          "--backend", "hybrid")
    assert hybrid == plain
    field, _ = _run_port(folder, tmp_path / "field.matrix", "--backend", "mxu")
    assert field != plain  # golden_wrap's products wrap: field mode gives other bytes
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as exc:
        port_cli.run([folder, "--device", "cpu", "--output", str(tmp_path / "m.matrix"),
                      "--shard", "keys", "--backend", "mxu"])
    assert exc.value.code == 2 and "--backend mxu's field-mode bytes" in err.getvalue()
    assert not (tmp_path / "m.matrix").exists()
    none, _ = _run_port(folder, tmp_path / "n.matrix", "--shard", "none")
    assert none == plain
