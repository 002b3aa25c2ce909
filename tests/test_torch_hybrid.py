"""The port's hybrid and mxu backends on the CPU against the JAX package's:
the proof-split round partition, spgemm(backend="hybrid"|"mxu"), the
hybrid chain with its bound propagation, the measured speed gate and its
cache, and the CLI's --backend.  The JAX side runs with SPGEMM_TPU_DELTA=0:
its delta store keys results by structure without the operand dims
(ROADMAP.md, faults).  Tolerance: exact (byte equality)."""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from spgemm_tpu.chain import chain_product as jax_chain_product
from spgemm_tpu.ops import symbolic as jax_sym
from spgemm_tpu.ops.spgemm import spgemm as jax_spgemm
from spgemm_tpu.utils import io_text as jax_io
from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxMatrix
from spgemm_tpu.utils.gen import banded_block_sparse, random_block_sparse, random_chain
from spgemm_tpu.utils.semantics import chain_oracle, spgemm_oracle
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops import crossover
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.ops import symbolic as sym
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.ops.mxu_spgemm import safe_exact_bound
from spgemm_tpu_torch.ops.spgemm import plan, spgemm, spgemm_device
from spgemm_tpu_torch.utils import semantics
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
MAX = (1 << 64) - 1


@pytest.fixture(autouse=True)
def _jax_delta_off(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    monkeypatch.delenv("SPGEMM_TPU_HYBRID_GATE", raising=False)


def _port(m):
    return BlockSparseMatrix.from_reference(m)


def _same(port_m, jax_m):
    return (port_m.rows, port_m.cols, port_m.k) == (jax_m.rows, jax_m.cols, jax_m.k) \
        and np.array_equal(port_m.coords, jax_m.coords) \
        and np.array_equal(port_m.tiles, jax_m.tiles)


def _routes(caplog, logger: str) -> list[tuple[int, int]]:
    """(rounds on the limb kernel, rounds) per multiply, from a package's
    `spgemm[hybrid mxu=a/b ...]` log lines."""
    out = []
    for rec in caplog.records:
        msg = rec.getMessage()
        if rec.name == logger and msg.startswith("spgemm[hybrid mxu="):
            a, b = msg[len("spgemm[hybrid mxu="):].split()[0].rstrip("]:").split("/")
            out.append((int(a), int(b)))
    return out


def _structures():
    rng = np.random.default_rng(21)
    out = {"random": (random_block_sparse(12, 12, 2, 0.3, rng), random_block_sparse(12, 12, 2, 0.3, rng)),
           "banded": (banded_block_sparse(40, 2, 3, rng), banded_block_sparse(40, 2, 2, rng))}
    hub = np.concatenate([np.stack([np.zeros(64, np.int64), np.arange(64)], 1),
                          np.array([[5, 3], [9, 60]])])
    out["hub"] = (hub[np.lexsort((hub[:, 1], hub[:, 0]))],
                  np.stack([np.arange(64), np.arange(64) % 7], 1))
    return {name: tuple(getattr(m, "coords", m) for m in pair) for name, pair in out.items()}


STRUCTURES = _structures()


@pytest.mark.parametrize("split", [0, 1, 3, 5, 40])
@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_split_partition_matches_jax(name, split):
    a, b = STRUCTURES[name]
    join = sym.symbolic_join(a, b)
    got = sym.plan_rounds(join, len(a), len(b), key_cap=8192, split_fanout=split)
    want = jax_sym.plan_rounds(jax_sym.symbolic_join(a, b), a_sentinel=len(a),
                               b_sentinel=len(b), round_size=None, batch=True,
                               split_fanout=split, route="ladder")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.key_index, w.key_index)
        assert np.array_equal(g.pa, w.pa) and np.array_equal(g.pb, w.pb)
        assert g.max_fanout == w.max_fanout
        fans = join.fanouts[g.key_index]
        assert (fans <= split).all() or (fans > split).all()  # one side of the split


@pytest.mark.parametrize("seed,k,dim", [(1, 2, 6), (2, 4, 5), (3, 1, 9)])
def test_hybrid_small_values_all_limb_kernel(seed, k, dim, caplog):
    caplog.set_level(logging.INFO)
    rng = np.random.default_rng(seed)
    a = random_block_sparse(dim, dim, k, 0.5, rng, "small")
    b = random_block_sparse(dim, dim, k, 0.5, rng, "small")
    before = dict(engine.rounds_by_kernel)
    got = spgemm(_port(a), _port(b), device="cpu", backend="hybrid")
    n_mxu = engine.rounds_by_kernel["mxu"] - before["mxu"]
    assert engine.rounds_by_kernel["mod"] == before["mod"]
    want = jax_spgemm(a, b, backend="hybrid")
    assert _same(got, want)
    assert _same(got, JaxMatrix.from_dict(a.rows, b.cols, k, spgemm_oracle(a.to_dict(), b.to_dict(), k)))
    (port_mxu, port_rounds), = _routes(caplog, "spgemm_tpu_torch.spgemm")
    (jax_mxu, jax_rounds), = _routes(caplog, "spgemm_tpu.spgemm")
    assert port_mxu == port_rounds == n_mxu > 0
    assert jax_mxu == jax_rounds


@pytest.mark.parametrize("seed", [4, 5])
def test_hybrid_full_values_never_limb_kernel(seed, caplog):
    caplog.set_level(logging.INFO)
    rng = np.random.default_rng(seed)
    a = random_block_sparse(6, 6, 2, 0.5, rng, "adversarial")
    b = random_block_sparse(6, 6, 2, 0.5, rng, "full")
    got = spgemm(_port(a), _port(b), device="cpu", backend="hybrid")
    assert _same(got, jax_spgemm(a, b, backend="hybrid"))
    assert _same(got, JaxMatrix.from_dict(a.rows, b.cols, 2, spgemm_oracle(a.to_dict(), b.to_dict(), 2)))
    assert [m for m, _ in _routes(caplog, "spgemm_tpu_torch.spgemm")] == [0]
    assert [m for m, _ in _routes(caplog, "spgemm_tpu.spgemm")] == [0]


@pytest.mark.parametrize("dist", ["small", "full"])
def test_mxu_backend_matches_field_oracle_and_jax(dist):
    rng = np.random.default_rng(6)
    mats = random_chain(3, 5, 2, 0.5, rng, dist)
    got = chain_product([_port(m) for m in mats], device="cpu", backend="mxu")
    dicts = [m.to_dict() for m in mats]
    field = semantics.chain_oracle(dicts, 2, semantics.field_spgemm_oracle)
    assert got == BlockSparseMatrix.from_dict(mats[0].rows, mats[-1].cols, 2, field)
    assert _same(got, jax_chain_product(mats, backend="mxu"))
    if dist == "full":  # field mode is not the reference's fold on wrapping values
        assert got != BlockSparseMatrix.from_dict(mats[0].rows, mats[-1].cols, 2,
                                                  chain_oracle(dicts, 2))


def test_hybrid_chain_matches_jax_and_oracle(caplog):
    """A 4-matrix small-valued chain: level 1 is proven and runs the limb
    kernel, its propagated bound fails the proof at level 2."""
    caplog.set_level(logging.INFO)
    mats = random_chain(4, 6, 2, 0.5, np.random.default_rng(7), "small")
    got = chain_product([_port(m) for m in mats], device="cpu", backend="hybrid")
    want = jax_chain_product(mats, backend="hybrid")
    assert _same(got, want)
    oracle = chain_oracle([m.to_dict() for m in mats], 2)
    assert _same(got, JaxMatrix.from_dict(mats[0].rows, mats[-1].cols, 2, oracle))
    for logger in ("spgemm_tpu_torch.spgemm", "spgemm_tpu.spgemm"):
        (l1a, r1a), (l1b, r1b), (l2, r2) = _routes(caplog, logger)
        assert l1a == r1a > 0 and l1b == r1b > 0 and l2 == 0 < r2, logger


def test_val_bound_is_lazy_exact_and_propagated():
    rng = np.random.default_rng(8)
    a = _port(random_block_sparse(5, 5, 2, 0.5, rng, "small"))
    b = _port(random_block_sparse(5, 5, 2, 0.5, rng, "small"))
    da, db = DeviceBlockMatrix.from_host(a, "cpu"), DeviceBlockMatrix.from_host(b, "cpu")
    assert da.val_bound is None  # nothing read yet
    assert da.bound() == int(a.tiles.max()) and db.bound() == int(b.tiles.max())
    proven = spgemm_device(da, db, device="cpu", backend="hybrid")
    p = plan(da, db, backend="hybrid")
    want = safe_exact_bound(da.bound(), db.bound(), int(p.join.fanouts.max()), 2)
    assert proven.val_bound == want
    assert spgemm_device(da, db, device="cpu").val_bound == MAX - 1  # exact: not proven
    assert spgemm_device(proven, proven, device="cpu", backend="hybrid").val_bound == MAX - 1
    assert DeviceBlockMatrix.empty(4, 4, 2, "cpu").bound() == 0


def test_proven_round_too_deep_for_limb_kernel_runs_no_mod(monkeypatch):
    monkeypatch.setattr(engine, "MAX_PAIR_DEPTH", 1)  # every round: P * k >= 2 > 1
    rng = np.random.default_rng(9)
    a = _port(random_block_sparse(6, 6, 2, 0.6, rng, "small"))
    b = _port(random_block_sparse(6, 6, 2, 0.6, rng, "small"))
    before = dict(engine.rounds_by_kernel)
    got = spgemm(a, b, device="cpu", backend="hybrid")
    used = {n: engine.rounds_by_kernel[n] - before[n] for n in before}
    assert used["mxu"] == 0 and used["mod"] == 0 and used["no_mod"] > 0
    assert got == spgemm(a, b, device="cpu")


def test_gate_policy(monkeypatch):
    assert crossover.gate_policy("cpu") == "proof"
    assert crossover.gate_policy("cuda") == "auto"
    monkeypatch.setenv("SPGEMM_TPU_HYBRID_GATE", "proof")
    assert crossover.gate_policy("cuda") == "proof"
    monkeypatch.setenv("SPGEMM_TPU_HYBRID_GATE", "fast")
    with pytest.raises(ValueError, match="SPGEMM_TPU_HYBRID_GATE"):
        crossover.gate_policy("cpu")


@pytest.mark.parametrize("winner", ["mxu", "no_mod"])
def test_auto_gate_routes_to_measured_winner_and_caches_by_path(winner, monkeypatch, tmp_path):
    monkeypatch.setenv("SPGEMM_TPU_HYBRID_GATE", "auto")
    monkeypatch.setenv("SPGEMM_TPU_CROSSOVER_CACHE", str(tmp_path / "one"))
    timed = []

    def fake_time(fn, args, device, repeats=2):
        kernel = "no_mod" if fn.keywords.get("no_mod") else "mxu"
        timed.append(kernel)
        return 1.0 if kernel == winner else 2.0

    monkeypatch.setattr(crossover, "_time_call", fake_time)
    rng = np.random.default_rng(10)
    a = _port(random_block_sparse(6, 6, 2, 0.5, rng, "small"))
    b = _port(random_block_sparse(6, 6, 2, 0.5, rng, "small"))
    before = dict(engine.rounds_by_kernel)
    got = spgemm(a, b, device="cpu", backend="hybrid")
    used = {n: engine.rounds_by_kernel[n] - before[n] for n in before}
    assert got == spgemm(a, b, device="cpu")
    assert used["mod"] == 0 and used[winner] > 0 and sum(used.values()) == used[winner]
    entries = crossover.entries()
    assert timed and len(timed) == 2 * len(entries)
    assert all(key.startswith("v3:cpu:l3x3:k2:") for key in entries)
    assert os.path.exists(tmp_path / "one" / crossover.CACHE_FILE)
    # a second run reads the cache: nothing is measured again
    spgemm(a, b, device="cpu", backend="hybrid")
    assert len(timed) == 2 * len(entries)
    # another cache path starts empty and measures anew
    monkeypatch.setenv("SPGEMM_TPU_CROSSOVER_CACHE", str(tmp_path / "two"))
    assert crossover.entries() == {}
    spgemm(a, b, device="cpu", backend="hybrid")
    assert len(timed) == 4 * len(entries)


def test_auto_gate_does_not_read_entries_timed_on_the_earlier_kernel(monkeypatch, tmp_path):
    """A cache written before kernel 1 skipped sentinel slots holds v1 keys,
    one written before the limb kernel moved to byte limbs and skipped them
    v2 keys; the gate measures anew under v3 keys and keeps the old entries."""
    monkeypatch.setenv("SPGEMM_TPU_HYBRID_GATE", "auto")
    monkeypatch.setenv("SPGEMM_TPU_CROSSOVER_CACHE", str(tmp_path))
    timed = []

    def fake_time(fn, args, device, repeats=2):
        timed.append(fn)
        return 1.0 if fn.keywords.get("no_mod") else 2.0  # no_mod wins now

    monkeypatch.setattr(crossover, "_time_call", fake_time)
    rng = np.random.default_rng(12)
    a = _port(random_block_sparse(6, 6, 2, 0.5, rng, "small"))
    b = _port(random_block_sparse(6, 6, 2, 0.5, rng, "small"))
    keys = [crossover.cache_key("cpu", 3, 3, 2, K, P) for K in (1, 2, 4, 8, 16) for P in
            (1, 2, 3, 4, 6, 8)]
    assert all(key.startswith("v3:") for key in keys)
    old = {version + key.removeprefix("v3"): {"exact_s": 2.0, "mxu_s": 1.0}
           for key in keys for version in ("v1", "v2")}
    (tmp_path / crossover.CACHE_FILE).write_text(json.dumps(old))
    before = dict(engine.rounds_by_kernel)
    got = spgemm(a, b, device="cpu", backend="hybrid")
    used = {n: engine.rounds_by_kernel[n] - before[n] for n in before}
    assert got == spgemm(a, b, device="cpu")
    assert timed and used["mxu"] == 0 and used["no_mod"] > 0
    entries = json.loads((tmp_path / crossover.CACHE_FILE).read_text())
    assert set(old) <= set(entries)
    new = [key for key in entries if key.startswith("v3:")]
    assert new and len(timed) == 2 * len(new)


def test_unknown_backend_raises():
    m = _port(random_block_sparse(3, 3, 2, 0.5, np.random.default_rng(11)))
    with pytest.raises(ValueError, match="backend"):
        spgemm(m, m, device="cpu", backend="pallas")


def _cli(module, folder, cwd, *extra):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", "SPGEMM_TPU_DELTA": "0"}
    return subprocess.run([sys.executable, "-m", module, folder, "--device", "cpu", *extra],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("backend", ["hybrid", "mxu"])
@pytest.mark.parametrize("data", ["small_chain", "golden_chain"])
def test_cli_backend_matches_jax_cli(backend, data, tmp_path):
    if data == "small_chain":
        folder = str(tmp_path / "in")
        mats = random_chain(4, 6, 4, 0.4, np.random.default_rng(12), "small")
        jax_io.write_chain_dir(folder, mats, 4)
    else:
        folder = os.path.join(DATA, data)
    port = _cli("spgemm_tpu_torch.cli", folder, tmp_path, "--backend", backend,
                "--output", "port.matrix")
    assert port.returncode == 0, port.stderr
    ref = _cli("spgemm_tpu.cli", folder, tmp_path, "--backend", backend,
               "--output", "jax.matrix")
    assert ref.returncode == 0, ref.stderr
    got = (tmp_path / "port.matrix").read_bytes()
    assert got == (tmp_path / "jax.matrix").read_bytes()
    assert port.stdout.splitlines()[:-1] == ref.stdout.splitlines()[:-1]
    if backend == "hybrid":
        exact = _cli("spgemm_tpu_torch.cli", folder, tmp_path, "--output", "exact.matrix")
        assert exact.returncode == 0, exact.stderr
        assert got == (tmp_path / "exact.matrix").read_bytes()


def test_exact_default_launches_only_mod_fold():
    mats = [_port(m) for m in random_chain(3, 5, 2, 0.5, np.random.default_rng(13), "small")]
    before = dict(engine.rounds_by_kernel)
    chain_product(mats, device="cpu")
    assert engine.rounds_by_kernel["no_mod"] == before["no_mod"]
    assert engine.rounds_by_kernel["mxu"] == before["mxu"]
    assert engine.rounds_by_kernel["mod"] > before["mod"]
