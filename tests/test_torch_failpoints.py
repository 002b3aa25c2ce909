"""The port's failpoint registry (spgemm_tpu_torch/utils/failpoints.py):
spec parsing and arming equal to the JAX package's, each kind, the count
budget, the seeded probability (the same trigger sequence as the JAX
package for the same spec), and one test per site wired in the engine:
plan.build, plan.ensure_exact, kernel.dispatch, delta.diff, delta.splice,
warm.load and warm.flush.  (The serve.* sites are driven in
tests/test_torch_serve.py.)  Inputs from numpy seeds at small sizes;
results are compared exactly."""

import contextlib
import io
import threading

import numpy as np
import pytest

from spgemm_tpu.utils import failpoints as jax_failpoints
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops import delta, plancache, warmstore
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.ops.spgemm import execute, plan, spgemm_device
from spgemm_tpu_torch.utils import failpoints
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import banded_block_sparse
from spgemm_tpu_torch.utils.timers import ENGINE


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("SPGEMM_TPU_FAILPOINTS", raising=False)
    for mod in (failpoints, jax_failpoints, plancache, delta):
        mod.clear()
    warmstore.reset()
    yield
    monkeypatch.delenv("SPGEMM_TPU_FAILPOINTS", raising=False)
    for mod in (failpoints, jax_failpoints, plancache, delta):
        mod.clear()
    warmstore.reset()


def _pair(seed=700, n=40):
    rng = np.random.default_rng(seed)
    return banded_block_sparse(n, 2, 2, rng), banded_block_sparse(n, 2, 3, rng)


# ------------------------------------------------------------- the registry --
def test_the_registry_is_the_jax_registry_without_the_tuner():
    # the tuner's site is the port's too since tune/ was ported (the name
    # is kept from before)
    assert set(failpoints.REGISTRY) == set(jax_failpoints.REGISTRY)
    for name, fp in failpoints.REGISTRY.items():
        assert fp.kind == jax_failpoints.REGISTRY[name].kind, name


@pytest.mark.parametrize("spec", [
    "plan.build", "warm.load:0.5", "delta.diff::3", "serve.executor:1:1,warm.load:0.25",
    " kernel.dispatch : 1 : 2 ,, serve.accept", "serve.heartbeat:0:1",
])
def test_a_spec_arms_what_the_jax_registry_arms(spec, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", spec)
    assert failpoints.armed() == jax_failpoints.armed()


@pytest.mark.parametrize("spec", [
    "no.such.point", "plan.build:2", "plan.build:x", "plan.build:1:0", "plan.build:1:1:1",
    "plan.build:1:y", "tune.trial:2",
])
def test_a_bad_spec_raises_at_every_check(spec, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", spec)
    for _ in range(2):  # a bad spec never caches as "armed nothing"
        with pytest.raises(ValueError, match="SPGEMM_TPU_FAILPOINTS"):
            failpoints.check("plan.build")


def test_an_unregistered_name_at_a_site_is_a_key_error():
    with pytest.raises(KeyError):
        failpoints.check("not.a.site")


def test_unarmed_checks_do_nothing():
    assert not any(failpoints.check(name) for name in failpoints.REGISTRY
                   if failpoints.REGISTRY[name].kind != "raise")
    failpoints.check("plan.build")
    assert failpoints.triggered() == {}


# ------------------------------------------------------------------ kinds --
def test_raise_corrupt_and_delay(monkeypatch):
    monkeypatch.setattr(failpoints, "DELAY_S", 0.0)
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "plan.build,warm.load,serve.accept")
    with pytest.raises(failpoints.FailpointTriggered) as ei:
        failpoints.check("plan.build")
    assert ei.value.point == "plan.build"
    assert failpoints.check("warm.load") is True
    assert failpoints.check("serve.accept") is False
    assert failpoints.triggered() == {"plan.build": 1, "warm.load": 1, "serve.accept": 1}


def test_hang_holds_until_disarmed(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "serve.heartbeat")
    entered, left = threading.Event(), threading.Event()

    def site():
        entered.set()
        failpoints.check("serve.heartbeat")
        left.set()

    t = threading.Thread(target=site, daemon=True)
    t.start()
    assert entered.wait(30)
    assert not left.wait(0.3)  # held while the spec names it
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "plan.build")  # disarmed
    assert left.wait(30)
    t.join(30)


def test_the_count_budget(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "delta.diff:1:2")
    assert [failpoints.check("delta.diff") for _ in range(5)] == [True, True, False, False,
                                                                  False]
    assert failpoints.armed()["delta.diff"]["remaining"] == 0
    assert failpoints.triggered() == {"delta.diff": 2}


@pytest.mark.parametrize("spec", ["warm.load:0.3", "warm.load:0.5:7",
                                  "delta.diff:0.7,warm.load:0.1"])
def test_the_seeded_probability_replays_the_jax_sequence(spec, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", spec)
    got = [failpoints.check("warm.load") for _ in range(64)]
    want = [jax_failpoints.check("warm.load") for _ in range(64)]
    assert got == want and 0 < sum(got) < 64
    failpoints.clear()  # the same spec again replays the same sequence
    assert [failpoints.check("warm.load") for _ in range(64)] == got


# ------------------------------------------------------- the engine's sites --
def test_plan_build(monkeypatch):
    a, b = _pair()
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "plan.build:1:1")
    with pytest.raises(failpoints.FailpointTriggered):
        plan(a, b)
    plan(a, b)  # the budget is spent: the next plan builds


def test_plan_ensure_exact(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "1")
    a = banded_block_sparse(90, 2, 2, np.random.default_rng(701))
    p = plan(a, a)
    assert p.is_deferred
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "plan.ensure_exact:1:1")
    with pytest.raises(failpoints.FailpointTriggered):
        p.ensure_exact()
    assert p.is_deferred  # nothing half-built
    p.ensure_exact()
    assert not p.is_deferred


def test_kernel_dispatch(monkeypatch):
    a, b = _pair()
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    p = plan(a, b)
    da, db = DeviceBlockMatrix.from_host(a, "cpu"), DeviceBlockMatrix.from_host(b, "cpu")
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "kernel.dispatch:1:1")
    with pytest.raises(failpoints.FailpointTriggered):
        execute(p, da, db)
    want = execute(p, da, db).to_host()
    got = spgemm_device(a, b, device="cpu").to_host()
    assert np.array_equal(got.coords, want.coords) and np.array_equal(got.tiles, want.tiles)


def _edited(m: BlockSparseMatrix, row: int) -> BlockSparseMatrix:
    tiles = m.tiles.copy()
    tiles[m.coords[:, 0] == row] ^= np.uint64(0x9E3779B97F4A7C15)
    return BlockSparseMatrix(rows=m.rows, cols=m.cols, k=m.k, coords=m.coords, tiles=tiles)


def test_delta_diff_takes_the_counted_full_fallback(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "1")
    a, b = _pair()
    first = spgemm_device(a, b, device="cpu").to_host()
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "delta.diff")
    ENGINE.reset()
    again = spgemm_device(a, b, device="cpu").to_host()
    assert ENGINE.counters["delta_full_fallbacks"] == 1
    assert delta.stats()["fallback_reasons"].get("provenance_mismatch", 0) >= 1
    assert np.array_equal(again.tiles, first.tiles)


def test_delta_splice_raises_and_the_next_submit_is_right(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "1")
    a, b = _pair()
    spgemm_device(a, b, device="cpu")
    a2 = _edited(a, 3)
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "delta.splice:1:1")
    with pytest.raises(failpoints.FailpointTriggered):
        spgemm_device(a2, b, device="cpu")
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    want = spgemm_device(a2, b, device="cpu").to_host()
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "1")
    got = spgemm_device(a2, b, device="cpu").to_host()
    assert np.array_equal(got.coords, want.coords) and np.array_equal(got.tiles, want.tiles)


def test_warm_load_is_a_counted_cold_path(tmp_path, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", str(tmp_path / "warm"))
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    a, b = _pair()
    want = plan(a, b)  # written through to the warm dir
    plancache.clear()
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "warm.load:1:1")
    ENGINE.reset()
    got = plan(a, b)
    assert ENGINE.counters.get("warm_corrupt") == 1 and warmstore.stats()["corrupt"] == 1
    assert np.array_equal(got.take, want.take)


def test_warm_flush_never_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", str(tmp_path / "warm"))
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "1")
    with contextlib.redirect_stdout(io.StringIO()):
        chain_product(list(_pair()), device="cpu")
    monkeypatch.setenv("SPGEMM_TPU_FAILPOINTS", "warm.flush:1:1")
    assert warmstore.flush() == {"plans": 0, "deltas": 0, "pruned": 0}
    assert failpoints.triggered() == {"warm.flush": 1}
    assert warmstore.flush()["deltas"] >= 1  # the next flush writes what is pending
