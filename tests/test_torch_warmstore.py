"""The persistent warm store in the port (spgemm_tpu_torch/ops/warmstore.py,
the plan codec of ops/symbolic.py, the CLI's `warm` subcommand): a plan and
a delta entry written by one process are read back and used by a fresh one
with the same bytes; a corrupt entry, a codec skew and a file the JAX
package wrote are counted and take the cold path.  Inputs from numpy seeds
at small sizes.  Tolerance: exact (bytes)."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from spgemm_tpu.ops import plancache as jax_plancache
from spgemm_tpu.ops import warmstore as jax_warmstore
from spgemm_tpu.ops.spgemm import plan as jax_plan
from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxBSM
from spgemm_tpu_torch import cli
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops import delta, plancache, symbolic, warmstore
from spgemm_tpu_torch.ops.spgemm import plan
from spgemm_tpu_torch.utils.gen import banded_block_sparse
from spgemm_tpu_torch.utils.timers import ENGINE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    for mod in (warmstore, jax_warmstore):
        mod.reset()
    plancache.clear()
    delta.clear()
    monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", str(tmp_path / "warm"))
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "1")
    yield
    for mod in (warmstore, jax_warmstore):
        mod.reset()
    plancache.clear()
    delta.clear()


def _pair(seed=500, n=60):
    rng = np.random.default_rng(seed)
    return banded_block_sparse(n, 2, 2, rng), banded_block_sparse(n, 2, 3, rng)


def _plan_arrays(p):
    yield from (p.join.keys, p.join.pair_ptr, p.join.pair_a, p.join.pair_b, p.take,
                p.a_coords, p.b_coords)
    for r in p.rounds:
        yield from (r.key_index, r.pa, r.pb)


def _same_plan(x, y) -> bool:
    return (x.k, x.backend, x.split_fanout, x.key_cap, len(x.rounds)) == \
        (y.k, y.backend, y.split_fanout, y.key_cap, len(y.rounds)) \
        and [r.max_fanout for r in x.rounds] == [r.max_fanout for r in y.rounds] \
        and all(u.dtype == v.dtype and np.array_equal(u, v)
                for u, v in zip(_plan_arrays(x), _plan_arrays(y), strict=True))


# ---------------------------------------------------------------- the codec --
@pytest.mark.parametrize("backend", ["exact", "hybrid", "mxu"])
def test_plan_codec_round_trips(backend, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "0")
    a, b = _pair()
    p = plan(a, b, backend=backend, round_size=50)
    back = symbolic.plan_from_arrays(symbolic.plan_to_arrays(p), fingerprint=p.fingerprint)
    assert _same_plan(p, back) and back.fingerprint == p.fingerprint


def test_plan_codec_refuses_a_deferred_plan_a_skew_and_the_jax_format(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "1")  # a deferred plan
    a, b = _pair()
    deferred = plan(a, b)
    assert deferred.is_deferred and symbolic.plan_to_arrays(deferred) is None
    arrays = symbolic.plan_to_arrays(deferred.ensure_exact())
    with pytest.raises(ValueError, match="codec"):
        symbolic.plan_from_arrays({**arrays, "codec": np.int64(99)})
    from spgemm_tpu.ops.symbolic import plan_to_arrays as jax_plan_to_arrays

    monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE", "1")
    jax_p = jax_plan(JaxBSM(rows=a.rows, cols=a.cols, k=2, coords=a.coords, tiles=a.tiles),
                     JaxBSM(rows=b.rows, cols=b.cols, k=2, coords=b.coords, tiles=b.tiles),
                     backend="xla", platform="cpu").ensure_exact()
    with pytest.raises(ValueError, match="codec"):
        symbolic.plan_from_arrays(jax_plan_to_arrays(jax_p))


# ------------------------------------------------------------ in one process --
def test_a_plan_is_written_through_and_read_back(tmp_path, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "1")  # a deferred plan
    a, b = _pair()
    p = plan(a, b).ensure_exact()  # deferred: not written yet
    assert warmstore.stats()["plans"] == 0
    assert warmstore.flush()["plans"] == 1
    plancache.clear()
    ENGINE.reset()
    q = plan(a, b)
    assert q is not p and _same_plan(p, q) and not q.is_deferred
    assert ENGINE.counters["warm_hits"] == 1 and ENGINE.counters["plan_cache_misses"] == 1
    assert not q.join.keys.flags.writeable  # cached: frozen like any other
    assert warmstore.stats()["plan_hits"] == 1


def test_an_exact_plan_is_written_at_once(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "0")
    plan(*_pair())
    assert warmstore.stats()["plans"] == 1 and warmstore.stats()["saved_plans"] == 1


def test_warm_off_and_no_dir_persist_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("SPGEMM_TPU_WARM", "0")
    plan(*_pair()).ensure_exact()
    assert warmstore.flush() == {"plans": 0, "deltas": 0, "pruned": 0}
    assert not os.path.exists(tmp_path / "warm")
    monkeypatch.setenv("SPGEMM_TPU_WARM", "1")
    monkeypatch.delenv("SPGEMM_TPU_WARM_DIR")
    warmstore.reset()
    assert not warmstore.active() and warmstore.flush()["plans"] == 0


def _entry_path(kind: str) -> str:
    d = warmstore.directory()
    names = [n for n in os.listdir(d) if n.startswith(kind + "-")]
    assert len(names) == 1, names
    return os.path.join(d, names[0])


@pytest.mark.parametrize("damage", ["truncate", "skew", "identity", "jax_file"])
def test_a_bad_plan_entry_is_counted_and_planned_cold(damage, tmp_path, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "0")
    a, b = _pair()
    want = plan(a, b)
    path = _entry_path("plan")
    if damage == "truncate":
        with open(path, "r+b") as f:
            f.truncate(100)
    elif damage == "skew":
        with np.load(path) as z:
            payload = dict(z)
        payload["codec"] = np.int64(99)
        np.savez(path, **payload)
    elif damage == "identity":
        with np.load(path) as z:
            payload = dict(z)
        payload["ident"] = np.array("another")
        np.savez(path, **payload)
    else:  # the JAX package's entry for the same operands, at the port's name
        jax_dir = str(tmp_path / "jax_warm")
        monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", jax_dir)
        jax_plancache.clear()
        jax_warmstore.reset()
        jax_plan(JaxBSM(rows=a.rows, cols=a.cols, k=2, coords=a.coords, tiles=a.tiles),
                 JaxBSM(rows=b.rows, cols=b.cols, k=2, coords=b.coords, tiles=b.tiles),
                 backend="xla", platform="cpu")
        jax_warmstore.reset()
        [name] = [n for n in os.listdir(jax_dir) if n.startswith("plan-")]
        shutil.copyfile(os.path.join(jax_dir, name), path)
    plancache.clear()
    ENGINE.reset()
    got = plan(a, b)
    assert _same_plan(got, want)
    assert ENGINE.counters["warm_corrupt"] == 1 and warmstore.stats()["corrupt"] == 1
    assert "warm_hits" not in ENGINE.counters
    assert os.path.exists(path)  # the planner wrote a good entry in its place
    plancache.clear()
    assert _same_plan(plan(a, b), want) and warmstore.stats()["plan_hits"] == 1


def test_another_live_process_holding_the_dir_leaves_this_one_cold(tmp_path):
    import fcntl

    d = tmp_path / "warm"
    d.mkdir()
    with open(d / "lock", "a+") as holder:
        fcntl.flock(holder.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        assert warmstore.configure() is False
        assert "locked by another live process" in warmstore.disabled_reason()
        assert not warmstore.active()
        assert warmstore.scan(str(d))["locked"] is True
        with pytest.raises(RuntimeError, match="in use"):
            warmstore.clear(str(d))
    warmstore.reset()
    assert warmstore.active() and warmstore.scan(str(d))["locked"] is False


def test_the_budget_prunes_the_oldest_entries(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_WARM_MAX_MB", "1")
    assert warmstore.active()
    d = warmstore.directory()
    for i in range(3):
        with open(os.path.join(d, f"plan-{i}.npz"), "wb") as f:
            f.write(b"x" * 600_000)
        os.utime(os.path.join(d, f"plan-{i}.npz"), (i, i))
    assert warmstore.flush()["pruned"] == 2
    assert sorted(n for n in os.listdir(d) if n.endswith(".npz")) == ["plan-2.npz"]


# ---------------------------------------------------- across processes --
_CHILD = """
import contextlib, hashlib, io, json, sys
import numpy as np
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops import delta, warmstore
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import banded_block_sparse
from spgemm_tpu_torch.utils.timers import ENGINE

rng = np.random.default_rng(510)
mats = []
for i in range(5):
    m = banded_block_sparse(40, 2, 2, rng)
    keep = m.coords[:, 1] + i < 40
    mats.append(BlockSparseMatrix(rows=m.rows, cols=m.cols, k=2,
                                  coords=m.coords[keep] + np.array([0, i]), tiles=m.tiles[keep]))
if sys.argv[1] == "edit":
    t = mats[2].tiles.copy()
    t[mats[2].coords[:, 0] == 7] ^= np.uint64(77)
    mats[2] = BlockSparseMatrix(rows=mats[2].rows, cols=mats[2].cols, k=2,
                                coords=mats[2].coords, tiles=t)
with contextlib.redirect_stdout(io.StringIO()):
    r = chain_product(mats, device="cpu")
version = delta._VERSION
flushed = warmstore.flush()
h = hashlib.sha256(r.coords.tobytes() + r.tiles.tobytes()).hexdigest()
print(json.dumps({"counters": ENGINE.counters, "warm": warmstore.stats(), "hash": h,
                  "flushed": flushed, "version": version}))
"""


def _child(tmp_path, what: str) -> dict:
    env = {**os.environ, "PYTHONPATH": REPO, "SPGEMM_TPU_WARM_DIR": str(tmp_path / "shared"),
           "SPGEMM_TPU_DELTA": "1"}
    env.pop("SPGEMM_TPU_PLAN_CACHE", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD, what], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


def test_a_second_process_reads_the_plans_and_delta_entries(tmp_path):
    first = _child(tmp_path, "same")
    assert first["counters"]["delta_full_fallbacks"] == 4
    # 40 block rows: below the estimator's sample, so the plans were exact
    # and written through; the delta entries wait for the flush
    assert first["flushed"] == {"plans": 0, "deltas": 4, "pruned": 0}
    assert first["warm"]["plans"] == 4 and first["warm"]["deltas"] == 4
    assert "warm_hits" not in first["counters"]
    second = _child(tmp_path, "same")
    assert second["hash"] == first["hash"]
    c = second["counters"]
    assert second["warm"]["plan_hits"] == 4 and second["warm"]["delta_hits"] == 4
    assert c["warm_hits"] == 8 and c.get("plan_cache_misses") == 4
    assert c["delta_rows_recomputed"] == 0 and "delta_full_fallbacks" not in c
    assert second["version"] > first["version"]  # fenced past the versions on disk
    third = _child(tmp_path, "edit")  # an edited leaf: the reloaded entries diff it
    c = third["counters"]
    assert 0 < c["delta_rows_recomputed"] < c["delta_rows_total"]
    assert "delta_full_fallbacks" not in c and third["hash"] != first["hash"]
    # ... and its bytes are the delta-off chain's
    env_off = {**os.environ, "PYTHONPATH": REPO, "SPGEMM_TPU_DELTA": "0",
               "SPGEMM_TPU_WARM": "0"}
    proc = subprocess.run([sys.executable, "-c", _CHILD, "edit"], env=env_off,
                          cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1])["hash"] == third["hash"]


def test_a_corrupt_delta_entry_is_counted_and_recomputed(tmp_path):
    first = _child(tmp_path, "same")
    d = tmp_path / "shared"
    for name in os.listdir(d):
        if name.startswith("delta-"):
            with open(d / name, "r+b") as f:
                f.truncate(64)
    second = _child(tmp_path, "same")
    assert second["hash"] == first["hash"]
    assert second["warm"]["corrupt"] == 4 and second["counters"]["warm_corrupt"] == 4
    assert second["counters"]["delta_full_fallbacks"] == 4


# ------------------------------------------------------------------ the CLI --
def _cli(argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.run(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_warm_stat_clear_and_clone(tmp_path, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_ESTIMATE", "0")
    plan(*_pair())
    plan(*_pair(n=50))
    src = warmstore.directory()
    warmstore.reset()  # the CLI inspects a directory no process holds
    rc, out, _ = _cli(["warm", "--json"])
    info = json.loads(out)
    assert rc == 0 and info["plans"] == 2 and info["locked"] is False
    rc, out, _ = _cli(["warm", "--stat", "--dir", src])
    assert rc == 0 and "idle" in out and "plans=2" in out
    dst = str(tmp_path / "seeded")
    with open(os.path.join(src, "plan-junk.npz"), "wb") as f:
        f.write(b"not a zip")
    rc, out, _ = _cli(["warm", "--clone", src, "--dir", dst, "--json"])
    assert rc == 0 and json.loads(out) == {"copied": 2, "skipped": 1,
                                           "skip_reasons": {"unreadable": 1}}
    rc, out, _ = _cli(["warm", "--clone", src, "--dir", dst])
    assert rc == 0 and "cloned 0 entries" in out and "exists" in out
    # the seeded directory serves a fresh process's plans
    monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", dst)
    plancache.clear()
    ENGINE.reset()
    plan(*_pair())
    assert ENGINE.counters["warm_hits"] == 1
    warmstore.reset()
    rc, out, _ = _cli(["warm", "--clear", "--dir", dst])
    assert rc == 0 and out.startswith("warm: cleared 2 entries")
    monkeypatch.delenv("SPGEMM_TPU_WARM_DIR")
    rc, _, err = _cli(["warm"])
    assert rc == 2 and "SPGEMM_TPU_WARM_DIR" in err
