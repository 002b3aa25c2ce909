"""The port's `knobs` and `tune` subcommands (spgemm_tpu_torch/cli.py) and the
registry's live snapshot (utils/knobs.snapshot), the counterparts of the JAX
package's knobs CLI tests (tests/test_knobs.py): every knob listed with its
value, source and default, the live engine blocks beside them, the per-row
error contract, the tuned marking from the warm store's tune tier, a folder
named like the subcommand, a closed pipe; and `tune --status|--clear`
against the JAX package's output on the same records."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from spgemm_tpu.cli import run as jax_run
from spgemm_tpu.ops import warmstore as jax_warmstore
from spgemm_tpu_torch import cli
from spgemm_tpu_torch.cli import run
from spgemm_tpu_torch.ops import crossover, plancache, warmstore
from spgemm_tpu_torch.utils import io_text, knobs
from spgemm_tpu_torch.utils.gen import random_chain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    for name in ("SPGEMM_TPU_WARM_DIR", "SPGEMM_TPU_OOC_DEPTH", "SPGEMM_TPU_PLAN_AHEAD",
                 "SPGEMM_TPU_ACCUM_ROUTE", "SPGEMM_TPU_DELTA"):
        monkeypatch.delenv(name, raising=False)
    # the default warm dir is the default socket's: keep it in this test's tmp
    monkeypatch.setenv("SPGEMM_TPU_SERVE_SOCKET", str(tmp_path / "none.sock"))
    monkeypatch.setenv("SPGEMM_TPU_CROSSOVER_CACHE", str(tmp_path / "xcache"))
    knobs.clear_tuned()
    plancache.clear()
    warmstore.reset()
    yield
    knobs.clear_tuned()
    plancache.clear()
    warmstore.reset()
    jax_warmstore.reset()


def _record(d, class_key, state, vector, est=None, win=2.0):
    """One tuner record written through the port's store into d."""
    os.environ["SPGEMM_TPU_WARM_DIR"] = str(d)
    try:
        assert warmstore.save_tune(class_key, {"class_key": class_key, "state": state,
                                               "knobs": vector, "est": est or {}, "win": win})
    finally:
        del os.environ["SPGEMM_TPU_WARM_DIR"]
        warmstore.reset()


def test_snapshot_covers_registry(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_OOC_DEPTH", "4")
    rows = {r["name"]: r for r in knobs.snapshot()}
    assert set(rows) == set(knobs.REGISTRY)
    assert rows["SPGEMM_TPU_OOC_DEPTH"]["value"] == "4"
    assert rows["SPGEMM_TPU_OOC_DEPTH"]["source"] == "env"
    assert rows["SPGEMM_TPU_OOC_DEPTH"]["default"] == "2"
    assert rows["SPGEMM_TPU_ACCUM_ROUTE"]["tuned_search"] is True
    assert rows["SPGEMM_TPU_OOC_DEPTH"]["tuned_search"] is False
    knobs.set_tuned({"SPGEMM_TPU_ACCUM_ROUTE": "dense"})
    row = {r["name"]: r for r in knobs.snapshot()}["SPGEMM_TPU_ACCUM_ROUTE"]
    assert (row["value"], row["source"], row["default"]) == ("dense", "tuned", "auto")


def test_cli_knobs_subcommand(capsys, monkeypatch):
    """`knobs`: every knob listed with value and source; the searched knobs
    marked [tuned-search]."""
    monkeypatch.setenv("SPGEMM_TPU_OOC_DEPTH", "3")
    assert run(["knobs"]) == 0
    out = capsys.readouterr().out
    for name in knobs.REGISTRY:
        assert name in out
    assert "(env, default 2)" in out  # the exported out-of-core depth
    route = next(ln for ln in out.splitlines() if ln.startswith("SPGEMM_TPU_ACCUM_ROUTE "))
    assert route.endswith("(default, default auto) [tuned-search]")
    assert "[jit-static]" not in out
    for block in ("plan cache:", "estimator:", "delta:", "warm:", "profile:"):
        assert block in out


def test_cli_knobs_subcommand_json(capsys, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", "0")
    assert run(["knobs", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    rows = {r["name"]: r for r in report["knobs"]}
    assert set(rows) == set(knobs.REGISTRY)
    row = rows["SPGEMM_TPU_PLAN_AHEAD"]
    assert row["value"] == "0" and row["source"] == "env" and row["tuned_search"] is True
    cache = report["plan_cache"]
    assert {"hits", "misses", "entries", "capacity", "enabled"} <= set(cache)
    assert cache["capacity"] == 32  # the registry default
    assert {"plan_cache", "estimator", "delta", "warm", "profile"} <= set(report)
    assert report["warm"]["tunes"] == 0


def test_cli_knobs_json_reports_cache_activity(capsys):
    """The blocks are live: in-process cache traffic shows in the listing."""
    key = plancache.fingerprint(np.zeros((2, 2), "int64"), np.ones((2, 2), "int64"),
                                meta=("t",))
    assert plancache.lookup(key) is None  # one miss
    plancache.store(key, object())
    assert plancache.lookup(key) is not None  # one hit
    assert run(["knobs", "--json"]) == 0
    cache = json.loads(capsys.readouterr().out)["plan_cache"]
    assert cache["hits"] == 1 and cache["misses"] == 1 and cache["entries"] == 1


def test_snapshot_survives_invalid_values(monkeypatch):
    """An invalid env value is a per-row error, never an aborted listing;
    get() at the consuming site stays strict."""
    monkeypatch.setenv("SPGEMM_TPU_OOC_DEPTH", "bad")
    rows = {r["name"]: r for r in knobs.snapshot()}
    assert set(rows) == set(knobs.REGISTRY)
    row = rows["SPGEMM_TPU_OOC_DEPTH"]
    assert row["value"].startswith("INVALID") and "SPGEMM_TPU_OOC_DEPTH" in row["error"]
    assert "error" not in rows["SPGEMM_TPU_PLAN_AHEAD"]
    with pytest.raises(ValueError, match="SPGEMM_TPU_OOC_DEPTH"):
        knobs.get("SPGEMM_TPU_OOC_DEPTH")


def test_cli_knobs_survives_invalid_values(capsys, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", "maybe")
    monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE_CAP", "0")  # the cache block's own knob
    assert run(["knobs"]) == 0
    out = capsys.readouterr().out
    assert "INVALID" in out and "SPGEMM_TPU_ACCUM_ROUTE must be" in out
    assert "SPGEMM_TPU_FAILPOINTS" in out  # later rows still printed
    assert "entries=0/? enabled=?" in out  # the block reports in place
    assert "SPGEMM_TPU_PLAN_CACHE_CAP must be" in out.split("plan cache:")[1]


def test_cli_knobs_folder_keeps_old_meaning(tmp_path, monkeypatch, capsys):
    """A chain input directory named `knobs` still runs the chain."""
    mats = random_chain(2, 4, 2, 0.5, np.random.default_rng(7), "small")
    io_text.write_chain_dir(str(tmp_path / "knobs"), mats, 2)
    monkeypatch.chdir(tmp_path)
    assert run(["knobs", "--device", "cpu"]) == 0
    assert "time taken " in capsys.readouterr().out  # the chain ran
    assert (tmp_path / "matrix").exists()


def test_cli_knobs_scratch_dir_does_not_swallow_subcommand(tmp_path, monkeypatch, capsys):
    """Only an input directory (with the reference's `size` file) is a
    folder; an unrelated knobs/ or tune/ directory is not."""
    (tmp_path / "knobs").mkdir()
    (tmp_path / "tune").mkdir()
    monkeypatch.chdir(tmp_path)
    assert run(["knobs"]) == 0
    assert "SPGEMM_TPU_ACCUM_ROUTE" in capsys.readouterr().out
    assert run(["tune"]) == 0
    assert "class record(s)" in capsys.readouterr().out


def test_cli_tune_folder_keeps_old_meaning(tmp_path, monkeypatch, capsys):
    mats = random_chain(2, 4, 2, 0.5, np.random.default_rng(8), "small")
    io_text.write_chain_dir(str(tmp_path / "tune"), mats, 2)
    monkeypatch.chdir(tmp_path)
    assert run(["tune", "--device", "cpu"]) == 0
    assert "time taken " in capsys.readouterr().out


def test_cli_knobs_marks_the_knobs_a_persisted_override_carries(tmp_path, monkeypatch, capsys):
    """A canary or live record's knobs (and its estimator adaptation) are
    marked with their class count, read from the tune tier on disk; a
    reverted record marks nothing."""
    _record(tmp_path, "a@cpu", "live", {"SPGEMM_TPU_ACCUM_ROUTE": "dense"},
            est={"SPGEMM_TPU_EST_SAMPLE_ROWS": "24"})
    _record(tmp_path, "b@cpu", "canary", {"SPGEMM_TPU_ACCUM_ROUTE": "ladder"})
    _record(tmp_path, "c@cpu", "reverted", {})
    monkeypatch.setenv("SPGEMM_TPU_WARM_DIR", str(tmp_path))
    assert run(["knobs", "--json"]) == 0
    rows = {r["name"]: r for r in json.loads(capsys.readouterr().out)["knobs"]}
    assert rows["SPGEMM_TPU_ACCUM_ROUTE"]["tuned_classes"] == ["a@cpu", "b@cpu"]
    assert rows["SPGEMM_TPU_EST_SAMPLE_ROWS"]["tuned_classes"] == ["a@cpu"]
    assert "tuned_classes" not in rows["SPGEMM_TPU_PLAN_AHEAD"]
    assert run(["knobs"]) == 0
    out = capsys.readouterr().out
    assert "[tuned-search] [tuned: 2 class(es)]" in out


def test_cli_knobs_survives_a_closed_pipe(tmp_path):
    """`knobs | head` closing the pipe early is no error: exit 0, no
    traceback."""
    env = {**os.environ, "PYTHONPATH": REPO, "SPGEMM_TPU_WARM_DIR": str(tmp_path)}
    proc = subprocess.Popen([sys.executable, "-m", "spgemm_tpu_torch.cli", "knobs"],
                            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    proc.stdout.close()  # before the child writes anything
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0 and b"Traceback" not in err, err


def test_cli_tune_status_lists_records_as_the_jax_cli_does(tmp_path, monkeypatch, capsys):
    """`tune --status`: one line per class (state, win, vector, estimator
    adaptation), in the JAX CLI's format on the same records."""
    _record(tmp_path, "a@cpu", "live", {"SPGEMM_TPU_ACCUM_ROUTE": "dense"},
            est={"SPGEMM_TPU_EST_CONFIDENCE": "0.7"})
    _record(tmp_path, "b@cpu", "reverted", {}, win=None)
    assert run(["tune", "--dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == f"tune store {tmp_path}: 2 class record(s)"
    assert lines[1] == ("  a@cpu  [live]  win=2.0  SPGEMM_TPU_ACCUM_ROUTE=dense  "
                        "est: SPGEMM_TPU_EST_CONFIDENCE=0.7")
    assert lines[2] == "  b@cpu  [reverted]  win=-  -"
    # the JAX CLI reads the same records (scan_tunes skips no envelope)
    monkeypatch.setenv("SPGEMM_TPU_CROSSOVER_CACHE", str(tmp_path / "x"))
    assert jax_run(["tune", "--status", "--dir", str(tmp_path)]) == 0
    assert capsys.readouterr().out == out
    assert run(["tune", "--status", "--json", "--dir", str(tmp_path)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["dir"] == str(tmp_path) and report["crossover_dense"] == {}
    assert report["overrides"]["a@cpu"]["knobs"] == {"SPGEMM_TPU_ACCUM_ROUTE": "dense"}


def test_cli_tune_lists_the_dense_gate_captures(tmp_path, monkeypatch, capsys):
    """The crossover cache's `dense-v1:` entries ride the listing, read
    without the torch-importing crossover module, from the file it names."""
    cache = tmp_path / "xcache"
    monkeypatch.setenv("SPGEMM_TPU_CROSSOVER_CACHE", str(cache))
    assert os.path.dirname(crossover.cache_path()) == str(cache)
    cache.mkdir()
    entries = {"dense-v1:cpu:mod:k2:K8:P256": {"ladder_s": 0.2, "dense_s": 0.1},
               "dense-v1:cpu:mod:k2:K8:P512": {"ladder_s": 0.1, "dense_s": 0.3},
               "v3:cpu:l1x1:k2:K8:P4": {"exact_s": 1.0, "mxu_s": 2.0}}
    with open(crossover.cache_path(), "w") as f:
        json.dump(entries, f)
    assert run(["tune", "--dir", str(tmp_path / "none")]) == 0
    out = capsys.readouterr().out
    assert "crossover dense-v1 captures: 2" in out
    assert "  dense-v1:cpu:mod:k2:K8:P256  ladder=0.2s dense=0.1s -> dense" in out
    assert "  dense-v1:cpu:mod:k2:K8:P512  ladder=0.1s dense=0.3s -> ladder" in out
    assert run(["tune", "--json", "--dir", str(tmp_path / "none")]) == 0
    assert set(json.loads(capsys.readouterr().out)["crossover_dense"]) == \
        {k for k in entries if k.startswith("dense-v1:")}


def test_cli_tune_clear_leaves_plans_and_refuses_a_held_dir(tmp_path, monkeypatch, capsys):
    _record(tmp_path, "a@cpu", "live", {"SPGEMM_TPU_ACCUM_ROUTE": "dense"})
    (tmp_path / "plan-deadbeef.npz").write_bytes(b"x")
    held = subprocess.Popen([sys.executable, "-c", (
        "import fcntl, sys, time\n"
        f"f = open({str(tmp_path / 'lock')!r}, 'a+')\n"
        "fcntl.flock(f.fileno(), fcntl.LOCK_EX)\n"
        "print('held', flush=True)\n"
        "time.sleep(60)\n")], stdout=subprocess.PIPE, text=True)
    try:
        assert held.stdout.readline().strip() == "held"
        assert run(["tune", "--clear", "--dir", str(tmp_path)]) == 1
        assert "in use by a live process" in capsys.readouterr().err
    finally:
        held.kill()
        held.wait(timeout=30)
    assert run(["tune", "--clear", "--dir", str(tmp_path)]) == 0
    assert capsys.readouterr().out.startswith("tune: cleared 1 override record(s)")
    assert sorted(os.listdir(tmp_path)) == ["lock", "plan-deadbeef.npz"]


def test_cli_tune_reads_the_default_warm_dir(tmp_path, monkeypatch, capsys):
    """With no --dir and no SPGEMM_TPU_WARM_DIR: the default socket's
    <socket>.warm, the daemon's own default."""
    warm = str(tmp_path / "none.sock") + ".warm"
    _record(warm, "a@cpu", "canary", {"SPGEMM_TPU_PLAN_AHEAD": "0"})
    assert cli._tune_dir() == warm
    assert run(["tune", "--json"]) == 0
    assert list(json.loads(capsys.readouterr().out)["overrides"]) == ["a@cpu"]
