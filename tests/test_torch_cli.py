"""The port's CLI (python -m spgemm_tpu_torch.cli) on the CPU against the
golden expected files and the JAX package's CLI, with its flags: the round
size, the host-resident modes, checkpoints, the oracle backend and the
profiler.  Tolerance: byte equality."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from spgemm_tpu import cli as jax_cli
from spgemm_tpu_torch import cli as port_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
# helper2's pairing on the 3-matrix golden chains
PROGRESS = ["multiplying 0 1", "multiplying 0 1"]


def _run(module, folder, cwd, *extra):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-m", module, folder, *extra], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("name", ["golden_chain", "golden_wrap"])
def test_cli_matches_expected_and_jax_cli(name, tmp_path):
    folder = os.path.join(DATA, name)
    port = _run("spgemm_tpu_torch.cli", folder, tmp_path, "--device", "cpu",
                "--output", "port.matrix")
    assert port.returncode == 0, port.stderr
    ref = _run("spgemm_tpu.cli", folder, tmp_path, "--device", "cpu",
               "--output", "jax.matrix")
    assert ref.returncode == 0, ref.stderr
    got = (tmp_path / "port.matrix").read_bytes()
    with open(os.path.join(DATA, f"{name}_expected_matrix"), "rb") as f:
        assert got == f.read()
    assert got == (tmp_path / "jax.matrix").read_bytes()
    port_lines, ref_lines = port.stdout.splitlines(), ref.stdout.splitlines()
    assert port_lines[:-1] == ref_lines[:-1] == PROGRESS
    assert re.fullmatch(r"time taken \S+ seconds", port_lines[-1])


def test_cli_default_cuda_without_card_fails_and_writes_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run("spgemm_tpu_torch.cli", os.path.join(DATA, "golden_wrap"), tmp_path)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert not (tmp_path / "matrix").exists()
    assert "time taken" not in proc.stdout


def _run_in_process(fn, folder, out, *extra) -> tuple[bytes, list[str]]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn([folder, "--device", "cpu", "--output", str(out), *extra]) == 0
    with open(out, "rb") as f:
        return f.read(), buf.getvalue().splitlines()


@pytest.mark.parametrize("round_size", ["1", "3", "512"])
@pytest.mark.parametrize("name", ["golden_chain", "golden_wrap"])
def test_round_size_keeps_bytes_and_matches_jax_cli(name, round_size, tmp_path, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    folder = os.path.join(DATA, name)
    got, lines = _run_in_process(port_cli.run, folder, tmp_path / "port", "--round-size",
                                 round_size)
    want, want_lines = _run_in_process(jax_cli.run, folder, tmp_path / "jax", "--round-size",
                                       round_size)
    with open(os.path.join(DATA, f"{name}_expected_matrix"), "rb") as f:
        assert got == want == f.read()
    assert lines[:-1] == want_lines[:-1] == PROGRESS


@pytest.mark.parametrize("flags", [["--stream"], ["--out-of-core"],
                                   ["--out-of-core", "--round-size", "1"],
                                   ["--stream", "--backend", "hybrid"],
                                   ["--checkpoint-dir", "CK"]],
                         ids=["stream", "ooc", "ooc_round1", "stream_hybrid", "checkpoint"])
def test_host_resident_modes_equal_the_default(flags, tmp_path):
    folder = os.path.join(DATA, "golden_wrap")
    flags = [str(tmp_path / "ck") if f == "CK" else f for f in flags]
    want, want_lines = _run_in_process(port_cli.run, folder, tmp_path / "default")
    got, lines = _run_in_process(port_cli.run, folder, tmp_path / "mode", *flags)
    assert got == want and lines[:-1] == want_lines[:-1] == PROGRESS
    if "--checkpoint-dir" in flags:
        assert sorted(os.listdir(tmp_path / "ck")) == ["pass_1.npz", "pass_2.npz"]


@pytest.mark.parametrize("name", ["golden_chain", "golden_wrap"])
def test_backend_oracle_equals_golden_and_needs_no_card(name, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    folder = os.path.join(DATA, name)
    out = tmp_path / "matrix"
    assert port_cli.run([folder, "--backend", "oracle", "--output", str(out)]) == 0
    with open(os.path.join(DATA, f"{name}_expected_matrix"), "rb") as f:
        assert out.read_bytes() == f.read()
    assert re.fullmatch(r"time taken \S+ seconds\n", capsys.readouterr().out)
    assert port_cli.run([folder, "--backend", "oracle", "--out-of-core", "--output",
                         str(out)]) == 0
    assert capsys.readouterr().err.startswith("--stream/--out-of-core ignored")


def test_profile_writes_a_trace_on_the_cpu(tmp_path):
    folder = os.path.join(DATA, "golden_chain")
    prof = tmp_path / "prof"
    got, _ = _run_in_process(port_cli.run, folder, tmp_path / "m", "--profile", str(prof))
    with open(os.path.join(DATA, "golden_chain_expected_matrix"), "rb") as f:
        assert got == f.read()
    (trace,) = prof.iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
