"""The port's CLI (python -m spgemm_tpu_torch.cli) on the CPU against the
golden expected files and the JAX package's CLI.  Tolerance: byte equality."""

import os
import re
import subprocess
import sys

import pytest
import torch

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
