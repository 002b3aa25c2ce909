"""The port's chaos proof (serve/chaos_smoke.py) on the CPU: a short seeded
failpoint schedule against a live 2-slice daemon of the port, run as its
own process under a 180 s limit: every job bit-exact against the host
oracle or failed with a structured error, no wait past its bound, the
wedged slice reinstated with the trigger on the scrape, the torn journal
replayed and counted by a second daemon, SIGTERM drained to exit 0.
Also: the smoke fails, and never passes, where its daemon cannot start."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke(tmp_path, *args, env_extra=None, timeout=180):
    env = {**os.environ, "PYTHONPATH": REPO, "TMPDIR": str(tmp_path), **(env_extra or {})}
    env.pop("SPGEMM_TPU_FAILPOINTS", None)
    return subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.serve.chaos_smoke", *args],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("seed", ["20260804", "2"])
def test_the_chaos_smoke_passes_on_a_two_slice_cpu_pool(tmp_path, seed):
    r = _smoke(tmp_path, "--device", "cpu", "--jobs", "4", "--job-timeout", "15",
               "--seed", seed)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith(f"chaos-smoke: seed={seed} device=cpu slices=2 schedule=")
    assert "serve.executor:1:1,serve.journal:1:1" in lines[0]
    assert lines[-1].startswith(f"chaos-smoke: OK on cpu (seed {seed}, 2 slice(s);")
    assert "recoveries 1" in lines[-1] and "torn journal counted 1" in lines[-1]


def test_the_chaos_smoke_fails_where_its_daemon_cannot_see_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _smoke(tmp_path, "--jobs", "1", timeout=120)  # --device cuda, the default
    assert r.returncode == 1
    assert "chaos-smoke: FAIL: daemon exited before binding its socket" in r.stderr
    assert "no CUDA device is visible" in r.stderr  # the daemon's log, printed
    assert "OK" not in r.stdout


def test_a_chain_argument_must_name_a_directory_and_a_file(tmp_path):
    r = _smoke(tmp_path, "--device", "cpu", "--chain", str(tmp_path), timeout=60)
    assert r.returncode == 2 and "is not DIR=EXPECTED" in r.stderr
