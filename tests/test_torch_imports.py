"""The PyTorch/CUDA port (spgemm_tpu_torch) and chip_smoke.py import neither
jax nor anything of the JAX package spgemm_tpu, checked in a fresh
interpreter that imports every port module."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import importlib, pkgutil, sys
import spgemm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(spgemm_tpu_torch.__path__,
                                               "spgemm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
for name in ("cli", "ops.crossover", "ops.cuda_mxu", "ops.mxu_spgemm",
             "models.ffn", "ops.cuda_bsmm", "utils.native", "utils.knobs", "utils.mtx",
             "ops.plancache", "utils.checkpoint", "utils.backend_probe", "parallel",
             "parallel.chainpart", "ops.delta", "ops.estimate", "ops.warmstore",
             "ops.cuda_splice", "ops.cuda_dense"):
    assert f"spgemm_tpu_torch.{name}" in names, names
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "spgemm_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_neither_jax_nor_spgemm_tpu():
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 27  # every module was walked
