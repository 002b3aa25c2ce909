"""The PyTorch/CUDA port (spgemm_tpu_torch) and chip_smoke.py import neither
jax nor anything of the JAX package spgemm_tpu, checked in a fresh
interpreter that imports every port module; and the daemon's client side
(serve/client, protocol, queue, placement, and serve/daemon before it runs)
imports neither torch nor numpy."""

import os
import subprocess
import sys

import pytest

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
             "ops.cuda_splice", "ops.cuda_dense", "utils.failpoints", "parallel.mesh",
             "serve", "serve.protocol", "serve.queue", "serve.placement", "serve.client",
             "serve.daemon", "serve.smoke"):
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


_LIGHT_CHILD = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "numpy", "jax", "jaxlib", "spgemm_tpu"))
assert not bad, bad
print("light")
"""


@pytest.mark.parametrize("module", ["spgemm_tpu_torch.serve.client",
                                    "spgemm_tpu_torch.serve.protocol",
                                    "spgemm_tpu_torch.serve.queue",
                                    "spgemm_tpu_torch.serve.placement",
                                    "spgemm_tpu_torch.serve.daemon"])
def test_the_serve_front_loads_neither_torch_nor_numpy(module):
    """A submitting process must not pay the cold torch import the daemon
    exists to amortize; the daemon module loads the engine lazily."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _LIGHT_CHILD, module], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.split() == ["light"], proc.stderr


def test_the_package_data_ships_every_port_source():
    """An installed port builds its kernels (csrc/*.cu, which include
    csrc/*.cuh) and its host library (native/*.cpp) from sources it must
    carry."""
    import fnmatch
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    shipped = [f"{pkg.replace('.', '/')}/{pat}" for pkg, pats in data.items() for pat in pats]
    port = os.path.join(REPO, "spgemm_tpu_torch")
    sources = [f"spgemm_tpu_torch/{d}/{name}" for d in ("csrc", "native")
               for name in os.listdir(os.path.join(port, d))]
    assert sources and all(any(fnmatch.fnmatch(s, pat) for pat in shipped) for s in sources), \
        (sources, shipped)
