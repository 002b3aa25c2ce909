"""Build the CUDA sources in `spgemm_tpu_torch/csrc/` with nvcc at first use
and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/torch_kernels/lib<name>-<hash>.so`
(a shared library with a plain C interface), where the hash covers the
source, every header in csrc/ (`*.cuh`) and the flags, so a changed source
or header rebuilds and an unchanged one is reused.  A failed build raises with nvcc's stderr; nothing falls back.
The first load of each library in a process is recorded in obs/profile
(site = the source's stem).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from spgemm_tpu_torch.obs import profile

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  # spgemm-lint: guarded-by(_lock)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                           "the CUDA kernels cannot be built")
    return nvcc


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless an up-to-date library exists; returns
    the library's path.  nvcc's ptxas report (registers, shared memory,
    spills) is kept beside it as <lib>.log."""
    return _build(name)[0]


def _build(name: str) -> tuple[Path, bool]:
    """build(name), and whether nvcc ran (False: an up-to-date library was
    reused)."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib, True


def build_all() -> dict[str, Path]:
    """Build every csrc/*.cu at once, one nvcc process per source."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def _ptxas(lib: Path) -> dict | None:
    """The ptxas report kept beside lib, per kernel (None when missing)."""
    try:
        return profile.parse_ptxas(lib.with_suffix(".log").read_text())
    except OSError:
        return None


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use.  The first
    load in a process lands a build record (obs/profile.record_build: the
    wall of the build or reuse plus the dlopen, whether nvcc ran, the ptxas
    report); a failed build or dlopen raises before anything is recorded."""
    with _lock:
        if name in _libs:
            return _libs[name]
        t0 = time.perf_counter()
        # spgemm-lint: blk-ok(one-shot memoized build: the lock MUST cover the nvcc run so a second thread can neither double-compile nor CDLL a half-written library; cold path, once per kernel per process, before its first launch)
        path, built = _build(name)
        lib = _libs[name] = ctypes.CDLL(str(path))
        wall = time.perf_counter() - t0
    # outside _lock: the record takes the ENGINE and event-log locks
    profile.record_build(name, wall, built, path.name, _ptxas(path))
    return lib
