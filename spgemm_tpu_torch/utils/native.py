"""The port's native host library: text I/O, the symbolic join and the
parity fold in C++ (`spgemm_tpu_torch/native/*.cpp`), built with g++ at
first use and called through ctypes.

The three sources become one `build/host_native/libsmmio-<hash>.so`, where
the hash covers the sources, the flags and the compiler's version, so a
changed source rebuilds and an unchanged one is reused.  The first load in a
process is recorded in obs/profile (site `native`).  The library is compiled to a temporary file and
moved into place with os.replace, so processes that build at once never load
half a file.  It is built for the generic x86-64 target (no -march=native):
`build/` may be copied to a machine with another CPU.

Nothing falls back quietly: a failed build or load, a missing symbol or an
error code from the library raises.  Only SPGEMM_TPU_NO_NATIVE=1 selects the
numpy paths (utils/io_text.py, ops/symbolic.py), and it also keeps this
library from being built or loaded.

ctypes releases the GIL for the whole of each call, so the loader's thread
pool parses files in parallel and the chain's planner thread joins while
the main thread dispatches.  The writer and the parity fold spread their
work over std::threads inside the call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from spgemm_tpu_torch.obs import profile
from spgemm_tpu_torch.utils import knobs

SRC_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_native"
SOURCES = ("smmio.cpp", "symbolic.cpp", "parityfold.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}  # by source directory; spgemm-lint: guarded-by(_lock)

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U64P = ctypes.POINTER(ctypes.c_uint64)


def _arr(dtype):
    return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")


_SIGNATURES = {
    "smm_parse_matrix": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64, _I64P,
                                        ctypes.POINTER(_I64P), ctypes.POINTER(_U64P)]),
    "smm_free": (None, [ctypes.c_void_p]),
    "smm_write_matrix": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64, ctypes.c_int64, _arr(np.int64),
                                        _arr(np.uint64)]),
    "smm_symbolic_join": (ctypes.c_int, [_arr(np.int64), ctypes.c_int64, _arr(np.int64),
                                         ctypes.c_int64, ctypes.POINTER(_I64P), _I64P,
                                         ctypes.POINTER(_I64P), ctypes.POINTER(_I32P),
                                         ctypes.POINTER(_I32P), _I64P]),
    "smm_sym_free": (None, [ctypes.c_void_p]),
    "smm_parity_fold": (ctypes.c_int64, [_arr(np.uint64), _arr(np.uint64), _arr(np.int64),
                                         _arr(np.int32), _arr(np.int32), ctypes.c_int64,
                                         ctypes.c_int64, _arr(np.uint64), _I64P]),
}


def enabled() -> bool:
    """False when SPGEMM_TPU_NO_NATIVE selects the numpy paths."""
    return not knobs.get("SPGEMM_TPU_NO_NATIVE")


def _gxx(*args: str, timeout: float) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(["g++", *args], capture_output=True, text=True, timeout=timeout)
    except FileNotFoundError:
        raise RuntimeError("g++ not found on PATH; the native host library cannot be "
                           "built (SPGEMM_TPU_NO_NATIVE=1 selects the numpy paths)") from None


def build() -> Path:
    """Compile the sources in SRC_DIR unless an up-to-date library exists;
    returns the library's path.  The hash also covers the compiler's
    version line, so a build/ copied from a machine with another toolchain
    (and C++ runtime) is not reused.  A failed build raises with g++'s
    stderr."""
    return _build()[0]


def _build() -> tuple[Path, bool]:
    """build(), and whether g++ ran (False: an up-to-date library was
    reused)."""
    srcs = [SRC_DIR / name for name in SOURCES]
    digest = hashlib.sha256()
    for src in srcs:
        digest.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(_gxx("--version", timeout=60).stdout.split("\n")[0].encode())
    lib = BUILD_DIR / f"libsmmio-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = _gxx(*CXX_FLAGS, "-o", str(tmp), *map(str, srcs), timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build the native host library from {SRC_DIR} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib, True


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use.  The first load in a process
    lands a build record under site `native` (obs/profile.record_build);
    a failed build or load raises before anything is recorded."""
    if not enabled():
        raise RuntimeError("SPGEMM_TPU_NO_NATIVE is set: the native host library "
                           "is neither built nor loaded")
    with _lock:
        if SRC_DIR in _libs:
            return _libs[SRC_DIR]
        t0 = time.perf_counter()
        # spgemm-lint: blk-ok(one-shot memoized build: the lock MUST cover the g++ run so a second thread can neither double-compile nor CDLL a half-written library; cold path, once per process)
        path, built = _build()
        try:
            handle = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype, fn.argtypes = restype, argtypes
        except (OSError, AttributeError) as e:
            raise RuntimeError(f"cannot load the native host library {path}: {e}") from e
        _libs[SRC_DIR] = handle
        wall = time.perf_counter() - t0
    # outside _lock: the record takes the ENGINE and event-log locks
    profile.record_build("native", wall, built, path.name, None)
    return handle


def _fetch(ptr, shape, dtype, free) -> np.ndarray:
    """Copy a malloc'd native array out and free it."""
    try:
        n = int(np.prod(shape))
        return np.ctypeslib.as_array(ptr, shape=(n,)).copy().reshape(shape) if n \
            else np.zeros(shape, dtype)
    finally:
        if ptr:
            free(ptr)


def parse_matrix(path: str, k: int):
    """Parse one matrix file -> (rows, cols, coords (nnzb, 2) int64,
    tiles (nnzb, k, k) uint64), coords in file order.  Raises
    FileNotFoundError for a missing file, ValueError for a malformed or
    truncated one."""
    if k < 1:
        raise ValueError(f"tile size k must be >= 1, got {k}")
    h = lib()
    header = (ctypes.c_int64 * 3)()
    coords_p, tiles_p = _I64P(), _U64P()
    rc = h.smm_parse_matrix(os.fsencode(path), k, header,
                            ctypes.byref(coords_p), ctypes.byref(tiles_p))
    if rc == -1:
        raise FileNotFoundError(f"cannot open {path!r}")
    if rc == -3:
        raise ValueError(f"matrix file {path!r} is malformed or truncated: expected "
                         f"'rows cols blocks', then per block 2 + k*k = {2 + k * k} "
                         "unsigned integers")
    if rc == -4:
        raise MemoryError(f"cannot allocate the tiles of {path!r}")
    if rc != 0:
        raise OSError(f"cannot read {path!r} (native rc={rc})")
    blocks = header[2]
    coords = _fetch(coords_p, (blocks, 2), np.int64, h.smm_free)
    tiles = _fetch(tiles_p, (blocks, k, k), np.uint64, h.smm_free)
    return int(header[0]), int(header[1]), coords, tiles


def write_matrix(path: str, rows: int, cols: int, k: int,
                 coords: np.ndarray, tiles: np.ndarray) -> None:
    """Write one matrix in the reference writer's bytes (utils/io_text.
    format_matrix is the plain version)."""
    coords = np.ascontiguousarray(coords, np.int64).reshape(-1, 2)
    tiles = np.ascontiguousarray(tiles, np.uint64)
    if tiles.shape != (len(coords), k, k):
        raise ValueError(f"tiles {tiles.shape} do not match {len(coords)} blocks of {k}x{k}")
    rc = lib().smm_write_matrix(os.fsencode(path), rows, cols, k, len(coords), coords, tiles)
    if rc == -4:
        raise MemoryError(f"cannot allocate the text of {path!r}")
    if rc != 0:
        raise OSError(f"cannot {'open' if rc == -1 else 'write'} {path!r} (native rc={rc})")


def symbolic_join_native(a_coords: np.ndarray, b_coords: np.ndarray):
    """The structure join of ops/symbolic.symbolic_join in C++ ->
    (keys, pair_ptr, pair_a, pair_b).  The caller keeps to the regime where
    the fused key (max a row + 1) * (max b col + 1) fits in 64 bits."""
    a = np.ascontiguousarray(a_coords, np.int64).reshape(-1, 2)
    b = np.ascontiguousarray(b_coords, np.int64).reshape(-1, 2)
    h = lib()
    keys_p, ptr_p, pa_p, pb_p = _I64P(), _I64P(), _I32P(), _I32P()
    nk, total = ctypes.c_int64(), ctypes.c_int64()
    rc = h.smm_symbolic_join(a, len(a), b, len(b), ctypes.byref(keys_p), ctypes.byref(nk),
                             ctypes.byref(ptr_p), ctypes.byref(pa_p), ctypes.byref(pb_p),
                             ctypes.byref(total))
    if rc != 0:
        for p in (keys_p, ptr_p, pa_p, pb_p):
            if p:
                h.smm_sym_free(p)
        raise MemoryError(f"native symbolic join failed (rc={rc})")
    n_keys, n_pairs = int(nk.value), int(total.value)
    return (_fetch(keys_p, (n_keys, 2), np.int64, h.smm_sym_free),
            _fetch(ptr_p, (n_keys + 1,), np.int64, h.smm_sym_free),
            _fetch(pa_p, (n_pairs,), np.int32, h.smm_sym_free),
            _fetch(pb_p, (n_pairs,), np.int32, h.smm_sym_free))


def _u64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    return np.ascontiguousarray(x.view(np.uint64) if x.dtype == np.int64 else x)


def parity_fold_check(a_tiles: np.ndarray, b_tiles: np.ndarray, pair_ptr: np.ndarray,
                      pair_a: np.ndarray, pair_b: np.ndarray,
                      out_tiles: np.ndarray) -> tuple[int, int]:
    """Recompute EVERY output key of one multiply with the reference's
    wrap-then-mod fold in plain uint64 C++ (native/parityfold.cpp) and
    compare it with out_tiles, the multiply's (n_keys, k, k) result in join
    key order.  Tiles may be uint64 or their int64 bit views.  Returns
    (n_bad, first_bad_key): (0, -1) means every key is bit-exact."""
    a, b, out = _u64(a_tiles), _u64(b_tiles), _u64(out_tiles)
    ptr = np.ascontiguousarray(pair_ptr, np.int64)
    pa = np.ascontiguousarray(pair_a, np.int32)
    pb = np.ascontiguousarray(pair_b, np.int32)
    n_keys = len(ptr) - 1
    k = a.shape[-1]
    for name, x in (("a_tiles", a), ("b_tiles", b), ("out_tiles", out)):
        if x.dtype != np.uint64 or x.ndim != 3 or x.shape[1:] != (k, k):
            raise ValueError(f"{name} must be (n, {k}, {k}) uint64 tiles, got "
                             f"{x.shape} {x.dtype}")
    if n_keys < 0 or len(out) != n_keys or ptr[0] != 0 or ptr[-1] != len(pa) \
            or len(pb) != len(pa) or np.any(np.diff(ptr) < 0):
        raise ValueError("pair_ptr, pair_a, pair_b and out_tiles do not describe one join")
    for name, idx, n in (("pair_a", pa, len(a)), ("pair_b", pb, len(b))):
        if len(idx) and (idx.min() < 0 or idx.max() >= n):
            raise ValueError(f"{name} indexes outside its {n} tiles")
    if n_keys == 0:
        return 0, -1
    first_bad = ctypes.c_int64(-1)
    n_bad = lib().smm_parity_fold(a, b, ptr, pa, pb, n_keys, k, out, ctypes.byref(first_bad))
    if n_bad < 0:
        raise MemoryError(f"native parity fold failed (rc={n_bad})")
    return int(n_bad), int(first_bad.value)
