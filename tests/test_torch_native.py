"""The port's native host library (spgemm_tpu_torch/utils/native.py and
native/*.cpp) against the JAX package's (spgemm_tpu/utils/native.py,
io_text.py, ops/symbolic.py, utils/semantics.py) and the port's own numpy
paths, on the same seeded inputs: the text reader and writer, the symbolic
join and the parity fold.  Tolerance: exact (byte-equal files, equal
arrays).  Also: SPGEMM_TPU_NO_NATIVE=1 selects the numpy paths, and a
failed build or load raises instead of falling back.

The JAX package's native library runs here from a private build: the
module's fixture compiles the JAX package's sources with its own flags into
build/jax_native/, under a name hashed from them, and points
spgemm_tpu.utils.native at that file for the module.  The package builds its
library straight onto its final path and remembers a failed load for the
rest of the process, so test workers that start at once on a fresh tree
could otherwise load a half-written file and fall back to its numpy reader.
The fixture fails if the library does not load; it never skips."""

import hashlib
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

from spgemm_tpu.ops import symbolic as jax_symbolic
from spgemm_tpu.utils import io_text as jax_io
from spgemm_tpu.utils import native as jax_native
from spgemm_tpu.utils.blockcsr import BlockSparseMatrix as JaxMatrix
from spgemm_tpu.utils.gen import banded_block_sparse, powerlaw_block_sparse, random_block_sparse
from spgemm_tpu.utils.semantics import spgemm_oracle
from spgemm_tpu_torch.ops import symbolic
from spgemm_tpu_torch.utils import io_text, native
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's g++ flags (spgemm_tpu/utils/native.py, _build), before -o
JAX_NATIVE_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
JAX_NATIVE_DIR = os.path.join(REPO, "build", "jax_native")
MAX = (1 << 64) - 1
EDGE = np.array([0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
                 MAX - 2, MAX - 1, MAX], dtype=np.uint64)


def _private_jax_lib() -> str:
    """The JAX package's native sources built with its flags into a file of
    this module's own, named by a hash of the sources, the flags and the
    compiler's version line: compiled to a temp file and moved into place,
    so workers that build at once each load a whole library."""
    srcs = [jax_native._SRC, jax_native._SYM_SRC, jax_native._FOLD_SRC]
    digest = hashlib.sha256()
    for src in srcs:
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + b"\0" + f.read() + b"\0")
    digest.update(" ".join(JAX_NATIVE_FLAGS).encode())
    version = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True)
    digest.update(version.stdout.split("\n")[0].encode())
    lib = os.path.join(JAX_NATIVE_DIR, f"libsmmio-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        os.makedirs(JAX_NATIVE_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run(["g++", *JAX_NATIVE_FLAGS, "-o", tmp, *srcs],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on the JAX package's native sources:\n{proc.stderr}")
        os.replace(tmp, lib)
    os.utime(lib)  # newer than the sources, so get_lib never rebuilds it in place
    return lib


def _load_private_jax_lib(lib: str) -> None:
    """Point the JAX package's loader at lib, forget whatever it remembered
    (a failed load included), and load: raises if the library is missing."""
    with jax_native._lock:
        jax_native._SO = lib
        jax_native._tried = False
        jax_native._lib = None
    if jax_native.get_lib() is None:
        raise RuntimeError(f"the JAX package's native library did not load from {lib}")


@pytest.fixture(scope="module", autouse=True)
def private_jax_lib():
    """The JAX package's native library from this module's private build,
    for the module; the loader's state is restored after it."""
    with jax_native._lock:
        saved = (jax_native._SO, jax_native._tried, jax_native._lib)
    lib = _private_jax_lib()
    _load_private_jax_lib(lib)
    yield lib
    with jax_native._lock:
        jax_native._SO, jax_native._tried, jax_native._lib = saved


def _matrix(case: str) -> BlockSparseMatrix:
    rng = np.random.default_rng(len(case))
    if case == "empty":
        return BlockSparseMatrix(rows=16, cols=24, k=4)
    if case == "k1":
        m = random_block_sparse(40, 30, 1, 0.3, rng, "full")
    elif case == "extremes":  # 0, 1, 2^64-2 and 2^64-1 in every tile
        m = random_block_sparse(6, 7, 4, 0.5, rng, "full")
        m.tiles[:, 0, :] = np.array([0, 1, MAX - 1, MAX], np.uint64)
    elif case == "edge":
        m = random_block_sparse(9, 9, 3, 0.5, rng)
        m.tiles[:] = EDGE[rng.integers(0, len(EDGE), size=m.tiles.shape)]
    else:  # more blocks than the writer's smallest run, over several threads
        m = banded_block_sparse(300, 2, 2, rng, "full")
    return BlockSparseMatrix.from_reference(m)


def _same(m, w) -> bool:
    return (m.rows, m.cols, m.k) == (w.rows, w.cols, w.k) \
        and np.array_equal(m.coords, w.coords) and np.array_equal(m.tiles, w.tiles)


def _text_io_check(case: str, tmp_path) -> None:
    m = _matrix(case)
    jm = JaxMatrix(rows=m.rows, cols=m.cols, k=m.k, coords=m.coords, tiles=m.tiles)
    io_text.write_matrix(str(tmp_path / "port"), m)
    assert jax_native.write_matrix(str(tmp_path / "jax"), jm.rows, jm.cols, jm.k,
                                   jm.coords, jm.tiles)
    want = jax_io.format_matrix(jm)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes() == want
    assert io_text.format_matrix(m) == want
    got = io_text.read_matrix(str(tmp_path / "jax"), m.k)
    assert _same(got, m)
    assert _same(got, io_text.read_matrix_plain(str(tmp_path / "jax"), m.k))
    assert _same(got, jax_io.read_matrix(str(tmp_path / "port"), m.k))


@pytest.mark.parametrize("case", ["extremes", "edge", "k1", "empty", "banded"])
def test_text_io_matches_jax_and_plain(case, tmp_path):
    _text_io_check(case, tmp_path)


@pytest.mark.parametrize("case", ["k1", "banded"])
def test_the_private_jax_library_survives_a_lost_race(case, private_jax_lib, tmp_path):
    """The state a lost build race leaves in the JAX package's loader (a
    load tried and failed: _tried True, _lib None) is what the fixture
    repairs: after it, the JAX native library is loaded and the text I/O
    comparison passes."""
    with jax_native._lock:
        jax_native._tried, jax_native._lib = True, None
    assert jax_native.get_lib() is None
    _load_private_jax_lib(private_jax_lib)
    assert jax_native.get_lib() is not None and jax_native._SO == private_jax_lib
    _text_io_check(case, tmp_path)


def test_parse_keeps_file_order_and_last_duplicate(tmp_path):
    """Unsorted blocks and a repeated coordinate, written by hand: the native
    parse returns them in file order and read_matrix sorts them with the
    last occurrence winning, as the plain path and the JAX package do."""
    (tmp_path / "m").write_text("4 4\n3\n1 0\n5 6\n7 8\n0 1\n1 2\n3 4\n"
                                "1 0\n9 10\n11 12\n")
    rows, cols, coords, tiles = native.parse_matrix(str(tmp_path / "m"), 2)
    assert (rows, cols) == (4, 4)
    assert coords.tolist() == [[1, 0], [0, 1], [1, 0]]
    assert tiles[:, 0, 0].tolist() == [5, 1, 9]
    got = io_text.read_matrix(str(tmp_path / "m"), 2)
    assert _same(got, io_text.read_matrix_plain(str(tmp_path / "m"), 2))
    assert _same(got, jax_io.read_matrix(str(tmp_path / "m"), 2))
    assert got.coords.tolist() == [[0, 1], [1, 0]] and got.tiles[1, 0, 0] == 9


@pytest.mark.parametrize("text", [
    "4 4\n2\n0 0\n1 2\n",                       # truncated tile
    "4 4\n1\n0 0\n1 2\n3\n",                    # one value short
    "4 4\n",                                    # no block count
    "junk\n",
    "4 4\n1\n0 0\n1 x 3 4\n",                   # not a number
    "4 4\n1\n0 0\n1 -2 3 4\n",                  # negative
    "4 4\n1\n0 0\n1 2.5 3 4\n",                 # not an integer
    "4 4\n99999999999999999\n0 0\n1 2 3 4\n",   # a block count the file cannot hold
    "",
])
def test_malformed_and_truncated_files_raise_value_error(text, tmp_path):
    path = str(tmp_path / "m")
    with open(path, "w") as f:
        f.write(text)
    for read in (io_text.read_matrix, io_text.read_matrix_plain, jax_io.read_matrix):
        with pytest.raises(ValueError):
            read(path, 2)


@pytest.mark.parametrize("value", ["18446744073709551616", "18446744073709551620",
                                   "99999999999999999999", "123456789012345678901"])
def test_values_past_u64_raise_value_error(value, tmp_path):
    """A value of 2^64 or more is malformed on both of the port's paths (the
    plain parse raised OverflowError before; the JAX package's native parser
    wraps it, so it is not compared here); 2^64 - 1 still parses."""
    path = str(tmp_path / "m")
    for text, ok in ((f"4 4\n1\n0 0\n1 {value} 3 4\n", False),
                     ("4 4\n1\n0 0\n1 18446744073709551615 3 4\n", True)):
        with open(path, "w") as f:
            f.write(text)
        for read in (io_text.read_matrix, io_text.read_matrix_plain):
            if ok:
                assert read(path, 2).tiles[0, 0, 1] == np.uint64(MAX)
            else:
                with pytest.raises(ValueError):
                    read(path, 2)


def test_missing_file_raises_file_not_found(tmp_path):
    path = str(tmp_path / "absent")
    for read in (io_text.read_matrix, io_text.read_matrix_plain, jax_io.read_matrix):
        with pytest.raises(FileNotFoundError):
            read(path, 2)
    with pytest.raises(OSError):
        io_text.write_matrix(str(tmp_path / "no" / "dir"), _matrix("edge"))


def test_read_chain_threads_and_no_native_agree(tmp_path, monkeypatch):
    rng = np.random.default_rng(31)
    mats = [BlockSparseMatrix.from_reference(random_block_sparse(12, 12, 4, 0.4, rng, "full"))
            for _ in range(6)]
    io_text.write_chain_dir(str(tmp_path), mats, 4)
    many = io_text.read_chain(str(tmp_path), 0, 5, 4, max_workers=6)
    one = io_text.read_chain(str(tmp_path), 0, 5, 4, max_workers=1)
    monkeypatch.setenv("SPGEMM_TPU_NO_NATIVE", "1")
    plain = io_text.read_chain(str(tmp_path), 0, 5, 4, max_workers=3)
    theirs = jax_io.read_chain(str(tmp_path), 0, 5, 4)
    for m, x, y, z, w in zip(mats, many, one, plain, theirs):
        assert _same(x, m) and _same(y, m) and _same(z, m) and _same(w, m)


def _join_cases():
    rng = np.random.default_rng(7)
    big = np.array([[1 << 40, 3], [(1 << 40) + 1, 5]], np.int64)  # max row * span > 2^64
    big_b = np.array([[3, 1 << 30], [5, 2]], np.int64)
    return {
        "uniform": (random_block_sparse(48, 48, 8, 0.15, rng).coords,
                    random_block_sparse(48, 48, 8, 0.15, rng).coords),
        "banded": (banded_block_sparse(64, 8, 3, rng).coords,
                   banded_block_sparse(64, 8, 6, rng).coords),
        "powerlaw": (powerlaw_block_sparse(64, 8, 3.0, rng).coords,
                     powerlaw_block_sparse(64, 8, 3.0, rng).coords),
        "hub": (np.stack([np.zeros(300, np.int64), np.arange(300)], axis=1),
                np.stack([np.repeat(np.arange(300), 2), np.tile([0, 7], 300)], axis=1)),
        "empty_a": (np.zeros((0, 2), np.int64), random_block_sparse(8, 8, 8, 0.2, rng).coords),
        "empty_b": (random_block_sparse(8, 8, 8, 0.2, rng).coords, np.zeros((0, 2), np.int64)),
        "no_match": (np.array([[0, 0]], np.int64), np.array([[5, 5]], np.int64)),
        "outside_native_safe": (big, big_b),
    }


@pytest.mark.parametrize("case", list(_join_cases()))
def test_join_matches_jax_and_plain(case, monkeypatch):
    ac, bc = _join_cases()[case]
    safe = len(ac) == 0 or len(bc) == 0 or \
        (int(ac[:, 0].max()) + 1) * (int(bc[:, 1].max()) + 1) <= 1 << 64
    calls = []
    real = native.symbolic_join_native
    monkeypatch.setattr(native, "symbolic_join_native",
                        lambda a, b: calls.append(1) or real(a, b))
    got = symbolic.symbolic_join(ac, bc)
    assert len(calls) == (1 if safe else 0)
    plain = symbolic.symbolic_join_plain(ac, bc)
    theirs = jax_symbolic.symbolic_join(ac, bc)
    for f in ("keys", "pair_ptr", "pair_a", "pair_b"):
        x, y, z = getattr(got, f), getattr(plain, f), getattr(theirs, f)
        assert x.dtype == y.dtype == z.dtype, f
        assert np.array_equal(x, y) and np.array_equal(x, z), f


@pytest.mark.parametrize("k,dist", [(1, "adversarial"), (2, "full"), (4, "adversarial"),
                                    (3, "edge")])
def test_parity_fold_matches_oracle_and_reports_bad_keys(k, dist):
    """The native fold against the JAX package's python-int oracle on wrap
    values (every key), and against the JAX package's own native fold; a
    corrupted tile is reported by count and first key."""
    rng = np.random.default_rng(92 + k)
    a = random_block_sparse(12, 12, k, 0.4, rng, "adversarial" if dist == "edge" else dist)
    b = random_block_sparse(12, 12, k, 0.4, rng, "adversarial" if dist == "edge" else dist)
    if dist == "edge":
        a.tiles[:] = EDGE[rng.integers(0, len(EDGE), size=a.tiles.shape)]
        b.tiles[:] = EDGE[rng.integers(0, len(EDGE), size=b.tiles.shape)]
    join = symbolic.symbolic_join(a.coords, b.coords)
    want = JaxMatrix.from_dict(a.rows, b.cols, k, spgemm_oracle(a.to_dict(), b.to_dict(), k))
    assert np.array_equal(want.coords, join.keys)
    args = (a.tiles, b.tiles, join.pair_ptr, join.pair_a, join.pair_b)
    assert native.parity_fold_check(*args, want.tiles) == (0, -1)
    assert native.parity_fold_check(*args, want.tiles.view(np.int64)) == (0, -1)
    bad = want.tiles.copy()
    q = len(bad) // 2
    bad[q, k - 1, 0] ^= np.uint64(1 << 63)
    bad[-1, 0, k - 1] ^= np.uint64(1)
    assert native.parity_fold_check(*args, bad) == (2, q)
    assert jax_native.parity_fold_check(*args, bad) == (2, q)


def test_parity_fold_rejects_inconsistent_arrays():
    rng = np.random.default_rng(3)
    a = random_block_sparse(6, 6, 2, 0.5, rng)
    join = symbolic.symbolic_join(a.coords, a.coords)
    out = np.zeros((join.num_keys, 2, 2), np.uint64)
    with pytest.raises(ValueError, match="pair_a"):
        native.parity_fold_check(a.tiles[:1], a.tiles, join.pair_ptr, join.pair_a,
                                 join.pair_b, out)
    with pytest.raises(ValueError, match="one join"):
        native.parity_fold_check(a.tiles, a.tiles, join.pair_ptr, join.pair_a,
                                 join.pair_b, out[1:])
    assert native.parity_fold_check(a.tiles, a.tiles, np.zeros(1, np.int64),
                                    np.zeros(0, np.int32), np.zeros(0, np.int32),
                                    np.zeros((0, 2, 2), np.uint64)) == (0, -1)


def test_no_native_selects_numpy(tmp_path, monkeypatch):
    m = _matrix("edge")
    path = str(tmp_path / "m")

    def refuse(*args, **kw):
        raise AssertionError("native path taken")

    for name in ("parse_matrix", "write_matrix", "symbolic_join_native"):
        monkeypatch.setattr(native, name, refuse)
    monkeypatch.setenv("SPGEMM_TPU_NO_NATIVE", "1")
    assert not native.enabled()
    io_text.write_matrix(path, m)
    assert _same(io_text.read_matrix(path, m.k), m)
    join = symbolic.symbolic_join(m.coords, m.coords)
    assert np.array_equal(join.keys, symbolic.symbolic_join_plain(m.coords, m.coords).keys)
    with pytest.raises(RuntimeError, match="SPGEMM_TPU_NO_NATIVE"):
        native.lib()
    # and without the knob the native paths run, not the plain ones
    monkeypatch.undo()
    monkeypatch.setattr(io_text, "read_matrix_plain", refuse)
    monkeypatch.setattr(io_text, "format_matrix", refuse)
    monkeypatch.setattr(symbolic, "symbolic_join_plain", refuse)
    io_text.write_matrix(path, m)
    assert _same(io_text.read_matrix(path, m.k), m)
    symbolic.symbolic_join(m.coords, m.coords)


def _broken_copy(tmp_path, monkeypatch, edit):
    src = tmp_path / "native_src"
    shutil.copytree(native.SRC_DIR, src)
    path = src / edit[0]
    path.write_text(path.read_text().replace(edit[1], edit[2]))
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")


def test_failed_build_raises_instead_of_falling_back(tmp_path, monkeypatch):
    _broken_copy(tmp_path, monkeypatch,
                 ("symbolic.cpp", "extern \"C\" {", "#error deliberately broken\nextern \"C\" {"))
    with pytest.raises(RuntimeError, match="deliberately broken"):
        native.lib()
    m = _matrix("edge")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        io_text.write_matrix(str(tmp_path / "m"), m)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        symbolic.symbolic_join(m.coords, m.coords)
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_symbol_raises_on_load(tmp_path, monkeypatch):
    _broken_copy(tmp_path, monkeypatch,
                 ("parityfold.cpp", "int64_t smm_parity_fold(", "int64_t smm_parity_fold_renamed("))
    with pytest.raises(RuntimeError, match="cannot load.*smm_parity_fold"):
        native.lib()


_BUILD_CHILD = """
import sys
import numpy as np
from pathlib import Path
from spgemm_tpu_torch.utils import native
native.BUILD_DIR = Path(sys.argv[1])
keys, ptr, pa, pb = native.symbolic_join_native(np.array([[0, 1]]), np.array([[1, 2]]))
print(keys.tolist(), ptr.tolist())
"""


def test_processes_building_at_once_all_load(tmp_path):
    """Four processes build into one empty directory at the same time (as
    the test workers do): each compiles to a file of its own and moves it
    into place, so every one loads a whole library."""
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, str(tmp_path)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    assert all(out.strip() == "[[0, 2]] [0, 1]" for out, _ in outs)
    assert len(list(tmp_path.glob("libsmmio-*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))


def test_parallel_parses_share_one_library(tmp_path):
    """Threads parsing at once through one loaded library, with a short
    switch interval: every parse returns its own file's matrix."""
    rng = np.random.default_rng(5)
    mats = [BlockSparseMatrix.from_reference(random_block_sparse(10, 10, 3, 0.5, rng, "full"))
            for _ in range(4)]
    for i, m in enumerate(mats):
        io_text.write_matrix(str(tmp_path / f"m{i}"), m)
    errors = []

    def work(i):
        try:
            for _ in range(25):
                assert _same(io_text.read_matrix(str(tmp_path / f"m{i % 4}"), 3), mats[i % 4])
        except AssertionError as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
