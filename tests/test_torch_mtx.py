"""The port's MatrixMarket converter (spgemm_tpu_torch/utils/mtx.py) against
the JAX package's (spgemm_tpu/utils/mtx.py) on tests/data/gr_12_12.mtx and
small inline files: the parsed elements, the tiled matrices and the bytes
of the converted directories.  Tolerance: exact."""

import os
import subprocess
import sys

import numpy as np
import pytest

from spgemm_tpu.utils import mtx as jax_mtx
from spgemm_tpu_torch.utils import mtx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GR = os.path.join(REPO, "tests", "data", "gr_12_12.mtx")

SMALL = {
    "general": "%%MatrixMarket matrix coordinate real general\n% a comment\n4 4 5\n"
               "1 1 1.5\n2 1 2.0\n3 3 0.25\n4 4 7.0\n1 4 3.0\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n3 3 3\n"
                 "1 1 5.0\n2 1 1.0\n3 3 2.0\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n2 2 2\n1 1\n2 2\n",
    "empty": "%%MatrixMarket matrix coordinate real general\n5 5 0\n",
}


def _dir_bytes(folder) -> dict:
    return {name: open(os.path.join(folder, name), "rb").read()
            for name in sorted(os.listdir(folder))}


@pytest.mark.parametrize("value_map,scale", [("pattern", 1000.0), ("scale", 2.0),
                                             ("scale", 1000.0)])
def test_gr_12_12_matches_jax(value_map, scale, tmp_path):
    got = mtx.read_mtx(GR, value_map, scale)
    want = jax_mtx.read_mtx(GR, value_map, scale)
    assert got[:2] == want[:2] == (144, 144)
    for x, y in zip(got[2:], want[2:]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for k in (4, 32):
        m = mtx.mtx_to_block_matrix(GR, k, value_map, scale)
        w = jax_mtx.mtx_to_block_matrix(GR, k, value_map, scale)
        assert np.array_equal(m.coords, w.coords) and np.array_equal(m.tiles, w.tiles)
    mtx.convert_to_dir([GR, GR], str(tmp_path / "port"), 4, value_map, scale)
    jax_mtx.convert_to_dir([GR, GR], str(tmp_path / "jax"), 4, value_map, scale)
    ours = _dir_bytes(tmp_path / "port")
    assert list(ours) == ["matrix1", "matrix2", "size"]
    assert ours == _dir_bytes(tmp_path / "jax")


@pytest.mark.parametrize("name", list(SMALL))
def test_small_files_match_jax(name, tmp_path):
    path = tmp_path / f"{name}.mtx"
    path.write_text(SMALL[name])
    for value_map in ("pattern", "scale"):
        m = mtx.mtx_to_block_matrix(str(path), 2, value_map, 4.0)
        w = jax_mtx.mtx_to_block_matrix(str(path), 2, value_map, 4.0)
        assert (m.rows, m.cols) == (w.rows, w.cols)
        assert np.array_equal(m.coords, w.coords) and np.array_equal(m.tiles, w.tiles)


def test_elements_to_blocks_matches_jax():
    rng = np.random.default_rng(11)
    r = rng.integers(0, 50, size=400)
    c = rng.integers(0, 70, size=400)
    v = rng.integers(0, 1 << 63, size=400, dtype=np.uint64)
    for k in (1, 3, 8):
        m = mtx.elements_to_blocks(50, 70, r, c, v, k)
        w = jax_mtx.elements_to_blocks(50, 70, r, c, v, k)
        assert np.array_equal(m.coords, w.coords) and np.array_equal(m.tiles, w.tiles)


def test_not_matrix_market_raises(tmp_path):
    path = tmp_path / "x.mtx"
    path.write_text("1 2 3\n")
    with pytest.raises(ValueError, match="not a MatrixMarket"):
        mtx.read_mtx(str(path))
    path.write_text("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n")
    with pytest.raises(ValueError, match="coordinate"):
        mtx.read_mtx(str(path))


def test_module_entry_point_writes_jax_bytes(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.utils.mtx", GR, GR,
                           str(tmp_path / "port"), "--k", "8", "--value-map", "scale",
                           "--scale", "3"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert jax_mtx.main([GR, GR, str(tmp_path / "jax"), "--k", "8", "--value-map", "scale",
                         "--scale", "3"]) == 0
    assert _dir_bytes(tmp_path / "port") == _dir_bytes(tmp_path / "jax")
