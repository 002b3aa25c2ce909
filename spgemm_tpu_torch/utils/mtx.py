"""MatrixMarket (.mtx) -> block text directory converter (the port's copy
of the JAX package's `utils/mtx.py`).

    python -m spgemm_tpu_torch.utils.mtx a.mtx [b.mtx ...] out_dir
                                         [--k 32] [--value-map pattern|scale]
                                         [--scale 1000]

tiles MatrixMarket coordinate files into dense k x k uint64 blocks and
writes a reference-format input directory (size + matrix1..matrixN), one
matrix per file in chain order.

Value mapping (the reference semantics are integer mod 2^64-1; SuiteSparse
values are real): 'pattern' maps every nonzero to 1, 'scale' multiplies by a
fixed factor and rounds into uint64 (documented, deterministic).
"""

from __future__ import annotations

import argparse
import gzip

import numpy as np

from spgemm_tpu_torch.utils import io_text
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix


def read_mtx(path: str, value_map: str = "pattern", scale: float = 1000.0) -> tuple:
    """Parse a MatrixMarket coordinate file -> (rows, cols, r, c, v) element COO
    with symmetric storage already mirrored."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path!r}: not a MatrixMarket file")
        toks = header.split()
        if toks[2] != "coordinate":
            raise ValueError(f"{path!r}: only coordinate format supported")
        field = toks[3]       # real | integer | pattern
        symmetry = toks[4]    # general | symmetric | skew-symmetric
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        rows, cols, nnz = (int(t) for t in line.split())
        data = np.loadtxt(f, ndmin=2) if nnz else np.zeros((0, 3))

    r = data[:, 0].astype(np.int64) - 1  # 1-indexed on disk
    c = data[:, 1].astype(np.int64) - 1
    if field == "pattern" or data.shape[1] < 3 or value_map == "pattern":
        v = np.ones(len(r), np.uint64)
    elif value_map == "scale":
        v = np.abs(data[:, 2] * scale).round().astype(np.uint64)
        v[v == 0] = 1  # keep the sparsity pattern
    else:
        raise ValueError(f"unknown value_map {value_map!r}")

    if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
        off = r != c  # mirror off-diagonal entries
        r, c, v = (np.concatenate([r, c[off]]),
                   np.concatenate([c, r[off]]),
                   np.concatenate([v, v[off]]))
    return rows, cols, r, c, v


def mtx_to_block_matrix(path: str, k: int, value_map: str = "pattern",
                        scale: float = 1000.0) -> BlockSparseMatrix:
    """Tile a .mtx file into a BlockSparseMatrix of k x k uint64 blocks."""
    rows, cols, r, c, v = read_mtx(path, value_map, scale)
    return elements_to_blocks(rows, cols, r, c, v, k)


def elements_to_blocks(rows: int, cols: int, r: np.ndarray, c: np.ndarray,
                       v: np.ndarray, k: int) -> BlockSparseMatrix:
    """Element COO -> block-sparse with dense k x k tiles (vectorized)."""
    if len(r) == 0:
        return BlockSparseMatrix(rows=rows, cols=cols, k=k)
    br, bc = r // k, c // k
    ir, ic = r - br * k, c - bc * k
    nbc = int(bc.max()) + 1 if len(bc) else 1
    block_key = br * nbc + bc
    order = np.argsort(block_key, kind="stable")
    block_key, br, bc = block_key[order], br[order], bc[order]
    ir, ic, v = ir[order], ic[order], v[order]
    uniq, inv = np.unique(block_key, return_inverse=True)
    nnzb = len(uniq)
    tiles = np.zeros((nnzb, k, k), np.uint64)
    tiles[inv, ir, ic] = v
    first = np.searchsorted(block_key, uniq)
    coords = np.stack([br[first], bc[first]], axis=1)
    return BlockSparseMatrix.from_blocks(rows, cols, k, coords, tiles,
                                         assume_sorted=False)


def convert_to_dir(mtx_paths: list[str], out_dir: str, k: int,
                   value_map: str = "pattern", scale: float = 1000.0) -> None:
    """Convert one or more .mtx files into a chain input directory."""
    mats = [mtx_to_block_matrix(p, k, value_map, scale) for p in mtx_paths]
    io_text.write_chain_dir(out_dir, mats, k)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert MatrixMarket files to a reference-format input directory")
    p.add_argument("mtx", nargs="+", help=".mtx or .mtx.gz files (chain order)")
    p.add_argument("out_dir")
    p.add_argument("--k", type=int, default=32)
    p.add_argument("--value-map", choices=["pattern", "scale"], default="pattern")
    p.add_argument("--scale", type=float, default=1000.0)
    args = p.parse_args(argv)
    convert_to_dir(args.mtx, args.out_dir, args.k, args.value_map, args.scale)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
