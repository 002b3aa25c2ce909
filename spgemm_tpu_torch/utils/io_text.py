"""Reference text directory format: reader + byte-identical writer.

On-disk layout (sparse_matrix_mult.cu):

  <folder>/size      "N k"                        (:410-419)
  <folder>/matrixI   I = 1..N (1-indexed, :338-345):
      rows cols                                   (:352-353)
      blocks                                      (:362-363)
      then per block:  r c                        (:364-366)
                       k lines of k values        (:372-380)

All reads are whitespace-insensitive (istream >>).  The writer is
byte-identical to the reference's (:595-608): "R C\\n", "blocks\\n", then per
tile (sorted (r, c) order) "r c\\n" and k lines of space-separated values with
no trailing space.

Reading and writing go through the native host library (utils/native.py:
a byte tokenizer and a formatter in C++, called without the GIL, so the
loader's thread pool parses files in parallel).  The numpy code below is
their plain version: the tests hold the native path against it, and
SPGEMM_TPU_NO_NATIVE=1 selects it.  Either way a missing file raises
FileNotFoundError and a malformed or truncated one ValueError.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from spgemm_tpu_torch.utils import native
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix


def read_size(folder: str) -> tuple[int, int]:
    """Read `<folder>/size` -> (N, k).  (sparse_matrix_mult.cu:410-419)"""
    path = os.path.join(folder, "size")
    with open(path) as f:
        toks = f.read().split()
    if len(toks) < 2:
        raise ValueError(f"malformed size file: {path!r}")
    return int(toks[0]), int(toks[1])


def read_matrix(path: str, k: int) -> BlockSparseMatrix:
    """Parse one matrix file with the native tokenizer (read_matrix_plain
    under SPGEMM_TPU_NO_NATIVE=1)."""
    if not native.enabled():
        return read_matrix_plain(path, k)
    rows, cols, coords, tiles = native.parse_matrix(path, k)
    return BlockSparseMatrix.from_blocks(rows, cols, k, coords, tiles)


def read_matrix_plain(path: str, k: int) -> BlockSparseMatrix:
    """The plain version of read_matrix: everything after the 3-token header
    is one uint64 parse + reshape to (blocks, 2 + k*k)."""
    with open(path, "rb") as f:
        toks = f.read().split()
    if len(toks) < 3:
        raise ValueError(f"malformed matrix file: {path!r}")
    rows, cols, blocks = int(toks[0]), int(toks[1]), int(toks[2])
    per = 2 + k * k
    need = 3 + blocks * per
    if len(toks) < need:
        raise ValueError(
            f"matrix file {path!r}: expected {need} tokens for {blocks} blocks, got {len(toks)}")
    if blocks == 0:
        return BlockSparseMatrix(rows=rows, cols=cols, k=k)
    try:
        flat = np.array(toks[3:need], dtype=np.uint64).reshape(blocks, per)
    except (ValueError, OverflowError) as e:
        raise ValueError(f"malformed matrix file {path!r}: {e}") from e
    coords = flat[:, :2].astype(np.int64)
    tiles = flat[:, 2:].reshape(blocks, k, k)
    return BlockSparseMatrix.from_blocks(rows, cols, k, coords, tiles)


def read_chain(folder: str, start: int, end: int, k: int,
               max_workers: int | None = None) -> list[BlockSparseMatrix]:
    """Load matrix{start+1}..matrix{end+1} (0-based range, 1-indexed files,
    sparse_matrix_mult.cu:338-345) concurrently -- the reference's OpenMP
    task-per-file pattern (:334-341) as a thread pool.  The native parser
    runs without the GIL, so the pool's threads parse files in parallel.

    max_workers=None picks min(16, 4x host cores); an explicit value is
    honored as given (outputs are identical either way)."""
    if max_workers is None:
        max_workers = min(16, 4 * (os.cpu_count() or 1))
    paths = [os.path.join(folder, f"matrix{i}") for i in range(start + 1, end + 2)]
    with ThreadPoolExecutor(max_workers=max(1, max_workers)) as pool:
        return list(pool.map(lambda p: read_matrix(p, k), paths))


def format_matrix(m: BlockSparseMatrix) -> bytes:
    """Serialize in the reference writer's exact byte format
    (sparse_matrix_mult.cu:595-608)."""
    out = [f"{m.rows} {m.cols}\n{m.nnzb}\n"]
    coords = m.coords
    for i in range(m.nnzb):
        out.append(f"{coords[i, 0]} {coords[i, 1]}\n")
        for row in m.tiles[i].tolist():  # tolist() converts u64 exactly
            out.append(" ".join(map(str, row)))
            out.append("\n")
    return "".join(out).encode()


def write_matrix(path: str, m: BlockSparseMatrix) -> None:
    """Write `m` to `path` byte-identically to the reference (C16), with
    the native formatter (format_matrix under SPGEMM_TPU_NO_NATIVE=1).  The
    reference prunes all-zero tiles before writing; callers do that via
    m.prune_zeros()."""
    if native.enabled():
        native.write_matrix(path, m.rows, m.cols, m.k, m.coords, m.tiles)
        return
    with open(path, "wb") as f:
        f.write(format_matrix(m))


def write_chain_dir(folder: str, matrices: list[BlockSparseMatrix], k: int) -> None:
    """Emit a full input directory (size + matrix1..matrixN)."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "size"), "w") as f:
        f.write(f"{len(matrices)} {k}\n")
    for i, m in enumerate(matrices):
        write_matrix(os.path.join(folder, f"matrix{i + 1}"), m)
