"""Block-sparse matrix container on the host (the port's copy of the JAX
package's `utils/blockcsr.py`).

A matrix is three flat arrays: sorted block coordinates plus one dense
(nnzb, k, k) uint64 tile slab -- block-COO whose sorted order makes it
block-CSR on demand.  On the device the slab becomes one int64 bit-view
tensor (ops/device.py).

Invariants:
  * coords are lexicographically sorted by (row, col) -- the std::map
    iteration order every downstream phase depends on (SURVEY.md section 2.9
    ordering).
  * duplicate coordinates: last occurrence wins (std::map operator[]
    overwrite, sparse_matrix_mult.cu:383).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class BlockSparseMatrix:
    """A block-sparse matrix of dense k x k uint64 tiles.

    rows, cols : element dimensions (as read from the file header -- only
                 carried through; the reference never validates them).
    k          : tile edge.
    coords     : (nnzb, 2) int64, sorted lexicographically by (row, col).
    tiles      : (nnzb, k, k) uint64, aligned with coords.
    """

    rows: int
    cols: int
    k: int
    coords: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int64))
    tiles: np.ndarray = field(default_factory=lambda: np.zeros((0, 0, 0), np.uint64))

    def __post_init__(self):
        self.coords = np.asarray(self.coords, dtype=np.int64).reshape(-1, 2)
        self.tiles = np.asarray(self.tiles, dtype=np.uint64)
        if self.tiles.size == 0:
            self.tiles = self.tiles.reshape(0, self.k, self.k)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_blocks(cls, rows: int, cols: int, k: int, coords, tiles,
                    assume_sorted: bool = False) -> "BlockSparseMatrix":
        """Build from parallel coord/tile arrays, sorting and deduplicating."""
        coords = np.asarray(coords, dtype=np.int64).reshape(-1, 2)
        tiles = np.asarray(tiles, dtype=np.uint64).reshape(-1, k, k)
        if not assume_sorted and len(coords) > 0:
            order = np.lexsort((coords[:, 1], coords[:, 0]))  # stable: file order kept
            coords, tiles = coords[order], tiles[order]
            # last occurrence of a duplicate key wins (std::map overwrite)
            if len(coords) > 1:
                same = np.all(coords[1:] == coords[:-1], axis=1)
                keep = np.append(~same, True)
                coords, tiles = coords[keep], tiles[keep]
        return cls(rows=rows, cols=cols, k=k, coords=coords, tiles=tiles)

    @classmethod
    def from_dict(cls, rows: int, cols: int, k: int, blocks: dict) -> "BlockSparseMatrix":
        """From {(r, c): (k,k) array} -- the oracle's working representation."""
        if not blocks:
            return cls(rows=rows, cols=cols, k=k)
        keys = sorted(blocks.keys())
        coords = np.array(keys, dtype=np.int64)
        tiles = np.stack([np.asarray(blocks[key], dtype=np.uint64) for key in keys])
        return cls(rows=rows, cols=cols, k=k, coords=coords, tiles=tiles)

    @classmethod
    def from_reference(cls, m) -> "BlockSparseMatrix":
        """Copy any object with rows/cols/k/coords/tiles (the JAX package's
        host matrix in the parity tests) into this class."""
        return cls(rows=int(m.rows), cols=int(m.cols), k=int(m.k),
                   coords=np.array(m.coords, dtype=np.int64),
                   tiles=np.array(m.tiles, dtype=np.uint64))

    # -- views --------------------------------------------------------------

    @property
    def nnzb(self) -> int:
        return len(self.coords)

    def to_dict(self) -> dict:
        return {(int(r), int(c)): self.tiles[i] for i, (r, c) in enumerate(self.coords)}

    # -- transforms ---------------------------------------------------------

    def prune_zeros(self) -> "BlockSparseMatrix":
        """Drop all-zero tiles -- the reference's C15
        (sparse_matrix_mult.cu:577-592), vectorized."""
        if self.nnzb == 0:
            return self
        keep = np.any(self.tiles != 0, axis=(1, 2))
        return BlockSparseMatrix(rows=self.rows, cols=self.cols, k=self.k,
                                 coords=self.coords[keep], tiles=self.tiles[keep])

    def __eq__(self, other) -> bool:
        if not isinstance(other, BlockSparseMatrix):
            return NotImplemented
        return (self.rows == other.rows and self.cols == other.cols
                and self.k == other.k
                and self.coords.shape == other.coords.shape
                and bool(np.all(self.coords == other.coords))
                and bool(np.all(self.tiles == other.tiles)))
