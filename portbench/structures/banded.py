"""Banded block structure (SuiteSparse nd24k's dense band, high SpGEMM
fill-in): a chain of `n` square matrices of `block_dim` block rows, each
block row holding the tiles within `bandwidth` of the diagonal.

The same structure as the port's `utils/gen.banded_block_sparse`, built
here from the coordinates alone: values are drawn on the card per request
(leaves.py), so no tile is made on the host.
"""

from __future__ import annotations

import numpy as np


def band(block_dim: int, bandwidth: int) -> np.ndarray:
    """(nnzb, 2) int64 block coordinates of one banded matrix, sorted by
    (row, col)."""
    rows = np.repeat(np.arange(block_dim, dtype=np.int64), 2 * bandwidth + 1)
    cols = rows + np.tile(np.arange(-bandwidth, bandwidth + 1, dtype=np.int64), block_dim)
    keep = (cols >= 0) & (cols < block_dim)
    return np.stack([rows[keep], cols[keep]], axis=1)


def build(params: dict) -> list[np.ndarray]:
    """The chain's leaves' coordinates: `n` copies of one band."""
    coords = band(int(params["block_dim"]), int(params["bandwidth"]))
    return [coords for _ in range(int(params["n"]))]
