"""Synthetic block-sparse matrix generators for tests and the chip smoke run.

All values come from a numpy Generator, so one seed gives the same operands
to this package and to the JAX package.
"""

from __future__ import annotations

import numpy as np

from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix

U64MAX = 0xFFFFFFFFFFFFFFFF

# Values that exercise every wrap/mod corner of SURVEY.md section 2.9.
ADVERSARIAL_VALUES = np.array(
    [0, 1, 2, U64MAX, U64MAX - 1, U64MAX - 2,
     1 << 32, (1 << 32) - 1, (1 << 32) + 1,
     1 << 63, (1 << 63) - 1, (1 << 63) + 1,
     0xDEADBEEFCAFEBABE, 0xFFFFFFFF00000001],
    dtype=np.uint64,
)


def random_values(shape, rng: np.random.Generator, dist: str = "full") -> np.ndarray:
    """uint64 values: 'full' (uniform u64 -- wrap cases fire constantly),
    'small' (< 2^16 -- products never wrap), 'adversarial' (corner values)."""
    if dist == "full":
        return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    if dist == "small":
        return rng.integers(0, 1 << 16, size=shape, dtype=np.uint64)
    if dist == "adversarial":
        idx = rng.integers(0, len(ADVERSARIAL_VALUES), size=shape)
        return ADVERSARIAL_VALUES[idx]
    raise ValueError(dist)


def random_block_sparse(block_rows: int, block_cols: int, k: int,
                        density: float, rng: np.random.Generator,
                        dist: str = "full") -> BlockSparseMatrix:
    """Uniform-random block structure at the given block density."""
    nnzb = max(1, int(round(block_rows * block_cols * density)))
    nnzb = min(nnzb, block_rows * block_cols)
    flat = rng.choice(block_rows * block_cols, size=nnzb, replace=False)
    coords = np.stack([flat // block_cols, flat % block_cols], axis=1).astype(np.int64)
    tiles = random_values((nnzb, k, k), rng, dist)
    return BlockSparseMatrix.from_blocks(block_rows * k, block_cols * k, k, coords, tiles)


def random_chain(n: int, block_dim: int, k: int, density: float,
                 rng: np.random.Generator, dist: str = "full") -> list[BlockSparseMatrix]:
    """A multiplication-compatible chain of n square block-sparse matrices."""
    return [random_block_sparse(block_dim, block_dim, k, density, rng, dist)
            for _ in range(n)]


def banded_block_sparse(block_dim: int, k: int, bandwidth: int,
                        rng: np.random.Generator, dist: str = "full") -> BlockSparseMatrix:
    """Banded structure (nd24k-like: dense band, high SpGEMM fill-in)."""
    coords = []
    for r in range(block_dim):
        for c in range(max(0, r - bandwidth), min(block_dim, r + bandwidth + 1)):
            coords.append((r, c))
    coords = np.array(coords, dtype=np.int64)
    tiles = random_values((len(coords), k, k), rng, dist)
    return BlockSparseMatrix.from_blocks(block_dim * k, block_dim * k, k, coords, tiles)


def powerlaw_block_sparse(block_dim: int, k: int, avg_per_row: float,
                          rng: np.random.Generator, dist: str = "full",
                          alpha: float = 1.5) -> BlockSparseMatrix:
    """Power-law row degrees (webbase-like: a few very heavy rows), with
    the JAX package's draws in its order: the Zipf degrees, then each row's
    columns, then the tiles."""
    degrees = np.minimum(rng.zipf(alpha, size=block_dim), block_dim).astype(np.int64)
    scale = avg_per_row / max(degrees.mean(), 1e-9)
    degrees = np.maximum(1, (degrees * scale).astype(np.int64))
    degrees = np.minimum(degrees, block_dim)
    coords = np.array([(r, int(c)) for r in range(block_dim)
                       for c in rng.choice(block_dim, size=degrees[r], replace=False)],
                      dtype=np.int64)
    tiles = random_values((len(coords), k, k), rng, dist)
    return BlockSparseMatrix.from_blocks(block_dim * k, block_dim * k, k, coords, tiles)
