"""The reference's exact arithmetic semantics, as a host-side numpy oracle.

The reference's CUDA kernel (sparse_matrix_mult.cu:48,59-61) computes, per
contraction step, in uint64 (SURVEY.md section 2.9):

    p   = (a * b) mod 2^64            # hardware wraparound on the product
    p'  = p mod (2^64 - 1)            # :59
    acc = ((acc + p') mod 2^64) mod (2^64 - 1)   # :61 -- the sum can wrap FIRST

This is not clean arithmetic mod (2^64 - 1): when `acc + p'` >= 2^64 the
wrap-then-mod result is one less than the clean modular sum, so the
reduction is order-dependent.  The order is fixed: each output tile
contracts its inner block-coordinates j in ascending order, and within each
tile pair the k-loop runs j = 0..k-1 (sparse_matrix_mult.cu:56-62,149-156).

For x < 2^64, x mod (2^64 - 1) == 0 if x == 2^64 - 1 else x, so each "mod"
is an equality test against MAX.
"""

from __future__ import annotations

import numpy as np

MAX_INT = 0xFFFFFFFFFFFFFFFF  # 2^64 - 1, the reference's modulus (:48)
MAX_U64 = np.uint64(MAX_INT)
_ZERO_U64 = np.uint64(0)


def scalar_mac(acc: int, a: int, b: int) -> int:
    """One multiply-accumulate step with the reference's exact semantics."""
    p = (a * b) & MAX_INT  # keep the low 64 bits only
    if p == MAX_INT:
        p = 0
    s = (acc + p) & MAX_INT  # the sum can also wrap at 2^64 first
    if s == MAX_INT:
        s = 0
    return s


def mulmod_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a * b) mod 2^64, then mod (2^64 - 1). uint64 arrays, broadcastable."""
    with np.errstate(over="ignore"):
        p = a * b
    return np.where(p == MAX_U64, _ZERO_U64, p)


def addmod_np(acc: np.ndarray, p: np.ndarray) -> np.ndarray:
    """((acc + p) mod 2^64) mod (2^64 - 1). uint64 arrays, broadcastable."""
    with np.errstate(over="ignore"):
        s = acc + p
    return np.where(s == MAX_U64, _ZERO_U64, s)


def tile_pair_mac_np(acc: np.ndarray, a_tile: np.ndarray, b_tile: np.ndarray) -> np.ndarray:
    """Accumulate one tile-pair product into acc (all (k,k) uint64):
    vectorized over the k x k output lanes, sequential over j."""
    k = a_tile.shape[0]
    for j in range(k):
        prod = mulmod_np(a_tile[:, j : j + 1], b_tile[j : j + 1, :])
        acc = addmod_np(acc, prod)
    return acc


def spgemm_oracle(a_blocks: dict, b_blocks: dict, k: int) -> dict:
    """Reference-semantics block-sparse matmul on dicts {(r,c): (k,k) uint64}.

    Reproduces helper()'s join and accumulation order
    (sparse_matrix_mult.cu:141-156): A's blocks in sorted (r, c) order; for
    each A block (i, j), each B block (j, c) accumulates into output (i, c).
    Does NOT prune all-zero output tiles (the reference prunes only at final
    output, :577-592)."""
    b_by_row: dict = {}
    for (br, bc) in sorted(b_blocks.keys()):
        b_by_row.setdefault(br, []).append(bc)

    out: dict = {}
    for (ar, ac) in sorted(a_blocks.keys()):
        cols = b_by_row.get(ac)
        if not cols:
            continue
        a_tile = a_blocks[(ar, ac)]
        for bc in cols:
            key = (ar, bc)
            acc = out.get(key)
            if acc is None:
                acc = np.zeros((k, k), dtype=np.uint64)
            out[key] = tile_pair_mac_np(acc, a_tile, b_blocks[(ac, bc)])
    return out


def field_spgemm_oracle(a_blocks: dict, b_blocks: dict, k: int) -> dict:
    """Clean mod-(2^64 - 1) block-sparse matmul in python ints: ground truth
    for the field-mode route (`--backend mxu`).  Order-free, because the
    clean residue arithmetic is associative; it agrees with spgemm_oracle
    exactly when no product or partial sum reaches 2^64 - 1."""
    b_by_row: dict = {}
    for (br, bc), tile in b_blocks.items():
        b_by_row.setdefault(br, []).append((bc, tile))
    out: dict = {}
    for (ar, ac), a_tile in a_blocks.items():
        a_obj = np.asarray(a_tile, np.uint64).astype(object)
        for bc, b_tile in b_by_row.get(ac, ()):
            prod = a_obj.dot(np.asarray(b_tile, np.uint64).astype(object))  # exact ints
            acc = out.get((ar, bc))
            out[(ar, bc)] = prod if acc is None else acc + prod
    return {key: (tile % MAX_INT).astype(np.uint64) for key, tile in out.items()}


def chain_oracle(matrices: list, k: int, multiply=spgemm_oracle) -> dict:
    """Pairwise-halving chain product matching helper2
    (sparse_matrix_mult.cu:287-327): adjacent pairs, the odd element carried
    to the end.  matrices: block dicts; multiply: spgemm_oracle (the
    reference's fold, which is not associative, so the tree matters) or
    field_spgemm_oracle."""
    arr = list(matrices)
    while len(arr) > 1:
        nxt = [multiply(arr[i], arr[i + 1], k) for i in range(0, len(arr) - 1, 2)]
        if len(arr) % 2 == 1:
            nxt.append(arr[-1])
        arr = nxt
    return arr[0]
