"""Plain reference of the chain product in the reference's exact arithmetic:
plain PyTorch and numpy, nothing of the program under test.

Semantics (SURVEY.md section 2.9, sparse_matrix_mult.cu:48,59-61 and
:141-156, :287-327), on uint64 values carried as the int64 with the same
bits, so that 2^64 - 1 is -1 and two's-complement add and multiply give the
unsigned low 64 bits:

    p   = a * b mod 2^64;          p   = 0 if p   == 2^64 - 1
    acc = acc + p mod 2^64;        acc = 0 if acc == 2^64 - 1

in a fixed order: each output tile (i, c) folds the pairs of A's (i, j) and
B's (j, c) in ascending j, and within a pair of tiles the inner index runs
0..k-1.  The chain is reduced as helper2 does: adjacent pairs each pass,
the odd matrix carried to the next.  No output tile is pruned.

A matrix is (coords, tiles): (n, 2) int64 block coordinates sorted by
(row, col) on the host, and (n, k, k) int64 tiles on any torch device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

ALL_ONES = -1  # 2^64 - 1 as an int64 bit pattern


@dataclass
class Join:
    """The pairs of one product C = A x B in fold order: output keys
    (n_keys, 2) sorted by (row, col); key_ptr (n_keys + 1,) so that key q
    folds pairs key_ptr[q] .. key_ptr[q + 1] - 1; pa, pb the A and B tile
    of each pair."""

    keys: np.ndarray
    key_ptr: np.ndarray
    pa: np.ndarray
    pb: np.ndarray

    @property
    def pairs(self) -> int:
        return len(self.pa)


def join(a: np.ndarray, b: np.ndarray) -> Join:
    """Every pair (A's (i, j), B's (j, c)), ordered by output key (i, c)
    and, within a key, by ascending j."""
    a = np.asarray(a, dtype=np.int64).reshape(-1, 2)
    b = np.asarray(b, dtype=np.int64).reshape(-1, 2)
    if len(a) == 0 or len(b) == 0:
        empty = np.zeros(0, np.int64)
        return Join(np.zeros((0, 2), np.int64), np.zeros(1, np.int64), empty, empty)
    n_inner = int(max(a[:, 1].max(), b[:, 0].max())) + 1
    b_count = np.bincount(b[:, 0], minlength=n_inner)
    b_start = np.concatenate([[0], np.cumsum(b_count)[:-1]])
    per_a = b_count[a[:, 1]]
    total = int(per_a.sum())
    pa = np.repeat(np.arange(len(a), dtype=np.int64), per_a)
    offset = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(per_a) - per_a, per_a)
    pb = np.repeat(b_start[a[:, 1]], per_a) + offset
    n_cols = int(b[:, 1].max()) + 1
    key = a[pa, 0] * n_cols + b[pb, 1]
    # A is sorted by (i, j), so for one key its pairs already come in
    # ascending j: a stable sort by key keeps that order
    order = np.argsort(key, kind="stable")
    key, pa, pb = key[order], pa[order], pb[order]
    starts = np.flatnonzero(np.concatenate([[True], key[1:] != key[:-1]]))
    uniq = key[starts]
    keys = np.stack([uniq // n_cols, uniq % n_cols], axis=1)
    key_ptr = np.concatenate([starts, [total]]).astype(np.int64)
    return Join(keys, key_ptr, pa, pb)


def neg_inverse(a: torch.Tensor) -> torch.Tensor:
    """-a^-1 mod 2^64 for each odd a (Newton's iteration, 3 -> 96 bits);
    meaningless where a is even."""
    x = a.clone()
    for _ in range(5):
        x = x * (2 - a * x)
    return -x


def all_ones_product(a: torch.Tensor, b: torch.Tensor, chunk: int = 4096) -> bool:
    """Whether some product a[n, r, j] * b[n, j, c] of the tile pairs is
    2^64 - 1 mod 2^64, that is a odd and b == -a^-1."""
    for lo in range(0, a.shape[0], chunk):
        x, y = a[lo:lo + chunk], b[lo:lo + chunk]
        hit = (neg_inverse(x).unsqueeze(3) == y.unsqueeze(1)) & (x & 1).bool().unsqueeze(3)
        if bool(hit.any()):
            return True
    return False


def mac_pair(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> None:
    """acc <- acc folded with the tile pairs (a, b), in place: (n, k, k)
    each, p an (n, k, k) scratch tensor.  The inner index runs 0..k-1.
    Where no product of these pairs is all ones, the product's collapse is
    the identity and acc takes a * b in one step; else every step is
    written out."""
    if not all_ones_product(a, b):
        for j in range(a.shape[-1]):
            acc.addcmul_(a[:, :, j:j + 1], b[:, j:j + 1, :])
            acc.masked_fill_(acc == ALL_ONES, 0)
        return
    for j in range(a.shape[-1]):
        torch.mul(a[:, :, j:j + 1], b[:, j:j + 1, :], out=p)
        p.masked_fill_(p == ALL_ONES, 0)
        acc.add_(p)
        acc.masked_fill_(acc == ALL_ONES, 0)


def fold(jn: Join, a_tiles: torch.Tensor, b_tiles: torch.Tensor,
         key_block: int) -> torch.Tensor:
    """The (n_keys, k, k) tiles of the product whose pairs jn lists.  Keys
    go in blocks of key_block, taken in descending pair count, so that the
    keys still folding at pair position t are a prefix of the block."""
    n_keys = len(jn.keys)
    k = a_tiles.shape[-1]
    dev = a_tiles.device
    out = torch.empty((n_keys, k, k), dtype=torch.int64, device=dev)
    if n_keys == 0:
        return out
    fanout = np.diff(jn.key_ptr)
    by_fanout = np.argsort(-fanout, kind="stable")
    pa = torch.from_numpy(jn.pa).to(dev)
    pb = torch.from_numpy(jn.pb).to(dev)
    for lo in range(0, n_keys, key_block):
        ids = by_fanout[lo:lo + key_block]
        f = fanout[ids]
        start = jn.key_ptr[ids]
        acc = torch.zeros((len(ids), k, k), dtype=torch.int64, device=dev)
        scratch = torch.empty_like(acc)
        for t in range(int(f[0])):
            n_t = int(np.count_nonzero(f > t))
            slot = torch.from_numpy(start[:n_t] + t).to(dev)
            mac_pair(acc[:n_t], a_tiles[pa[slot]], b_tiles[pb[slot]], scratch[:n_t])
        out[torch.from_numpy(ids).to(dev)] = acc
        del acc, scratch
    return out


def multiply(a: tuple, b: tuple, key_block: int = 32768) -> tuple:
    """(coords, tiles) of A x B."""
    jn = join(a[0], b[0])
    return jn.keys, fold(jn, a[1], b[1], key_block)


def chain_product(leaves: list, key_block: int = 32768) -> tuple:
    """(coords, tiles) of M1 x ... x MN with helper2's pairing; leaves is
    a list of (coords, tiles).  A partial is freed once consumed."""
    arr = list(leaves)
    if not arr:
        raise ValueError("empty chain")
    while len(arr) > 1:
        nxt = []
        for i in range(0, len(arr) - 1, 2):
            nxt.append(multiply(arr[i], arr[i + 1], key_block))
            arr[i] = arr[i + 1] = None
        if len(arr) % 2 == 1:
            nxt.append(arr[-1])
        arr = nxt
    return arr[0]
