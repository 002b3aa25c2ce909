"""The yardstick of the fold kernels: the work a chain's inputs need, and the
least time an NVIDIA H100 SXM could take for it.

Peaks (NVIDIA's H100 SXM data sheet, 700 W): 132 SMs at a 1.98 GHz boost
clock.  The float32 rate, 67e12 FLOP/s, is 132 SMs x 128 lanes x 2 flops x
1.98e9; an SM issues 64 32-bit integer add, compare and select results a
clock, a quarter of that: 16.75e12 integer-pipe ops/s.  HBM3 moves 3.35e12
bytes/s.  A card under a lower power limit runs below these, so a share of
them is stated beside the card's limit.

Integer-pipe ops per MAC of the exact fold, 9, from the mod variant's sm_90a
SASS (csrc/numeric_round.cu): each MAC is p = a*b mod 2^64, p = 0 where p
is all ones, acc = acc + p mod 2^64, acc = 0 where acc is all ones
(SURVEY.md section 2.9).  Each of the two all-ones tests takes ISETP,
ISETP.EX, SEL and SEL (8), and the low half of the add one IADD3 (9).  The
multiply-low (three IMADs and an IMAD.IADD) and the add's carry (IMAD.X)
issue on the FMA pipe beside them, so the integer pipe bounds the fold.

The work is counted from the inputs' structure alone, the same whichever
kernel or route folds them: every real pair of tiles of every multiply of
the chain, k^3 MACs a pair; bytes are each multiply's operands read once and
its output written once, 8 bytes a value.  Medium's 3,488,611 pairs give
61.423 ms.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.reference.chain_exact import join

SMS = 132
BOOST_HZ = 1.98e9
FP32_FLOPS_PER_S = 67e12
INT_PIPE_OPS_PER_S = FP32_FLOPS_PER_S / 4
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_MAC = 9


@dataclass(frozen=True)
class Work:
    """What one chain product needs: tile pairs folded, and bytes that its
    multiplies read and write at the least."""

    pairs: int
    bytes: int
    k: int

    def scaled(self, chains: int) -> "Work":
        return Work(self.pairs * chains, self.bytes * chains, self.k)


def chain_work(leaves: list[np.ndarray], k: int) -> Work:
    """The Work of one chain over these leaves' coordinates, reduced with
    helper2's pairing."""
    arr = [np.asarray(c, dtype=np.int64) for c in leaves]
    pairs = nbytes = 0
    tile = k * k * 8
    while len(arr) > 1:
        nxt = []
        for i in range(0, len(arr) - 1, 2):
            jn = join(arr[i], arr[i + 1])
            pairs += jn.pairs
            nbytes += (len(arr[i]) + len(arr[i + 1]) + len(jn.keys)) * tile
            nxt.append(jn.keys)
        if len(arr) % 2 == 1:
            nxt.append(arr[-1])
        arr = nxt
    return Work(pairs, nbytes, k)


def least_seconds(work: Work) -> tuple[float, str]:
    """(the least time, "ops" or "bytes": the bound that sets it)."""
    ops = work.pairs * work.k ** 3 * INT_OPS_PER_MAC / INT_PIPE_OPS_PER_S
    mem = work.bytes / HBM_BYTES_PER_S
    return (ops, "ops") if ops >= mem else (mem, "bytes")
