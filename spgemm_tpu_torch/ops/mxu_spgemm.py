"""Field-mode numeric round by limbs: the exactness proof, the limb splits
and the plain PyTorch version of the limb kernel (the port's counterpart of
the JAX package's `ops/mxu_spgemm.py`).

Field mode is clean arithmetic mod (2^64 - 1), which is associative, so a
round is a sum and can run as matrix products: every u64 value splits into
byte limbs, the limb products of a key's pairs are one
(La*k, P*k) @ (P*k, Lb*k) product, and an epilogue weighs each limb-product
block by 2^(8(la + lb)) and folds the total mod 2^64 - 1.  The result equals
the reference's wrap-then-mod fold wherever `safe_exact_bound` proves that
no product or partial sum reaches 2^64 - 1; the hybrid router
(ops/spgemm.py) routes a round here only then.

The router counts limbs of 7 bits, as the JAX package does (its TPU kernel
multiplied them in bf16): `limbs_for_bound` and `limbs7`.  The kernel and
this plain version split into bytes, the unsigned int8 tensor cores' unit:
`bytes_for_limbs7` gives the bytes that hold a value of that many 7-bit
limbs.

The kernel is ops/cuda_mxu.py + csrc/numeric_round_mxu.cu.
"""

from __future__ import annotations

import math

import torch

from spgemm_tpu_torch.ops import u64
from spgemm_tpu_torch.ops.cuda_spgemm import check_operands

N_LIMBS = 10          # ceil(64 / 7)
LIMB_BITS = 7
N_BYTES = 8
# Pair depth of a round, P * k, at most 2^17: every 7-bit limb-product sum
# 127^2 * P * k then stays below 2^31 (the TPU kernel's int32 accumulator),
# and every byte-limb sum 255^2 * P * k below 2^34.
MAX_PAIR_DEPTH = 1 << 17
# Elements of one limb operand in the plain version, per chunk of keys
# (2^25 float64 values, 256 MiB).
REF_CHUNK_ELEMENTS = 1 << 25


def limbs7(x: torch.Tensor, n_limbs: int = N_LIMBS) -> list[torch.Tensor]:
    """Split int64 bit-views into n_limbs limbs of 7 bits (int64, 0..127).

    Limb l holds bits [7l, 7l + 7); limb 9 is bit 63 alone.  n_limbs < 10 is
    the split of values below 2^(7 * n_limbs): higher bits are dropped."""
    out = []
    for lim in range(n_limbs):
        shift = LIMB_BITS * lim
        width = min(LIMB_BITS, 64 - shift)  # the arithmetic shift's sign copies lie above
        out.append((x >> shift) & ((1 << width) - 1))
    return out


def bytes_for_limbs7(n_limbs: int) -> int:
    """Bytes that hold a value below 2^(7 * n_limbs): ceil(7 n / 8), at
    most 8 (10 limbs hold 70 bits, a u64 64)."""
    return min(N_BYTES, -(-LIMB_BITS * n_limbs // 8))


def limbs8(x: torch.Tensor, n_bytes: int = N_BYTES) -> list[torch.Tensor]:
    """Split int64 bit-views into their n_bytes low bytes (int64, 0..255),
    byte l holding bits [8l, 8l + 8).  n_bytes < 8 is the split of values
    below 2^(8 * n_bytes): higher bits are dropped, as the kernel drops
    them."""
    return [(x >> (8 * lim)) & 0xFF for lim in range(n_bytes)]


def safe_exact_bound(a_bound: int, b_bound: int, max_fanout: int, k: int):
    """Prove field mode == the reference's fold for one multiply.

    With every scalar of A <= a_bound and of B <= b_bound, each output
    element sums at most max_fanout * k products of at most a_bound *
    b_bound.  When that total stays below 2^64 - 1, no product or partial
    sum wraps and no collapse fires, so the wrap-then-mod fold is a plain
    sum, which is what field mode computes.  Returns the output bound, or
    None when the proof fails."""
    out_bound = a_bound * b_bound * max(max_fanout, 1) * k
    return out_bound if out_bound < (1 << 64) - 1 else None


def check_mxu(a_slab, b_slab, pa, pb, a_limbs: int, b_limbs: int) -> int:
    """check_operands plus the limb kernel's own limits; returns k."""
    k = check_operands(a_slab, b_slab, pa, pb)
    for name, lim in (("a_limbs", a_limbs), ("b_limbs", b_limbs)):
        if not 1 <= lim <= N_LIMBS:
            raise ValueError(f"{name} must lie in 1..{N_LIMBS}, got {lim}")
    if pa.shape[-1] * k > MAX_PAIR_DEPTH:
        raise ValueError(f"P*k = {pa.shape[-1] * k} exceeds the int32-exact bound 2^17")
    return k


def limb_operands(at: torch.Tensor, bt: torch.Tensor, a_bytes: int, b_bytes: int):
    """Gathered tiles (c, P, k, k) -> the float64 byte-limb operands
    A (c, La*k, P*k), rows (la, i), and B (c, P*k, Lb*k), columns (lb, n)."""
    c, P, k, _ = at.shape
    A = torch.stack(limbs8(at, a_bytes), dim=1)     # (c, La, P, i, j)
    A = A.permute(0, 1, 3, 2, 4).reshape(c, a_bytes * k, P * k)
    B = torch.stack(limbs8(bt, b_bytes), dim=1)     # (c, Lb, P, j, n)
    B = B.permute(0, 2, 3, 1, 4).reshape(c, P * k, b_bytes * k)
    return A.to(torch.float64), B.to(torch.float64)


def combine_field(S: torch.Tensor, k: int, a_bytes: int, b_bytes: int) -> torch.Tensor:
    """(c, La*k, Lb*k) int64 byte-limb product sums -> (c, k, k) residues.

    Blocks of one diagonal d = la + lb share the weight 2^(8d), which is
    2^(8d mod 64) mod 2^64 - 1; each block is below 255^2 * 2^17 < 2^34, so
    a diagonal sum of at most 8 blocks is below 2^37, well inside
    mul_pow2_field's x < 2^63."""
    c = S.shape[0]
    S6 = S.reshape(c, a_bytes, k, b_bytes, k)
    acc = torch.zeros((c, k, k), dtype=torch.int64, device=S.device)
    for d in range(a_bytes + b_bytes - 1):
        diag = sum(S6[:, la, :, d - la, :]
                   for la in range(max(0, d - b_bytes + 1), min(a_bytes, d + 1)))
        acc = u64.addmod_field(acc, u64.mul_pow2_field(diag, 8 * d % 64))
    return u64.collapse_max(acc)  # the canonical residue: 2^64 - 1 is 0


def numeric_round_mxu_ref(a_slab: torch.Tensor, b_slab: torch.Tensor,
                          pa: torch.Tensor, pb: torch.Tensor,
                          a_limbs: int = N_LIMBS, b_limbs: int = N_LIMBS,
                          matmul=torch.bmm) -> torch.Tensor:
    """The plain PyTorch version of the limb kernel, on any device.

    Same contract as ops/cuda_mxu.numeric_round_mxu: (K, P) or stacked
    (R, K, P) int32 indices into (n, k, k) int64 slabs -> (K, k, k) or
    (R, K, k, k) residues mod 2^64 - 1, every value of A below
    2^(7 * a_limbs) and of B below 2^(7 * b_limbs).  It splits as the kernel
    does, into bytes_for_limbs7 bytes per operand, and skips the sentinel
    slots as the kernel does: a slot whose pa is a_slab's last index or whose
    pb is b_slab's last index adds nothing, whatever that tile holds.  The
    byte product runs in float64 (torch has no integer batched matmul on
    CUDA): every entry and partial sum is an integer below 255^2 * 2^17 <
    2^53, so it is exact.  Keys go in chunks whose limb operands hold at most
    REF_CHUNK_ELEMENTS values.  matmul is the batched product (torch.bmm), a
    parameter only so that a caller can time the product alone."""
    k = check_mxu(a_slab, b_slab, pa, pb, a_limbs, b_limbs)
    a_bytes, b_bytes = bytes_for_limbs7(a_limbs), bytes_for_limbs7(b_limbs)
    lead = pa.shape[:-1]
    P = pa.shape[-1]
    K = math.prod(lead)
    pa2, pb2 = pa.reshape(K, P), pb.reshape(K, P)
    real = (pa2 != a_slab.shape[0] - 1) & (pb2 != b_slab.shape[0] - 1)
    out = torch.empty((K, k, k), dtype=torch.int64, device=a_slab.device)
    chunk = max(1, REF_CHUNK_ELEMENTS // (max(a_bytes, b_bytes) * max(P, 1) * k * k))
    for s in range(0, K, chunk):
        e = min(K, s + chunk)
        at = a_slab.index_select(0, pa2[s:e].reshape(-1)).reshape(e - s, P, k, k)
        bt = b_slab.index_select(0, pb2[s:e].reshape(-1)).reshape(e - s, P, k, k)
        at = torch.where(real[s:e, :, None, None], at, 0)
        A, B = limb_operands(at, bt, a_bytes, b_bytes)
        out[s:e] = combine_field(matmul(A, B).to(torch.int64), k, a_bytes, b_bytes)
    return out.reshape(*lead, k, k)
