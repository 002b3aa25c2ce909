"""uint64 wrap-then-mod arithmetic on torch int64 bit-views.

torch's CPU uint64 dtype has no add, compare or gather, so every uint64 value
is carried as the int64 with the same 64 bits.  Two's-complement add and
multiply give the same low 64 bits as unsigned ones, and 2^64 - 1 is the bit
pattern of -1, so the reference's steps (sparse_matrix_mult.cu:48,59-61;
SURVEY.md section 2.9) are written out directly:

    mulmod(a, b) = ((a*b) mod 2^64) mod (2^64-1):  p = a*b; p == -1 -> 0
    addmod(a, b) = ((a+b) mod 2^64) mod (2^64-1):  s = a+b; s == -1 -> 0

addmod is not associative: callers fold terms in the reference's order.
"""

from __future__ import annotations

import numpy as np
import torch


def u64_to_t(x: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy uint64 -> torch int64 bit-view on `device`."""
    x = np.ascontiguousarray(x, dtype=np.uint64)
    return torch.from_numpy(x.view(np.int64)).to(device)


def t_to_u64(t: torch.Tensor) -> np.ndarray:
    """torch int64 bit-view (any device) -> numpy uint64."""
    return t.detach().cpu().numpy().view(np.uint64)


def collapse_max(x: torch.Tensor) -> torch.Tensor:
    """x mod (2^64 - 1) for x < 2^64: the all-ones pattern (-1) becomes 0."""
    return torch.where(x == -1, torch.zeros_like(x), x)


def mulmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's product step: ((a*b) mod 2^64) mod (2^64-1)."""
    return collapse_max(a * b)


def addmod(acc: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The reference's accumulate step: ((acc+p) mod 2^64) mod (2^64-1)."""
    return collapse_max(acc + p)


def mac(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One multiply-accumulate step: addmod(acc, mulmod(a, b))."""
    return addmod(acc, mulmod(a, b))


def mac_nomod(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mac with both collapses dropped: plain wrapping acc + a*b.

    Equals mac only while every product and partial sum stays below
    2^64 - 1 -- the proof the hybrid router holds (ops/mxu_spgemm.
    safe_exact_bound) before it runs the no_mod fold."""
    return acc + a * b


# Clean arithmetic mod (2^64 - 1), "field mode": associative, since
# 2^64 == 1 (mod 2^64 - 1).  addmod_field's values are representatives in
# [0, 2^64 - 1]; mulmod_field, mac_field and mac_field_b32 end in
# collapse_max (the JAX package's mod_max), so theirs are the canonical
# residues in [0, 2^64 - 2], the JAX package's bytes.

_SIGN = torch.iinfo(torch.int64).min  # xor with it orders int64 bit-views as unsigned


def addmod_field(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x + y) mod (2^64 - 1): the carry out of bit 63 is worth 2^64 == 1
    and comes back in at bit 0 (a sum that carried has low word <= 2^64 - 2,
    so that cannot carry again)."""
    s = x + y
    carry = (s ^ _SIGN) < (y ^ _SIGN)  # s < y read as uint64
    return s + carry.to(torch.int64)


_M32 = 0xFFFFFFFF


def _hi32(x: torch.Tensor) -> torch.Tensor:
    """The high 32 bits of int64 bit-views, as a logical shift would give."""
    return (x >> 32) & _M32


def mul64_full(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact 128-bit product a * b as (high, low) 64-bit words.  torch has
    no high-word multiply, so the high word is put together from 32-bit
    halves (the JAX package's u64.mul64_full, on 64-bit lanes): each partial
    sum below stays under 2^64, so wrapping int64 arithmetic keeps its bits."""
    al, ah, bl, bh = a & _M32, _hi32(a), b & _M32, _hi32(b)
    mid1 = ah * bl + _hi32(al * bl)   # <= (2^32 - 1)^2 + 2^32 - 1 < 2^64
    mid2 = al * bh + (mid1 & _M32)    # the same bound
    return ah * bh + _hi32(mid1) + _hi32(mid2), a * b


def mulmod_field(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod (2^64 - 1), canonical: the high word of the 128-bit
    product is worth 2^64 == 1, so it is added to the low word."""
    hi, lo = mul64_full(a, b)
    return collapse_max(addmod_field(hi, lo))


def mac_field(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc = (acc + a*b) mod (2^64 - 1), canonical."""
    return collapse_max(addmod_field(acc, mulmod_field(a, b)))


def mac_field_b32(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mac_field for operands below 2^32: their product is at most
    (2^32 - 1)^2 < 2^64 - 1, so it is its own canonical residue and the
    high word is 0; only the accumulate needs the field fold."""
    return collapse_max(addmod_field(acc, a * b))


def operands_below_2_32(*mats) -> bool:
    """True when every operand's values are below 2^32, the proof that
    licenses mac_field_b32 (the JAX package's u64.operands_below_2_32).  A
    matrix that carries a value bound (DeviceBlockMatrix.val_bound, set on a
    multiply's result) is judged by it, with no reduction on the card; a
    host matrix by its tile max; a device matrix without one by bound()."""
    for m in mats:
        if m.nnzb == 0:
            continue
        bound = getattr(m, "val_bound", None)
        if bound is None:
            bound = int(m.tiles.max()) if hasattr(m, "tiles") else m.bound()
        if bound >= 1 << 32:
            return False
    return True


def mul_pow2_field(x: torch.Tensor, s: int) -> torch.Tensor:
    """x * 2^s mod (2^64 - 1) for 0 <= x < 2^63 and 0 <= s < 64: the 64-bit
    rotation of x by s.  The low word is a wrapping multiply (int64 bit
    pattern of 2^s), the high word a shift of the non-negative x."""
    if s == 0:
        return x
    pow2 = (1 << s) if s < 63 else _SIGN
    return (x * pow2) | (x >> (64 - s))


def max_unsigned(x: torch.Tensor) -> int:
    """The largest element of int64 bit-views read as uint64 (0 when empty),
    as a python int; one reduction on x's device."""
    if x.numel() == 0:
        return 0
    return int((x ^ _SIGN).max().item() ^ _SIGN) & 0xFFFFFFFFFFFFFFFF
