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


def _collapse_max(x: torch.Tensor) -> torch.Tensor:
    """x mod (2^64 - 1) for x < 2^64: the all-ones pattern (-1) becomes 0."""
    return torch.where(x == -1, torch.zeros_like(x), x)


def mulmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's product step: ((a*b) mod 2^64) mod (2^64-1)."""
    return _collapse_max(a * b)


def addmod(acc: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The reference's accumulate step: ((acc+p) mod 2^64) mod (2^64-1)."""
    return _collapse_max(acc + p)


def mac(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One multiply-accumulate step: addmod(acc, mulmod(a, b))."""
    return addmod(acc, mulmod(a, b))
