"""The delta splice: a hand-written CUDA kernel for Hopper (csrc/splice.cu)
and its plain PyTorch version.

Replaces the JAX package's jitted splice, spgemm_tpu/ops/spgemm.py:
_splice_impl, `prev.at[idx].set(sub[take])` over (n, k, k) slabs: the delta
path re-folds the dirty output keys into `sub` and puts row take[i] of it at
row idx[i] of the retained previous result.  The previous result is the
answer the caller got from the last multiply, so neither version writes it:
both return a new slab.  source_map turns (idx, take) into one int64 entry
per output row (the row of sub, or -1 for prev's), which drives the
kernel's single pass; its pad slots (sub's zero row onto the sentinel row,
which prev holds as zero too) keep prev's row.

The kernel is bound by bytes: each output row is read once and written once.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spgemm_tpu_torch.ops import _build
from spgemm_tpu_torch.utils.timers import ENGINE

_KERNEL = "splice"


def source_map(idx: np.ndarray, take: np.ndarray, n_rows: int) -> np.ndarray:
    """(n_rows,) int64: take[i] at idx[i], -1 elsewhere.  A repeated idx
    keeps its last take, as numpy's assignment does; the JAX scatter writes
    the same row for each (its pad slots), so the result is the same."""
    src = np.full(n_rows, -1, np.int64)
    src[np.asarray(idx, np.int64)] = np.asarray(take, np.int64)
    return src


def _check(prev: torch.Tensor, sub: torch.Tensor, src: torch.Tensor) -> None:
    if prev.dtype != torch.int64 or sub.dtype != torch.int64 or src.dtype != torch.int64:
        raise TypeError(f"splice takes int64 tensors, got {prev.dtype}/{sub.dtype}/{src.dtype}")
    if prev.dim() < 1 or prev.shape[1:] != sub.shape[1:]:
        raise ValueError(f"prev and sub rows differ: {tuple(prev.shape)}/{tuple(sub.shape)}")
    if src.shape != (prev.shape[0],):
        raise ValueError(f"source map must be ({prev.shape[0]},), got {tuple(src.shape)}")
    if len({t.device for t in (prev, sub, src)}) != 1:
        raise ValueError("prev, sub and the source map lie on several devices")
    if not all(t.is_contiguous() for t in (prev, sub, src)):
        raise ValueError("splice operands must be contiguous")


def splice_ref(prev: torch.Tensor, sub: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: index_select of sub's rows, index_copy_
    into a clone of prev."""
    _check(prev, sub, src)
    out = prev.clone()
    rows = torch.nonzero(src >= 0).flatten()
    return out.index_copy_(0, rows, sub.index_select(0, src.index_select(0, rows)))


def splice(prev: torch.Tensor, sub: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """A new slab: row r is sub[src[r]] where src[r] >= 0, else prev[r].
    On CUDA tensors it launches the kernel on the current stream or raises;
    on CPU tensors it runs splice_ref.  src's entries must lie in sub (the
    kernel does not check them: a device-side check would synchronise)."""
    _check(prev, sub, src)
    if prev.device.type == "cpu":
        return splice_ref(prev, sub, src)
    if prev.device.type != "cuda":
        raise ValueError(f"no splice for device {prev.device}")
    out = torch.empty_like(prev)
    n_rows = prev.shape[0]
    row_elems = prev[0].numel() if n_rows else 0
    if n_rows == 0 or row_elems == 0:
        return out
    fn = _build.load(_KERNEL).spgemm_delta_splice
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int,
                                                                     ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(prev.device).cuda_stream
    err = fn(prev.data_ptr(), sub.data_ptr(), src.data_ptr(), out.data_ptr(), n_rows,
             row_elems, prev.device.index, stream)
    if err != 0:
        raise RuntimeError(f"splice kernel launch failed: CUDA error {err} "
                           f"(rows={n_rows}, row_elems={row_elems})")
    ENGINE.incr("launches_splice")  # the launch counter, bumped here only
    return out
