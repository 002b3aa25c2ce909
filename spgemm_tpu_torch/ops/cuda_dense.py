"""The segmented stream fold of the dense accumulator route: a hand-written
CUDA kernel for Hopper (csrc/numeric_round_dense.cu) and its plain PyTorch
version.

Replaces the JAX package's jitted fold spgemm_tpu/ops/spgemm.py:
numeric_round_dense_impl.  Contract: (L,) int32 slab indices pa, pb and an
(L,) int32 output row per slot, seg, each entry in [0, n_rows]; for each
output row r and element (i, n), r's slots are folded in stream order, j
ascending inside each pair, with the wrap-then-mod steps of SURVEY.md
section 2.9:

    acc = 0; for each slot s with seg[s] == r, in stream order, then j:
        acc = addmod(acc, mulmod(A[pa[s]][i, j], B[pb[s]][j, n]))

Slots with seg == n_rows are the JAX function's scratch row and touch no
real row; sentinel slots (pa the last tile of a_slab or pb the last of
b_slab) are skipped, which on the planner's slabs, whose sentinel tile is
zero, is folding them.  Rows with no slot come out zero.  Result: (n_rows,
k, k) int64 bit-views.

row_ptr, the planner's (n_rows + 1,) int64 row offsets, says that row r's
slots are the run [row_ptr[r], row_ptr[r + 1]) of the stream as it is (the
planner's contiguous layout).  Without it the slots are ordered by a stable
sort of seg, which keeps each row's stream order, and the offsets are a
searchsorted over the sorted rows, so any seg gives the JAX function's
result.  The fold is always the mod fold: the dense route never runs under
the hybrid router's no_mod proof.
"""

from __future__ import annotations

import ctypes

import torch

from spgemm_tpu_torch.ops import _build, u64
from spgemm_tpu_torch.utils.timers import ENGINE

_KERNEL = "numeric_round_dense"


def _check(a_slab, b_slab, pa, pb, seg, n_rows: int, row_ptr) -> int:
    """Validate the operands; returns k."""
    if a_slab.dtype != torch.int64 or b_slab.dtype != torch.int64:
        raise TypeError(f"slabs must be int64 bit-views, got {a_slab.dtype}/{b_slab.dtype}")
    if pa.dtype != torch.int32 or pb.dtype != torch.int32 or seg.dtype != torch.int32:
        raise TypeError(f"pa, pb and seg must be int32, got {pa.dtype}/{pb.dtype}/{seg.dtype}")
    if a_slab.dim() != 3 or b_slab.dim() != 3:
        raise ValueError("slabs must be (n, k, k)")
    k = a_slab.shape[-1]
    if a_slab.shape[1:] != (k, k) or b_slab.shape[1:] != (k, k):
        raise ValueError(f"slab tiles must be k x k with one k, got "
                         f"{tuple(a_slab.shape)}/{tuple(b_slab.shape)}")
    if pa.dim() != 1 or pa.shape != pb.shape or pa.shape != seg.shape:
        raise ValueError(f"pa, pb and seg must share one (L,) shape, got "
                         f"{tuple(pa.shape)}/{tuple(pb.shape)}/{tuple(seg.shape)}")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    operands = [a_slab, b_slab, pa, pb, seg]
    if row_ptr is not None:
        if row_ptr.dtype != torch.int64 or row_ptr.shape != (n_rows + 1,):
            raise ValueError(f"row_ptr must be ({n_rows + 1},) int64, got "
                             f"{tuple(row_ptr.shape)} {row_ptr.dtype}")
        operands.append(row_ptr)
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("operands must be contiguous")
    return k


def _row_runs(pa, pb, seg, n_rows: int, row_ptr):
    """(pa, pb, row_ptr) with each row's slots one run in stream order:
    as given where row_ptr is given, else stably sorted by seg."""
    if row_ptr is not None:
        return pa, pb, row_ptr
    order = torch.sort(seg, stable=True).indices
    rows = torch.arange(n_rows + 1, dtype=torch.int32, device=seg.device)
    return (pa.index_select(0, order), pb.index_select(0, order),
            torch.searchsorted(seg.index_select(0, order), rows))


def numeric_round_dense_ref(a_slab: torch.Tensor, b_slab: torch.Tensor, pa: torch.Tensor,
                            pb: torch.Tensor, seg: torch.Tensor, n_rows: int,
                            row_ptr: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device: each row's
    slots as one run (_row_runs), then a loop over t, folding every row's
    t-th slot at once, as numeric_round_ref folds every key's p-th slot.
    Each row keeps its stream order, so this is the sequential stream fold."""
    k = _check(a_slab, b_slab, pa, pb, seg, n_rows, row_ptr)
    pa, pb, row_ptr = _row_runs(pa, pb, seg, n_rows, row_ptr)
    acc = torch.zeros((n_rows, k, k), dtype=torch.int64, device=a_slab.device)
    if n_rows == 0:
        return acc
    start, lens = row_ptr[:-1], row_ptr[1:] - row_ptr[:-1]
    last = max(pa.shape[0] - 1, 0)
    for t in range(int(lens.max())):
        slot = torch.clamp(start + t, max=last)
        ia, ib = pa.index_select(0, slot), pb.index_select(0, slot)
        real = (lens > t) & (ia != a_slab.shape[0] - 1) & (ib != b_slab.shape[0] - 1)
        at, bt = a_slab.index_select(0, ia), b_slab.index_select(0, ib)
        folded = acc
        for j in range(k):
            folded = u64.mac(folded, at[:, :, j : j + 1], bt[:, j : j + 1, :])
        acc = torch.where(real[:, None, None], folded, acc)
    return acc


def numeric_round_dense(a_slab: torch.Tensor, b_slab: torch.Tensor, pa: torch.Tensor,
                        pb: torch.Tensor, seg: torch.Tensor, n_rows: int,
                        row_ptr: torch.Tensor | None = None) -> torch.Tensor:
    """One dense round -> (n_rows, k, k) int64 (see the module docstring).

    On CUDA tensors it launches the kernel on the current stream or raises;
    on CPU tensors it runs numeric_round_dense_ref.  Every index must lie in
    the slab it indexes, and a given row_ptr must be non-decreasing and end
    within the stream (the planner builds them so); the kernel does not
    check them, since a device-side check would synchronise each launch."""
    k = _check(a_slab, b_slab, pa, pb, seg, n_rows, row_ptr)
    if a_slab.device.type == "cpu":
        return numeric_round_dense_ref(a_slab, b_slab, pa, pb, seg, n_rows, row_ptr)
    if a_slab.device.type != "cuda":
        raise ValueError(f"no dense round for device {a_slab.device}")
    if k > 2048:
        raise ValueError(f"the kernel takes k <= 2048, got k={k}")
    out = torch.empty((n_rows, k, k), dtype=torch.int64, device=a_slab.device)
    if n_rows == 0:
        return out
    pa, pb, row_ptr = _row_runs(pa, pb, seg, n_rows, row_ptr)
    fn = _build.load(_KERNEL).spgemm_numeric_round_dense
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a_slab.device).cuda_stream
    err = fn(a_slab.data_ptr(), b_slab.data_ptr(), pa.data_ptr(), pb.data_ptr(),
             row_ptr.data_ptr(), out.data_ptr(), n_rows, k, a_slab.shape[0] - 1,
             b_slab.shape[0] - 1, a_slab.device.index, stream)
    if err != 0:
        raise RuntimeError(f"numeric_round_dense kernel launch failed: CUDA error {err} "
                           f"(n_rows={n_rows}, L={pa.shape[0]}, k={k})")
    ENGINE.incr("launches_dense_fold")  # the launch counter, bumped here only
    return out
