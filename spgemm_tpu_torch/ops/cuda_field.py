"""Field-mode folds of inner and ring sharding: hand-written CUDA kernels for
Hopper (csrc/field_fold.cu) and their plain PyTorch versions.

They replace the JAX package's jitted device code of parallel/innershard.py
and parallel/ring.py (no Pallas kernel):

  field_fold          (F1) innershard.fold_pairs_field: (K, P) int32 pair
                      indices into two int64 bit-view slabs -> (K, k, k)
                      partial tiles;
  field_fold_scatter  (F3) the ring's trip (ring._ring_fold_jitted,
                      fold_slab): each compacted cell's pairs folded as F1
                      does, then added in place into acc[rows[c]];
  addmod_field_       (F2) x <- x + y in place over (K, k, k), the step of
                      innershard.butterfly_allreduce_modadd and of its
                      ordered gather fold.

All in clean arithmetic mod 2^64 - 1 ("field mode", ops/u64.py), which is
associative: the bytes do not depend on the order of a fold.  Every result is
the canonical residue in [0, 2^64 - 2], as the JAX package's.  A slot whose pa
is a_slab's last index or whose pb is b_slab's last index (the zero sentinel
tiles) adds nothing and is skipped; P = 0 and K = 0 are legal.  small=True is
the route for operands proven below 2^32 (u64.operands_below_2_32): the
product needs no high word.  The caller holds the proof; both routes give the
same bits where it holds.

On CUDA tensors each function launches its kernel on the current stream or
raises; on CPU tensors it runs the plain version.  Each wrapper bumps its
ENGINE counter (`launches_field_fold`, `launches_field_fold_scatter`,
`launches_field_add`) where it launches and nowhere else.  The kernels do not
check indices: a device-side check would synchronise each launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from spgemm_tpu_torch.ops import _build, u64
from spgemm_tpu_torch.ops.cuda_spgemm import check_operands
from spgemm_tpu_torch.utils.timers import ENGINE

_KERNEL = "field_fold"
CELL_LIMIT = (1 << 31) - 1  # one block a cell: the grid's x extent


def _pairs2d(pa: torch.Tensor, pb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A rank list's (C,) indices as (C, 1); (C, P) as they are."""
    return (pa[:, None], pb[:, None]) if pa.dim() == 1 else (pa, pb)


def field_fold_ref(a_slab: torch.Tensor, b_slab: torch.Tensor, pa: torch.Tensor,
                   pb: torch.Tensor, small: bool = False) -> torch.Tensor:
    """The plain PyTorch version of F1, on any device: loops over pair slots
    p, then j, each step on (K, k, k) tiles."""
    k = check_operands(a_slab, b_slab, pa, pb)
    if pa.dim() != 2:
        raise ValueError(f"field_fold takes (K, P) indices, got {tuple(pa.shape)}")
    step = u64.mac_field_b32 if small else u64.mac_field
    K, P = pa.shape
    real = (pa != a_slab.shape[0] - 1) & (pb != b_slab.shape[0] - 1)
    acc = torch.zeros((K, k, k), dtype=torch.int64, device=a_slab.device)
    for p in range(P):
        at = a_slab.index_select(0, pa[:, p])
        bt = b_slab.index_select(0, pb[:, p])
        folded = acc
        for j in range(k):
            folded = step(folded, at[:, :, j : j + 1], bt[:, j : j + 1, :])
        acc = torch.where(real[:, p, None, None], folded, acc)
    return acc


def _lib_fn(name: str, n_ptr: int, n_int: int):
    """The C entry `name`: n_ptr pointers, one long long count, n_int ints,
    then the stream."""
    fn = getattr(_build.load(_KERNEL), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong]
                   + [ctypes.c_int] * n_int + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _on_card(t: torch.Tensor, what: str) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA one;
    raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {what} for device {t.device}")
    return True


def field_fold(a_slab: torch.Tensor, b_slab: torch.Tensor, pa: torch.Tensor,
               pb: torch.Tensor, small: bool = False) -> torch.Tensor:
    """F1: (K, P) int32 indices into the int64 slabs -> (K, k, k) int64
    partial tiles in field mode.  small: both slabs' values are below 2^32
    (the caller's proof)."""
    k = check_operands(a_slab, b_slab, pa, pb)
    if not _on_card(a_slab, "field fold"):
        return field_fold_ref(a_slab, b_slab, pa, pb, small=small)
    if pa.dim() != 2:
        raise ValueError(f"field_fold takes (K, P) indices, got {tuple(pa.shape)}")
    K, P = pa.shape
    if K > CELL_LIMIT:
        raise ValueError(f"field_fold takes at most {CELL_LIMIT} keys a launch, got {K}")
    out = torch.empty((K, k, k), dtype=torch.int64, device=a_slab.device)
    if K == 0:
        return out
    fn = _lib_fn("spgemm_field_fold", 5, 6)
    stream = torch.cuda.current_stream(a_slab.device).cuda_stream
    err = fn(a_slab.data_ptr(), b_slab.data_ptr(), pa.data_ptr(), pb.data_ptr(),
             out.data_ptr(), K, P, k, a_slab.shape[0] - 1, b_slab.shape[0] - 1, int(small),
             a_slab.device.index, stream)
    if err != 0:
        raise RuntimeError(f"field_fold kernel launch failed: CUDA error {err} "
                           f"(K={K}, P={P}, k={k}, small={small})")
    ENGINE.incr("launches_field_fold")  # the launch counter, bumped here only
    return out


def _check_acc(acc: torch.Tensor, k: int, rows: torch.Tensor, pa: torch.Tensor) -> None:
    if acc.dtype != torch.int64 or acc.dim() != 3 or acc.shape[1:] != (k, k):
        raise ValueError(f"the accumulator must be (rows, {k}, {k}) int64, got "
                         f"{tuple(acc.shape)} {acc.dtype}")
    if rows.dtype != torch.int32 or rows.shape != pa.shape[:1]:
        raise ValueError(f"rows must be ({pa.shape[0]},) int32, got {tuple(rows.shape)} "
                         f"{rows.dtype}")
    if acc.device != pa.device or rows.device != pa.device:
        raise ValueError("the accumulator, rows and the operands lie on several devices")
    if not (acc.is_contiguous() and rows.is_contiguous()):
        raise ValueError("the accumulator and rows must be contiguous")


def field_fold_scatter_ref(acc: torch.Tensor, a_slab: torch.Tensor, b_slab: torch.Tensor,
                           rows: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                           small: bool = False) -> torch.Tensor:
    """The plain PyTorch version of F3: field_fold_ref of the cells, then
    each added into acc[rows[c]] in place, the dummy row (acc's last) never
    written.  Returns acc."""
    pa, pb = _pairs2d(pa, pb)
    k = check_operands(a_slab, b_slab, pa, pb)
    _check_acc(acc, k, rows, pa)
    keep = torch.nonzero(rows != acc.shape[0] - 1).flatten()
    folded = field_fold_ref(a_slab, b_slab, pa.index_select(0, keep), pb.index_select(0, keep),
                            small=small)
    idx = rows.index_select(0, keep).long()
    acc.index_copy_(0, idx, addmod_field_ref_(acc.index_select(0, idx), folded))
    return acc


def field_fold_scatter(acc: torch.Tensor, a_slab: torch.Tensor, b_slab: torch.Tensor,
                       rows: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                       small: bool = False) -> torch.Tensor:
    """F3: the cells' (C,) or (C, P_t) int32 pair indices folded as
    field_fold does and each tile added under field addition, in place, into
    acc[rows[c]]; cells whose row is acc's last (the plan's dummy row k_max)
    are skipped.  rows must be unique apart from the dummy row (the ring plan
    builds them so).  Returns acc."""
    pa, pb = _pairs2d(pa, pb)
    k = check_operands(a_slab, b_slab, pa, pb)
    _check_acc(acc, k, rows, pa)
    if not _on_card(a_slab, "field fold scatter"):
        return field_fold_scatter_ref(acc, a_slab, b_slab, rows, pa, pb, small=small)
    C, P = pa.shape
    if C > CELL_LIMIT:
        raise ValueError(f"field_fold_scatter takes at most {CELL_LIMIT} cells, got {C}")
    if C == 0:
        return acc
    fn = _lib_fn("spgemm_field_fold_scatter", 6, 7)
    stream = torch.cuda.current_stream(a_slab.device).cuda_stream
    err = fn(a_slab.data_ptr(), b_slab.data_ptr(), pa.data_ptr(), pb.data_ptr(),
             rows.data_ptr(), acc.data_ptr(), C, P, k, a_slab.shape[0] - 1,
             b_slab.shape[0] - 1, acc.shape[0] - 1, int(small), a_slab.device.index, stream)
    if err != 0:
        raise RuntimeError(f"field_fold_scatter kernel launch failed: CUDA error {err} "
                           f"(C={C}, P={P}, k={k}, small={small})")
    ENGINE.incr("launches_field_fold_scatter")  # the launch counter, bumped here only
    return acc


def _check_add(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dtype != torch.int64 or y.dtype != torch.int64:
        raise TypeError(f"addmod_field_ takes int64 bit-views, got {x.dtype}/{y.dtype}")
    if x.shape != y.shape or x.device != y.device:
        raise ValueError(f"addmod_field_ takes two tensors of one shape on one device, got "
                         f"{tuple(x.shape)} on {x.device} and {tuple(y.shape)} on {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("addmod_field_ operands must be contiguous")


def addmod_field_ref_(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of F2: x <- (x + y) mod (2^64 - 1),
    canonical, in place.  Returns x."""
    _check_add(x, y)
    return x.copy_(u64.collapse_max(u64.addmod_field(x, y)))


def addmod_field_(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """F2: x <- (x + y) mod (2^64 - 1), canonical, in place, over any shape.
    Returns x."""
    _check_add(x, y)
    if not _on_card(x, "field add"):
        return addmod_field_ref_(x, y)
    n = math.prod(x.shape)
    if n == 0:
        return x
    fn = _lib_fn("spgemm_field_add", 2, 1)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), n, x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"field_add kernel launch failed: CUDA error {err} (n={n})")
    ENGINE.incr("launches_field_add")  # the launch counter, bumped here only
    return x
