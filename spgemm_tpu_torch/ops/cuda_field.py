"""Field-mode folds of inner and ring sharding: hand-written CUDA kernels for
Hopper (csrc/field_fold.cu) and their plain PyTorch versions.

They replace the JAX package's jitted device code of parallel/innershard.py
and parallel/ring.py (no Pallas kernel):

  field_fold          (F1) innershard.fold_pairs_field: (K, P) int32 pair
                      indices into two int64 bit-view slabs -> (K, k, k)
                      partial tiles;
  field_fold_scatter  (F3) the ring's fold of one (position, slab) list
                      (ring._ring_fold_jitted, fold_slab): C cells in CSR
                      form, cell c's pairs at pa, pb[cell_ptr[c] :
                      cell_ptr[c + 1]], each cell folded as F1 folds a key
                      and added in place into acc[rows[c]];
  addmod_field_       (F2) x <- x + y in place over (K, k, k), the step of
                      innershard.butterfly_allreduce_modadd and of its
                      ordered gather fold.

All in clean arithmetic mod 2^64 - 1 ("field mode", ops/u64.py), which is
associative: the bytes do not depend on the order of a fold.  Every result is
the canonical residue in [0, 2^64 - 2], as the JAX package's.  A slot whose pa
is a_slab's last index or whose pb is b_slab's last index (the zero sentinel
tiles) adds nothing and is skipped; P = 0 and K = 0 are legal.  small=True is
the route for operands proven below 2^32 (u64.operands_below_2_32): on the
card F1 and F3 then split each value into 4 bytes, not 8.  The caller holds
the proof; both routes give the same bits where it holds.

F1 and F3 run kernel 2's body (csrc/limb_fold.cuh): byte planes on the int8
tensor cores, one block a key or cell.  On the card they take k <= 2048
(ValueError above it; the plain versions and the JAX package take any k).
F1 has no limit on P, unlike kernel 2's wrapper (P * k <= 2^17).

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
MAX_K = 2048  # the largest tile side kernel 2's body takes
# products field_fold_ref holds at once (2^22 int64, 32 MiB, and its temporaries)
REF_CHUNK_ELEMENTS = 1 << 22


def _field_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over x's last axis under field addition, by halving: any
    order gives the same residue.  Representatives in, a representative out
    (2^64 - 1 may stand for 0)."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        half = x.shape[-1] // 2
        x = u64.addmod_field(x[..., :half], x[..., half:])
    return x[..., 0]


def field_fold_ref(a_slab: torch.Tensor, b_slab: torch.Tensor, pa: torch.Tensor,
                   pb: torch.Tensor, small: bool = False) -> torch.Tensor:
    """The plain PyTorch version of F1, on any device: for a chunk of keys
    and of their pair slots at a time, every product A[pa][i, j] *
    B[pb][j, n] mod 2^64 - 1 (zero in a sentinel slot), summed over the
    slots and j under field addition and added into the key's tile.  At
    most REF_CHUNK_ELEMENTS products are held at once."""
    k = check_operands(a_slab, b_slab, pa, pb)
    if pa.dim() != 2:
        raise ValueError(f"field_fold takes (K, P) indices, got {tuple(pa.shape)}")
    K, P = pa.shape
    real = (pa != a_slab.shape[0] - 1) & (pb != b_slab.shape[0] - 1)
    acc = torch.zeros((K, k, k), dtype=torch.int64, device=a_slab.device)
    keys = max(1, REF_CHUNK_ELEMENTS // k ** 3)
    slots = max(1, REF_CHUNK_ELEMENTS // (max(1, min(K, keys)) * k ** 3))
    for k0 in range(0, K, keys):
        rows = slice(k0, k0 + keys)
        for p0 in range(0, P, slots):
            cut = (rows, slice(p0, p0 + slots))
            at = a_slab[pa[cut].long()][..., :, :, None]  # (Kc, Pc, i, j, 1)
            bt = b_slab[pb[cut].long()][..., None, :, :]  # (Kc, Pc, 1, j, n)
            prod = at * bt if small else u64.mulmod_field(at, bt)
            prod = torch.where(real[cut][..., None, None, None], prod, 0)
            prod = prod.permute(0, 2, 4, 1, 3).flatten(3)  # (Kc, i, n, Pc * j)
            acc[rows] = u64.collapse_max(u64.addmod_field(acc[rows], _field_sum(prod)))
    return acc


def _lib_fn(name: str, n_ptr: int, n_int: int):
    """The C entry `name`: n_ptr pointers, one long long count, n_int ints,
    then the stream."""
    fn = getattr(_build.load(_KERNEL), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong]
                   + [ctypes.c_int] * n_int + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_launch(C: int, k: int, what: str) -> None:
    if C > CELL_LIMIT:
        raise ValueError(f"a field fold takes at most {CELL_LIMIT} {what} a launch, got {C}")
    if k > MAX_K:
        raise ValueError(f"the field fold kernels take k <= {MAX_K}, got k={k}")


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
    _check_launch(K, k, "keys")
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


def _check_scatter(acc: torch.Tensor, a_slab: torch.Tensor, b_slab: torch.Tensor,
                   rows: torch.Tensor, cell_ptr: torch.Tensor, pa: torch.Tensor,
                   pb: torch.Tensor) -> int:
    """check_operands on the flat pair lists, plus the accumulator, rows and
    cell_ptr; returns k."""
    if pa.dim() != 1 or pb.dim() != 1:
        raise ValueError(f"field_fold_scatter takes flat pa/pb, got {tuple(pa.shape)}/"
                         f"{tuple(pb.shape)}")
    k = check_operands(a_slab, b_slab, pa.view(-1, 1), pb.view(-1, 1))
    if acc.dtype != torch.int64 or acc.dim() != 3 or acc.shape[1:] != (k, k):
        raise ValueError(f"the accumulator must be (rows, {k}, {k}) int64, got "
                         f"{tuple(acc.shape)} {acc.dtype}")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise ValueError(f"rows must be (C,) int32, got {tuple(rows.shape)} {rows.dtype}")
    if cell_ptr.dtype != torch.int64 or cell_ptr.shape != (rows.shape[0] + 1,):
        raise ValueError(f"cell_ptr must be ({rows.shape[0] + 1},) int64, got "
                         f"{tuple(cell_ptr.shape)} {cell_ptr.dtype}")
    if {t.device for t in (acc, rows, cell_ptr)} != {pa.device}:
        raise ValueError("the accumulator, rows, cell_ptr and the operands lie on several "
                         "devices")
    if not all(t.is_contiguous() for t in (acc, rows, cell_ptr)):
        raise ValueError("the accumulator, rows and cell_ptr must be contiguous")
    return k


def field_fold_scatter_ref(acc: torch.Tensor, a_slab: torch.Tensor, b_slab: torch.Tensor,
                           rows: torch.Tensor, cell_ptr: torch.Tensor, pa: torch.Tensor,
                           pb: torch.Tensor, small: bool = False) -> torch.Tensor:
    """The plain PyTorch version of F3, on any device: pair rank r of every
    cell that has one, folded by field_fold_ref and added into acc at the
    cell's row, for r = 0, 1, ...  Returns acc."""
    _check_scatter(acc, a_slab, b_slab, rows, cell_ptr, pa, pb)
    start = cell_ptr[:-1]
    counts = cell_ptr[1:] - start
    for r in range(int(counts.max()) if counts.numel() else 0):
        live = torch.nonzero(counts > r).flatten()
        at = (start.index_select(0, live) + r)[:, None]
        folded = field_fold_ref(a_slab, b_slab, pa[at], pb[at], small=small)
        idx = rows.index_select(0, live).long()
        acc.index_copy_(0, idx, addmod_field_ref_(acc.index_select(0, idx), folded))
    return acc


def field_fold_scatter(acc: torch.Tensor, a_slab: torch.Tensor, b_slab: torch.Tensor,
                       rows: torch.Tensor, cell_ptr: torch.Tensor, pa: torch.Tensor,
                       pb: torch.Tensor, small: bool = False) -> torch.Tensor:
    """F3: C cells, cell c's pairs pa, pb[cell_ptr[c] : cell_ptr[c + 1]]
    (flat int32 indices; cell_ptr (C + 1,) int64, nondecreasing), each
    folded as field_fold folds a key and added under field addition, in
    place, into acc[rows[c]] (rows (C,) int32).  Rows must be unique within
    the call (the ring's (position, slab) lists are: a (key, slab) cell
    appears once a slab), and acc must hold canonical residues (the ring's
    starts at zero): a cell without a real pair adds nothing, and the kernel
    leaves its row as it was.  Returns acc."""
    k = _check_scatter(acc, a_slab, b_slab, rows, cell_ptr, pa, pb)
    if not _on_card(a_slab, "field fold scatter"):
        return field_fold_scatter_ref(acc, a_slab, b_slab, rows, cell_ptr, pa, pb, small=small)
    C = rows.shape[0]
    _check_launch(C, k, "cells")
    if C == 0:
        return acc
    fn = _lib_fn("spgemm_field_fold_scatter", 7, 5)
    stream = torch.cuda.current_stream(a_slab.device).cuda_stream
    err = fn(a_slab.data_ptr(), b_slab.data_ptr(), cell_ptr.data_ptr(), pa.data_ptr(),
             pb.data_ptr(), rows.data_ptr(), acc.data_ptr(), C, k, a_slab.shape[0] - 1,
             b_slab.shape[0] - 1, int(small), a_slab.device.index, stream)
    if err != 0:
        raise RuntimeError(f"field_fold_scatter kernel launch failed: CUDA error {err} "
                           f"(C={C}, pairs={pa.shape[0]}, k={k}, small={small})")
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
