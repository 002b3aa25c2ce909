"""The numeric round of the SpGEMM engine: a hand-written CUDA kernel for
Hopper (csrc/numeric_round.cu) and its plain PyTorch version.

Replaces the TPU kernel spgemm_tpu/ops/pallas_spgemm.py:numeric_round_pallas,
both its variants.  Contract, for each output key and element (i, n):

    acc = 0; for p in 0..P-1, skipping sentinel slots, then j in 0..k-1:
        acc = addmod(acc, mulmod(A[pa[key, p]][i, j], B[pb[key, p]][j, n]))

with the wrap-then-mod steps of SURVEY.md section 2.9, in exactly this order
(addmod is not associative).  Slabs are (n, k, k) int64 bit-views with an
all-zero sentinel tile last.  A slot whose pa is a_slab's last index or whose
pb is b_slab's last index is a sentinel slot: the kernel and the plain
version skip it, which on the planner's slabs (sentinel tile zero) is
exactly folding it, since acc is canonical and addmod(acc, 0) == acc.  The
no_mod variant folds acc = acc + A*B in plain wrapping u64 arithmetic: it
equals the mod fold only under the hybrid router's proof (ops/mxu_spgemm.
safe_exact_bound), which is where the router runs it.

The mod kernel is bound by the integer issue rate, not by bytes: each MAC is
9 instructions on the integer pipe (compares, selects, the add's low half)
beside the multiply's IMADs on the FMA pipe.  The no_mod kernel drops the
compares and selects, which leaves the FMA pipe as its bound.  Its design:
a group of threads per key walks the key's real pairs only (a pad key just
writes zeros); each thread owns a register micro-tile of the output (2x4
for mod, 4x2 for no_mod), so it has that many independent chains and loads
a row and a column of values per j; the next pair is staged into a second
shared-memory buffer with cp.async while the current one folds.  Small k
packs several keys into a block, large k makes several passes.  geometry()
reports the launch shape and the blocks per SM the card reaches.  Left for a
later PR: TMA, and a shorter instruction sequence per MAC.
"""

from __future__ import annotations

import ctypes
import math

import torch

from spgemm_tpu_torch.ops import _build, u64
from spgemm_tpu_torch.utils.timers import ENGINE

_KERNEL = "numeric_round"


def check_operands(a_slab: torch.Tensor, b_slab: torch.Tensor, pa: torch.Tensor,
           pb: torch.Tensor) -> int:
    """Validate the operands; returns k."""
    if a_slab.dtype != torch.int64 or b_slab.dtype != torch.int64:
        raise TypeError(f"slabs must be int64 bit-views, got {a_slab.dtype}/{b_slab.dtype}")
    if pa.dtype != torch.int32 or pb.dtype != torch.int32:
        raise TypeError(f"pair indices must be int32, got {pa.dtype}/{pb.dtype}")
    if a_slab.dim() != 3 or b_slab.dim() != 3:
        raise ValueError("slabs must be (n, k, k)")
    k = a_slab.shape[-1]
    if a_slab.shape[1:] != (k, k) or b_slab.shape[1:] != (k, k):
        raise ValueError(f"slab tiles must be k x k with one k, got "
                         f"{tuple(a_slab.shape)}/{tuple(b_slab.shape)}")
    if pa.shape != pb.shape or pa.dim() not in (2, 3):
        raise ValueError(f"pa/pb must share a (K, P) or (R, K, P) shape, got "
                         f"{tuple(pa.shape)}/{tuple(pb.shape)}")
    devices = {t.device for t in (a_slab, b_slab, pa, pb)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in (a_slab, b_slab, pa, pb)):
        raise ValueError("operands must be contiguous")
    return k


def numeric_round_ref(a_slab: torch.Tensor, b_slab: torch.Tensor,
                      pa: torch.Tensor, pb: torch.Tensor,
                      no_mod: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device.

    Loops over pair slots p, then j; each step gathers one (K, k, k) tile
    per operand, so memory stays O(K * k^2).  A slot whose pa is the last
    tile of a_slab or whose pb is the last tile of b_slab (the sentinels)
    leaves its keys' accumulators as they were, as the kernel skips it.  A
    stacked (R, K, P) pa/pb returns (R, K, k, k)."""
    k = check_operands(a_slab, b_slab, pa, pb)
    step = u64.mac_nomod if no_mod else u64.mac
    lead, P = pa.shape[:-1], pa.shape[-1]
    pa2, pb2 = pa.reshape(math.prod(lead), P), pb.reshape(math.prod(lead), P)
    real = (pa2 != a_slab.shape[0] - 1) & (pb2 != b_slab.shape[0] - 1)
    acc = torch.zeros((pa2.shape[0], k, k), dtype=torch.int64, device=a_slab.device)
    for p in range(P):
        at = a_slab.index_select(0, pa2[:, p])
        bt = b_slab.index_select(0, pb2[:, p])
        folded = acc
        for j in range(k):
            folded = step(folded, at[:, :, j : j + 1], bt[:, j : j + 1, :])
        acc = torch.where(real[:, p, None, None], folded, acc)
    return acc.reshape(*lead, k, k)


def numeric_round(a_slab: torch.Tensor, b_slab: torch.Tensor,
                  pa: torch.Tensor, pb: torch.Tensor,
                  no_mod: bool = False) -> torch.Tensor:
    """One numeric round: (K, P) or stacked (R, K, P) int32 indices into
    the int64 slabs -> (K, k, k) or (R, K, k, k) int64.  no_mod runs the
    variant that is exact only under the hybrid router's proof.

    On CUDA tensors it launches the kernel on the current stream or
    raises; on CPU tensors it runs numeric_round_ref.  Sentinel slots (an
    index equal to its slab's last) are skipped, see the module docstring.
    Every index must lie in the slab it indexes (the planner builds them so,
    and SpgemmPlan.check_operands ties a plan to its operands); the kernel
    does not check them, since a device-side check would synchronise each
    launch."""
    k = check_operands(a_slab, b_slab, pa, pb)
    if a_slab.device.type == "cpu":
        return numeric_round_ref(a_slab, b_slab, pa, pb, no_mod=no_mod)
    if a_slab.device.type != "cuda":
        raise ValueError(f"no numeric round for device {a_slab.device}")
    if k > 2048:
        raise ValueError(f"the kernel takes k <= 2048, got k={k}")
    lead = pa.shape[:-1]
    P = pa.shape[-1]
    K = math.prod(lead)
    out = torch.empty((*lead, k, k), dtype=torch.int64, device=a_slab.device)
    if K == 0:
        return out
    lib = _build.load(_KERNEL)
    fn = lib.spgemm_numeric_round_nomod if no_mod else lib.spgemm_numeric_round
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a_slab.device).cuda_stream
    # the sentinels: the planner's padding target, the last tile of each slab
    err = fn(a_slab.data_ptr(), b_slab.data_ptr(), pa.data_ptr(), pb.data_ptr(),
             out.data_ptr(), K, P, k, a_slab.shape[0] - 1, b_slab.shape[0] - 1,
             a_slab.device.index, stream)
    if err != 0:
        raise RuntimeError(f"numeric_round kernel launch failed: CUDA error {err} "
                           f"(K={K}, P={P}, k={k}, no_mod={no_mod})")
    # the launch counter, bumped here and nowhere else
    ENGINE.incr("launches_numeric_round_no_mod" if no_mod else "launches_numeric_round")
    return out


def geometry(k: int, no_mod: bool = False, device=None) -> dict:
    """The kernel's launch shape at k on a card: threads and keys per block,
    dynamic shared memory per block (bytes) and the blocks per SM that
    cudaOccupancyMaxActiveBlocksPerMultiprocessor reports."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"the kernel's geometry needs a CUDA device, got {dev}")
    fn = _build.load(_KERNEL).spgemm_numeric_round_geometry
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 4)()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = fn(k, int(no_mod), index, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"numeric_round geometry query failed: CUDA error {err} (k={k})")
    return {"threads": info[0], "keys_per_block": info[1], "smem_bytes": info[2],
            "blocks_per_sm": info[3]}
