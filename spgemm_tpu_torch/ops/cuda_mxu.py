"""The field-mode limb kernel: a hand-written CUDA kernel for Hopper
(csrc/numeric_round_mxu.cu) beside its plain PyTorch version
(ops/mxu_spgemm.numeric_round_mxu_ref).

Replaces the TPU kernel spgemm_tpu/ops/pallas_mxu.py:numeric_round_mxu_pallas.
Contract: for each output key and element (i, n), the sum over the key's
real pairs p and j of A[pa[key, p]][i, j] * B[pb[key, p]][j, n] mod
2^64 - 1, as the canonical residue, every value of A below 2^(7 * a_limbs)
and of B below 2^(7 * b_limbs) (the router's 7-bit limb counts); rounds keep
P * k <= 2^17.  A slot whose pa is a_slab's last index or whose pb is
b_slab's last index (the sentinels) is skipped, as kernel 1 skips it.

The kernel is bound by operations: a_bytes * b_bytes * k^3 int8 MACs per
real tile pair on the tensor cores (mma.sync m16n8k32 u8), where a_bytes =
bytes_for_limbs7(a_limbs): each u64 splits into its bytes by byte permutes.
One block of 8 warps per key walks the key's real pairs; the next tile pair
comes in by cp.async while the current one is split into byte planes and
multiplied; one s32 fragment per rotation class (la + lb) mod 8, the
mod-(2^64 - 1) epilogue fused; three or four blocks share an SM.
geometry() reports the launch shape and the blocks per SM the card reaches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from spgemm_tpu_torch.ops import _build
from spgemm_tpu_torch.ops.mxu_spgemm import (N_LIMBS, bytes_for_limbs7, check_mxu,
                                             numeric_round_mxu_ref)
from spgemm_tpu_torch.utils.timers import ENGINE

_KERNEL = "numeric_round_mxu"


def limbs_for_bound(val_bound: int | None) -> int:
    """Limbs needed to represent values <= val_bound (7 bits per limb)."""
    if val_bound is None:
        return N_LIMBS
    return min(N_LIMBS, max(1, -(-int(val_bound).bit_length() // 7)))


def numeric_round_mxu(a_slab: torch.Tensor, b_slab: torch.Tensor,
                      pa: torch.Tensor, pb: torch.Tensor,
                      a_limbs: int = N_LIMBS, b_limbs: int = N_LIMBS) -> torch.Tensor:
    """One field-mode round: (K, P) or stacked (R, K, P) int32 indices into
    the int64 slabs -> (K, k, k) or (R, K, k, k) residues mod 2^64 - 1.

    Every value of A must be below 2^(7 * a_limbs), of B below
    2^(7 * b_limbs).  Sentinel slots (an index equal to its slab's last) are
    skipped.  Raises ValueError when P * k > 2^17.  On CUDA tensors it
    launches the kernel on the current stream or raises; on CPU tensors it
    runs numeric_round_mxu_ref.  Indices are not checked on the card (see
    cuda_spgemm.numeric_round)."""
    k = check_mxu(a_slab, b_slab, pa, pb, a_limbs, b_limbs)
    if a_slab.device.type == "cpu":
        return numeric_round_mxu_ref(a_slab, b_slab, pa, pb, a_limbs, b_limbs)
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
    fn = lib.spgemm_numeric_round_mxu
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a_slab.device).cuda_stream
    # the sentinels: the planner's padding target, the last tile of each slab
    err = fn(a_slab.data_ptr(), b_slab.data_ptr(), pa.data_ptr(), pb.data_ptr(),
             out.data_ptr(), K, P, k, bytes_for_limbs7(a_limbs), bytes_for_limbs7(b_limbs),
             a_slab.shape[0] - 1, b_slab.shape[0] - 1, a_slab.device.index, stream)
    if err != 0:
        raise RuntimeError(f"numeric_round_mxu kernel launch failed: CUDA error {err} "
                           f"(K={K}, P={P}, k={k}, limbs {a_limbs}x{b_limbs})")
    ENGINE.incr("launches_numeric_round_mxu")  # the launch counter, bumped here only
    return out


def geometry(k: int, a_limbs: int = N_LIMBS, b_limbs: int = N_LIMBS, device=None) -> dict:
    """The kernel's launch shape for a_limbs x b_limbs 7-bit limbs at k on a
    card: threads per block, dynamic shared memory per block (bytes), the
    byte counts of the instance that runs them and the blocks per SM that
    cudaOccupancyMaxActiveBlocksPerMultiprocessor reports.  The shape is the
    same at every k the kernel takes (one key a block, 32 x 32 regions)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"the kernel's geometry needs a CUDA device, got {dev}")
    if not 1 <= k <= 2048:
        raise ValueError(f"the kernel takes k in 1..2048, got k={k}")
    a_bytes, b_bytes = bytes_for_limbs7(a_limbs), bytes_for_limbs7(b_limbs)
    fn = _build.load(_KERNEL).spgemm_numeric_round_mxu_geometry
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 3)()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = fn(a_bytes, b_bytes, index, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"numeric_round_mxu geometry query failed: CUDA error {err} "
                           f"(limbs {a_limbs}x{b_limbs})")
    return {"threads": info[0], "smem_bytes": info[1], "bytes": (a_bytes, b_bytes),
            "blocks_per_sm": info[2]}
