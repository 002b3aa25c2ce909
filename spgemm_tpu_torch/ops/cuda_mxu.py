"""The field-mode limb kernel: a hand-written CUDA kernel for Hopper
(csrc/numeric_round_mxu.cu) beside its plain PyTorch version
(ops/mxu_spgemm.numeric_round_mxu_ref).

Replaces the TPU kernel spgemm_tpu/ops/pallas_mxu.py:numeric_round_mxu_pallas.
Contract: for each output key and element (i, n), the sum over the key's
pairs p and j of A[pa[key, p]][i, j] * B[pb[key, p]][j, n] mod 2^64 - 1, as
the canonical residue, computed through a_limbs x b_limbs 7-bit limbs
(ops/mxu_spgemm.py); rounds keep P * k <= 2^17.

The kernel is bound by operations: a_limbs * b_limbs * k^3 int8 MACs per
tile pair on the tensor cores (mma.sync m16n8k32), one block of 8 warps per
key, limb planes staged as bytes in shared memory, one s32 fragment per
limb diagonal, the mod-(2^64 - 1) epilogue fused.
"""

from __future__ import annotations

import ctypes
import math

import torch

from spgemm_tpu_torch.ops import _build
from spgemm_tpu_torch.ops.mxu_spgemm import N_LIMBS, check_mxu, numeric_round_mxu_ref

# Launches of the CUDA kernel, counted where it launches and nowhere else.
launches = 0

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
    2^(7 * b_limbs).  Raises ValueError when P * k > 2^17.  On CUDA tensors
    it launches the kernel on the current stream or raises; on CPU tensors
    it runs numeric_round_mxu_ref.  Indices are not checked on the card (see
    cuda_spgemm.numeric_round)."""
    global launches
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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a_slab.device).cuda_stream
    err = fn(a_slab.data_ptr(), b_slab.data_ptr(), pa.data_ptr(), pb.data_ptr(),
             out.data_ptr(), K, P, k, a_limbs, b_limbs, a_slab.device.index, stream)
    if err != 0:
        raise RuntimeError(f"numeric_round_mxu kernel launch failed: CUDA error {err} "
                           f"(K={K}, P={P}, k={k}, limbs {a_limbs}x{b_limbs})")
    launches += 1
    return out
