"""The weight gradient of the block-sparse FFN: kernel 5, a hand-written CUDA
kernel for Hopper (csrc/bsmm_grad.cu), beside its plain PyTorch version
(bsmm_wgrad_ref).

Replaces no Pallas kernel.  In the JAX package the training step's weight
gradients are XLA's transposes of the einsums of bsmm_gather and
bsmm_scatter (spgemm_tpu/models/ffn.py:85,94) under jax.value_and_grad
(:204).  Contract: out[p] = A[:, ia[p]*k : +k]^T . B[:, ib[p]*k : +k], the
k x k product of two column strips summed over all M rows in float32 and
rounded once to the dtype.  dW1[c, r] is x-strip rows1[c, r] against
dpre-strip c; dW2[r, c] is h-strip r against dy-strip cols2[r, c]
(models/ffn.py).

The kernel: one block per output tile, its sums in registers for the whole
of M, which streams through shared memory in double-buffered cp.async
chunks (a ragged tail zero-filled); bf16 on mma.sync m16n8k16 with the A^T
fragments through ldmatrix.trans, float32 on plain FMA, as kernels 3 and 4.
What bounds it at the FFN's full width (P = 384 tiles, M = 8192, k = 128,
bf16): 103.1 GFLOP, 0.104 ms on the tensor cores, about as long as its
bytes take (0.100 ms); PERF.md holds its time on the card.
"""

from __future__ import annotations

import ctypes

import torch

from spgemm_tpu_torch.ops import _build
from spgemm_tpu_torch.ops.cuda_bsmm import KERNEL_KS
from spgemm_tpu_torch.utils.timers import ENGINE

_KERNEL = "bsmm_grad"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_wgrad_operands(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor,
                         ib: torch.Tensor, k: int) -> tuple[int, int]:
    """Validate the operands; returns (M, P)."""
    if a.dim() != 2 or b.dim() != 2 or ia.dim() != 1 or ib.dim() != 1:
        raise ValueError(f"want a (M, nA*k), b (M, nB*k), ia (P,), ib (P,); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(ia.shape)}, "
                         f"{tuple(ib.shape)}")
    if a.shape[0] != b.shape[0] or ia.shape != ib.shape:
        raise ValueError(f"a and b must share M and ia and ib P: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(ia.shape)}, {tuple(ib.shape)}")
    if k < 1 or a.shape[1] % k or b.shape[1] % k or not a.shape[1] or not b.shape[1]:
        raise ValueError(f"the widths {a.shape[1]} and {b.shape[1]} must be positive "
                         f"multiples of k={k}")
    if ia.dtype != torch.int32 or ib.dtype != torch.int32:
        raise TypeError(f"ia and ib must be int32, got {ia.dtype} and {ib.dtype}")
    if b.dtype != a.dtype:
        raise TypeError(f"b must have a's dtype {a.dtype}, got {b.dtype}")
    devices = {t.device for t in (a, b, ia, ib)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in (a, b, ia, ib)):
        raise ValueError("operands must be contiguous")
    return a.shape[0], ia.shape[0]


def bsmm_wgrad_ref(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
                   *, k: int) -> torch.Tensor:
    """The plain PyTorch version of kernel 5, on any device: gather the two
    strips of every pair, take the products in float32 (a float32 matmul on
    the card is TF32 only if torch.backends.cuda.matmul.allow_tf32 is set),
    cast to a.dtype.  (P, k, k)."""
    M, _ = check_wgrad_operands(a, b, ia, ib, k)
    ga = a.reshape(M, a.shape[1] // k, k).float()[:, ia.long()]   # (M, P, k)
    gb = b.reshape(M, b.shape[1] // k, k).float()[:, ib.long()]
    return torch.einsum("mpi,mpj->pij", ga, gb).to(a.dtype)


def bsmm_wgrad(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
               *, k: int) -> torch.Tensor:
    """Kernel 5: out (P, k, k) in a.dtype, out[p] = a[:, ia[p]*k : +k]^T .
    b[:, ib[p]*k : +k] over every row.  a (M, nA*k) and b (M, nB*k) in one
    dtype, ia and ib (P,) int32 below nA and nB (not checked on the card: a
    check would synchronise); any M.  On CUDA tensors it launches the kernel
    on the current stream or raises; on CPU tensors it runs bsmm_wgrad_ref."""
    M, P = check_wgrad_operands(a, b, ia, ib, k)
    if a.device.type == "cpu":
        return bsmm_wgrad_ref(a, b, ia, ib, k=k)
    if a.device.type != "cuda":
        raise ValueError(f"no bsmm_wgrad for device {a.device}")
    if a.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {a.dtype}")
    if k not in KERNEL_KS:
        raise ValueError(f"the kernel takes k in {KERNEL_KS}, got k={k}")
    if any(t.data_ptr() % 16 for t in (a, b)):
        raise ValueError("a and b must start on a 16-byte boundary")
    out = torch.empty((P, k, k), dtype=a.dtype, device=a.device)
    if P == 0:
        return out
    fn = _build.load(_KERNEL).spgemm_bsmm_wgrad
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), ia.data_ptr(), ib.data_ptr(), out.data_ptr(), M,
             a.shape[1], b.shape[1], P, k, _DTYPE_CODES[a.dtype], a.device.index, stream)
    if err != 0:
        raise RuntimeError(f"bsmm_wgrad kernel launch failed: CUDA error {err} (M={M}, "
                           f"a {tuple(a.shape)}, b {tuple(b.shape)}, P={P}, k={k}, {a.dtype})")
    ENGINE.incr("launches_bsmm_wgrad")  # the launch counter, bumped here and nowhere else
    return out
