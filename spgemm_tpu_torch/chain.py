"""Chain scheduler: order-preserving pairwise reduction of a matrix chain.

The reference's helper2() (sparse_matrix_mult.cu:287-327) halves the array
each pass, multiplying adjacent pairs left to right and carrying the odd
trailing element.  The arithmetic is not associative (SURVEY.md section 2.9),
so parity needs this exact reduction tree, not just any ordered fold.

A multiply that fails raises: there is no failover to the host oracle.
"""

from __future__ import annotations

from spgemm_tpu_torch.ops.device import ensure_device, resolve_device
from spgemm_tpu_torch.ops.spgemm import KERNELS, Folds, spgemm_device


def chain_product(matrices: list, *, device="cuda", keep_device: bool = False,
                  backend: str = "exact", folds: Folds = KERNELS):
    """Reduce [M1, ..., MN] to M1 x M2 x ... x MN with helper2's pairing.

    matrices: host BlockSparseMatrix or DeviceBlockMatrix; host matrices
    are uploaded to `device` when first multiplied, and every partial
    product stays on the device, carrying its value bound to the next
    multiply.  Returns the host result, or the DeviceBlockMatrix with
    keep_device=True.  backend and folds are forwarded to every multiply
    (ops/spgemm.spgemm_device)."""
    if not matrices:
        raise ValueError("empty chain")
    device = resolve_device(device)
    arr = list(matrices)
    while len(arr) > 1:
        nxt = []
        for i in range(0, len(arr) - 1, 2):
            # the reference's :301 progress line, printed unconditionally
            print(f"multiplying {i} {i + 1}", flush=True)
            nxt.append(spgemm_device(arr[i], arr[i + 1], device=device,
                                     backend=backend, folds=folds))
            arr[i] = arr[i + 1] = None  # free consumed partials early
        if len(arr) % 2 == 1:
            nxt.append(arr[-1])  # odd element carried (:315-321)
        arr = nxt
    result = ensure_device(arr[0], device)
    return result if keep_device else result.to_host()
