"""SpGEMM engine: one C = A x B with the reference's exact fold, tiles staying
on the device (the port's counterpart of the JAX package's `ops/spgemm.py`).

Two phases:

  1. plan (host, ops/symbolic.py): sorted merge-join -> output structure,
     fanout-class rounds of (K, P) pair indices, assembly permutation.
  2. execute (device): one numeric launch per round (ops/cuda_spgemm.py,
     the hand-written CUDA kernel on the card), then one gather that puts
     the round outputs in key order with the sentinel zero tile last.

Round budget on the card: the kernel reads tiles through the indices and
copies none, so neither of the JAX package's budgets (TPU SMEM for the index
arrays, XLA gather materialization) binds here.  The only cap is on the
output slab of one launch: at most 2^25 int64 elements (256 MiB), so one
launch's output -- and the plain version's O(K * k^2) temporaries -- stay a
small, fixed share of device memory whatever the size of the multiply.
"""

from __future__ import annotations

import numpy as np
import torch

from spgemm_tpu_torch.ops import u64
from spgemm_tpu_torch.ops.cuda_spgemm import numeric_round
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix, ensure_device, resolve_device
from spgemm_tpu_torch.ops.symbolic import (SpgemmPlan, assembly_permutation,
                                           plan_rounds, symbolic_join)
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix

LAUNCH_OUT_ELEMENTS = 1 << 25


def launch_key_cap(k: int) -> int:
    """Most output keys one launch may write (the round budget above)."""
    return max(1, LAUNCH_OUT_ELEMENTS // (k * k))


def pack_tiles(m: BlockSparseMatrix, device) -> torch.Tensor:
    """Tile slab -> (nnzb + 1, k, k) int64 bit-view slab on `device`, with
    the all-zero sentinel tile appended at index nnzb (the padding target
    of the round planner)."""
    tiles = np.concatenate([m.tiles, np.zeros((1, m.k, m.k), np.uint64)])
    return u64.u64_to_t(tiles, resolve_device(device))


def plan(a, b) -> SpgemmPlan:
    """Host-only planning half: join + rounds + assembly permutation.
    Operands need only coords/nnzb/k (host or device matrices)."""
    if a.k != b.k:
        raise ValueError(f"tile size mismatch: {a.k} vs {b.k}")
    join = symbolic_join(a.coords, b.coords)
    rounds = plan_rounds(join, a_sentinel=a.nnzb, b_sentinel=b.nnzb,
                         key_cap=launch_key_cap(a.k))
    return SpgemmPlan(k=a.k, join=join,
                      rounds=rounds, take=assembly_permutation(rounds, join.num_keys),
                      a_coords=np.asarray(a.coords), b_coords=np.asarray(b.coords))


def _assemble(outs: list[torch.Tensor], take: torch.Tensor) -> torch.Tensor:
    """Concatenate the (padded) round outputs plus one zero row and gather
    through the assembly permutation: every real key reads its own output
    row, the sentinel slot reads the zero row."""
    zero = outs[0].new_zeros((1, *outs[0].shape[1:]))
    return torch.cat(outs + [zero]).index_select(0, take)


def execute(p: SpgemmPlan, a: DeviceBlockMatrix, b: DeviceBlockMatrix,
            fold=numeric_round) -> DeviceBlockMatrix:
    """Device half: one `fold` launch per round, then the assembly gather.

    fold: the numeric-round function; the CUDA kernel's wrapper by default
    (the plain version, ops/cuda_spgemm.numeric_round_ref, is what
    chip_smoke.py holds it against)."""
    p.check_operands(a, b)
    if a.device != b.device:
        raise ValueError(f"operands lie on {a.device} and {b.device}")
    dev = a.device
    if p.join.num_keys == 0:
        return DeviceBlockMatrix.empty(a.rows, b.cols, p.k, dev)
    outs = [fold(a.slab, b.slab, torch.from_numpy(rnd.pa).to(dev),
                 torch.from_numpy(rnd.pb).to(dev))
            for rnd in p.rounds]
    slab = _assemble(outs, torch.from_numpy(p.take).to(dev))
    return DeviceBlockMatrix(rows=a.rows, cols=b.cols, k=p.k,
                             coords=p.join.keys, slab=slab)


def spgemm_device(a, b, *, device="cuda", fold=numeric_round) -> DeviceBlockMatrix:
    """C = A x B with reference-exact semantics, tiles staying on the device.

    a, b: DeviceBlockMatrix, or host BlockSparseMatrix (uploaded to
    `device` on entry).  The result keeps all-zero output tiles (pruning
    happens only at final output, sparse_matrix_mult.cu:577-592) and carries
    rows=a.rows, cols=b.cols (:281-282)."""
    a = ensure_device(a, device)
    b = ensure_device(b, device)
    return execute(plan(a, b), a, b, fold=fold)


def spgemm(a: BlockSparseMatrix, b: BlockSparseMatrix, *,
           device="cuda") -> BlockSparseMatrix:
    """C = A x B host-to-host: upload, multiply on `device`, fetch."""
    return spgemm_device(a, b, device=device).to_host()
