"""Inner-dimension sharded SpGEMM: each position folds a slice of every output
tile's pair list (the contraction dimension) into a partial tile, and the
partials are all-reduced under addition mod 2^64 - 1 (the port's copy of the
JAX package's `parallel/innershard.py`).

Arithmetic: clean mod-(2^64 - 1), "field mode" (ops/u64.py), which is
associative, so the cross-position reduction is order-free and the bytes are
the field-mode oracle's (utils/semantics.field_spgemm_oracle) at any number
of positions.  They equal the reference's wrap-then-mod bytes whenever no
product or sum reaches 2^64 - 1 (for example every value below 2^32); use
parallel/rowshard.py where the reference's bytes are needed.

It runs in one process over a list of torch devices, as parallel/rowshard.py
does: position i folds on devices[i], and a device may repeat (`["cpu"] * n`
in the tests, `[cuda:0] * n` on one card).  The JAX package's mesh and
shard_map become that list; its ppermute a tensor copy to the partner's
device; its XOR butterfly and ordered gather fold a sequence of the F2
kernel's in-place adds (ops/cuda_field.addmod_field_).  Each position's fold
is one launch of the F1 kernel (ops/cuda_field.field_fold) on that device's
current stream; on the CPU the wrappers run their plain versions.  Nothing
falls back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from spgemm_tpu_torch.chain import _to_host
from spgemm_tpu_torch.ops import cuda_field, u64
from spgemm_tpu_torch.ops.spgemm import _upload, pack_tiles
from spgemm_tpu_torch.ops.spgemm import plan as _plan
from spgemm_tpu_torch.parallel.mesh import resolve_devices
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.timers import ENGINE

# (K, P) pair lists -> (K, k, k) partial tiles in field mode: the F1 kernel on
# a card, its plain version on the CPU (the JAX package's fold_pairs_field)
fold_pairs_field = cuda_field.field_fold


def butterfly_allreduce_modadd(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """All-reduce of one partial tile stack per position under addition mod
    2^64 - 1, in place; afterwards every position holds the same canonical
    sum.  A power-of-two count runs log2(n) XOR steps: each position copies
    its partner's pre-step tiles to its own device, then adds them (F2).
    Any other count gathers the partials and folds them in position order
    at every position, as the JAX package's all_gather fallback does.
    Field addition is associative and commutative, so both give the same
    bits.  Returns parts."""
    n = len(parts)
    if n & (n - 1) == 0:
        step = 1
        while step < n:
            # every copy is queued before any add: each add reads its
            # partner's tiles as they were before this step
            recv = [parts[i ^ step].to(parts[i].device, copy=True) for i in range(n)]
            for x, y in zip(parts, recv):
                cuda_field.addmod_field_(x, y)
            step <<= 1
        return parts
    gathered = [[p.to(x.device, copy=True) for p in parts] for x in parts]
    for i, row in enumerate(gathered):
        acc = torch.zeros_like(parts[i])
        for y in row:
            cuda_field.addmod_field_(acc, y)
        parts[i] = acc
    return parts


def spgemm_inner(a, b, *, round_size: int | None = None, devices=None, plan=None,
                 **_ignored) -> BlockSparseMatrix:
    """C = A x B with each round's pair axis sharded over `devices` and the
    partial tiles all-reduced (field mode).

    a, b: host BlockSparseMatrix or DeviceBlockMatrix (fetched first; a
    device matrix's value bound decides the small route without a
    reduction).  devices: torch devices or their names, one position each
    (default: every visible card).  round_size: keys a round at most, within
    the card's launch cap (the default).  plan: an ops/symbolic.SpgemmPlan
    of this operand pair; by default the plan cache's ladder plan
    (ops/spgemm.plan), whose rounds are the schedule
    (SpgemmPlan.rowshard_rounds): the JAX package plans 512-key rounds of
    its own, and no bit depends on the chunking.  Other keywords a chain
    passes (device, backend, folds) are ignored: the fold is field mode
    whatever the backend.  Returns a host matrix that keeps all-zero tiles.

    ENGINE times `plan`, `upload` (the operands packed and copied to each
    distinct device), `numeric_dispatch` (each round's slices copied, folded
    and all-reduced) and `assembly` (the first position's sums fetched to
    the host result, which waits for their kernels)."""
    small = u64.operands_below_2_32(a, b)
    a, b = _to_host(a), _to_host(b)
    if a.k != b.k:
        raise ValueError(f"tile size mismatch: {a.k} vs {b.k}")
    k = a.k
    devs = resolve_devices(devices)
    n = len(devs)
    if plan is None:
        plan = _plan(a, b, round_size=round_size, route="ladder")
    else:
        plan.check_operands(a, b)
    join = plan.ensure_exact().join
    if join.num_keys == 0:
        return BlockSparseMatrix(rows=a.rows, cols=b.cols, k=k)
    rounds = plan.rowshard_rounds(round_size)

    # each operand packed once (the zero sentinel tile at index nnzb) and
    # copied once to each distinct device
    with ENGINE.phase("upload"):
        a_slab, b_slab = pack_tiles(a, "cpu"), pack_tiles(b, "cpu")
        slabs = {d: (a_slab.to(d), b_slab.to(d)) for d in dict.fromkeys(devs)}
    pending = []
    with ENGINE.phase("numeric_dispatch"):
        for rnd in rounds:
            pa, pb = rnd.pa, rnd.pb
            # pad the pair axis to a multiple of the position count with
            # sentinel slots, which add nothing
            P = pa.shape[1]
            P_pad = -(-P // n) * n
            if P_pad != P:
                pad = ((0, 0), (0, P_pad - P))
                pa = np.pad(pa, pad, constant_values=a.nnzb)
                pb = np.pad(pb, pad, constant_values=b.nnzb)
            width = P_pad // n
            parts = []
            for i, dev in enumerate(devs):
                cut = slice(i * width, (i + 1) * width)
                pa_i, pb_i = (_upload(np.ascontiguousarray(x[:, cut]), dev) for x in (pa, pb))
                parts.append(fold_pairs_field(*slabs[dev], pa_i, pb_i, small=small))
            pending.append((rnd.key_index, butterfly_allreduce_modadd(parts)[0]))
    # every launch is queued before the first fetch waits on one; the rounds
    # partition the keys, so each key is written once
    with ENGINE.phase("assembly"):
        out = np.empty((join.num_keys, k, k), dtype=np.uint64)
        for key_index, tiles in pending:
            out[key_index] = u64.t_to_u64(tiles)[: len(key_index)]
    return BlockSparseMatrix(rows=a.rows, cols=b.cols, k=k, coords=join.keys, tiles=out)
