"""Output-sharded SpGEMM: each round's keys cut into contiguous shards, one
per device, each shard folded by kernel 1 (the port's copy of the JAX
package's `parallel/rowshard.py`).

The numeric phase is parallel over output tiles: each output tile's pair
list folds on its own, so cutting the key axis keeps the reference's
per-tile accumulation order (SURVEY.md section 2.9) and the bytes equal
ops/spgemm.spgemm_device's.  The operands' tile slabs are packed once and
replicated onto every distinct device; the pair-index arrays are sharded;
the shards' results are gathered to the host in key order, with no value
arithmetic across shards.

It runs in one process over a list of torch devices, the counterpart of
the JAX package's single-controller shard_map (one program driving every
device of a mesh), which is what a wide spgemmd slice needs: the slice
lives in one daemon process.  Process groups across hosts belong to the
multihost port, not here.  A device list may repeat a device: `[cpu] * n`
or `[cuda:0] * n` cuts each round into n shards that run one after
another there, which is how the CPU tests and the one-card smoke run the
shard split.

On a CUDA device each shard is one launch of kernel 1, mod
(ops/cuda_spgemm.numeric_round) on that device's current stream, and a
failed load or launch raises: nothing falls back to the CPU.  On the CPU
the same wrapper runs its plain version.  ENGINE counts every shard's
dispatch as `rowshard_round`, and times the phases of a multiply: `plan`
(ops/spgemm.plan), `upload` (the operands packed and copied to the
devices), `numeric_dispatch` (each round's indices copied and its shards
launched) and `assembly` (the shards fetched to the host result, which
waits for their kernels).
"""

from __future__ import annotations

import numpy as np

from spgemm_tpu_torch.chain import _to_host
from spgemm_tpu_torch.ops import u64
from spgemm_tpu_torch.ops.spgemm import KERNELS, Folds, _upload, pack_tiles
from spgemm_tpu_torch.ops.spgemm import plan as _plan
from spgemm_tpu_torch.parallel.mesh import resolve_devices
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.timers import ENGINE


def spgemm_sharded(a, b, *, round_size: int | None = None, devices=None, plan=None,
                   folds: Folds = KERNELS, **_ignored) -> BlockSparseMatrix:
    """C = A x B with each round's keys sharded over `devices`.  Bit-exact.

    a, b: host BlockSparseMatrix (a DeviceBlockMatrix is fetched first).
    devices: torch devices or their names, one shard each (default: every
    visible card, default_devices()).  round_size: keys a round at most,
    within the card's launch cap (the default).  plan: an
    ops/symbolic.SpgemmPlan of this operand pair, whose join and memoized
    rowshard_rounds schedule are reused; by default the plan cache's
    ladder plan (ops/spgemm.plan: ENGINE `plan_cache_hits` and
    `plan_cache_misses`), whose own rounds are that schedule, so a chain
    resubmitted to a daemon's wide slice plans nothing again.  folds.exact is the numeric round
    (chip_smoke.py passes a timed wrapper).  Other keywords a chain passes
    (device, backend) are ignored, as in the JAX package: the sharded fold
    is the exact one.  Returns a host matrix that keeps all-zero tiles, as
    spgemm_device does."""
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
            # pad the key axis to a multiple of the shard count with sentinel
            # rows: kernel 1 skips their slots, and their zero tiles are cut below
            K = pa.shape[0]
            K_pad = -(-K // n) * n
            if K_pad != K:
                pad = ((0, K_pad - K), (0, 0))
                pa = np.pad(pa, pad, constant_values=a.nnzb)
                pb = np.pad(pb, pad, constant_values=b.nnzb)
            rows = K_pad // n
            outs = []
            for i, dev in enumerate(devs):
                a_d, b_d = slabs[dev]
                shard = slice(i * rows, (i + 1) * rows)
                outs.append(folds.exact(a_d, b_d, _upload(pa[shard], dev),
                                        _upload(pb[shard], dev)))
                ENGINE.incr("rowshard_round")
            pending.append((rnd.key_index, rows, outs))
    # every launch is queued before the first fetch waits on one; each shard
    # lands at its keys (the rounds partition the keys: each is written once)
    with ENGINE.phase("assembly"):
        out = np.empty((join.num_keys, k, k), dtype=np.uint64)
        for key_index, rows, outs in pending:
            for i, shard_out in enumerate(outs):
                keys = key_index[i * rows : (i + 1) * rows]
                out[keys] = u64.t_to_u64(shard_out)[: len(keys)]
    return BlockSparseMatrix(rows=a.rows, cols=b.cols, k=k, coords=join.keys, tiles=out)

