"""SpGEMM engine: one C = A x B, tiles staying on the device (the port's
counterpart of the JAX package's `ops/spgemm.py`).

Two phases:

  1. plan (host, ops/symbolic.py): sorted merge-join -> output structure,
     fanout-class rounds of (K, P) pair indices, assembly permutation.
  2. execute (device): one numeric launch per round, then one gather that
     puts the round outputs in key order with the sentinel zero tile last.

Backends (BACKENDS), each a choice of numeric kernel per round:

  * exact  -- the reference's wrap-then-mod fold, kernel 1
              (ops/cuda_spgemm.py + csrc/numeric_round.cu), on every round;
  * mxu    -- field mode (clean mod 2^64 - 1) end to end, the limb kernel
              (ops/cuda_mxu.py + csrc/numeric_round_mxu.cu) on every round;
  * hybrid -- per round: the limb kernel where the exactness proof
              (ops/mxu_spgemm.safe_exact_bound at the round's real max
              fanout) holds, P * k <= 2^17 and the speed gate
              (ops/crossover.py) picks it; kernel 1's no_mod variant on
              the other proven rounds; kernel 1's mod variant on unproven
              rounds.  Its result is byte-identical to exact's.  When every
              round of a multiply is proven, the proven output bound
              becomes the result's val_bound and feeds the next multiply's
              proof.

Round budget on the card: the kernels read tiles through the indices and
copy none, so neither of the JAX package's budgets (TPU SMEM for the index
arrays, XLA gather materialization) binds here.  The only cap is on the
output slab of one launch: at most 2^25 int64 elements (256 MiB), so one
launch's output -- and the plain versions' temporaries -- stay a small,
fixed share of device memory whatever the size of the multiply.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch

from spgemm_tpu_torch.ops import crossover, u64
from spgemm_tpu_torch.ops.cuda_mxu import limbs_for_bound, numeric_round_mxu
from spgemm_tpu_torch.ops.cuda_spgemm import numeric_round
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix, ensure_device, resolve_device
from spgemm_tpu_torch.ops.mxu_spgemm import MAX_PAIR_DEPTH, safe_exact_bound
from spgemm_tpu_torch.ops.symbolic import (SpgemmPlan, _shape_class, assembly_permutation,
                                           plan_rounds, symbolic_join)
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.timers import ENGINE

log = logging.getLogger("spgemm_tpu_torch.spgemm")

LAUNCH_OUT_ELEMENTS = 1 << 25
BACKENDS = ("exact", "mxu", "hybrid")
MAX_BOUND = (1 << 64) - 2  # any result is a canonical residue, at most 2^64 - 2

# Rounds dispatched to each kernel, counted per round in execute, beside the
# wrappers' launch counters: "mod" and "no_mod" are kernel 1's variants,
# "mxu" the limb kernel.
rounds_by_kernel = {"mod": 0, "no_mod": 0, "mxu": 0}


@dataclass(frozen=True)
class Folds:
    """The numeric-round functions execute dispatches to: `exact` takes
    (a, b, pa, pb, no_mod=...), `mxu` takes (a, b, pa, pb, a_limbs=...,
    b_limbs=...).  KERNELS are the CUDA kernels' wrappers; chip_smoke.py
    substitutes timed wrappers and the plain PyTorch versions."""

    exact: Callable = numeric_round
    mxu: Callable = numeric_round_mxu


KERNELS = Folds()


def launch_key_cap(k: int) -> int:
    """Most output keys one launch may write (the round budget above)."""
    return max(1, LAUNCH_OUT_ELEMENTS // (k * k))


def pack_tiles(m: BlockSparseMatrix, device) -> torch.Tensor:
    """Tile slab -> (nnzb + 1, k, k) int64 bit-view slab on `device`, with
    the all-zero sentinel tile appended at index nnzb (the padding target
    of the round planner)."""
    tiles = np.concatenate([m.tiles, np.zeros((1, m.k, m.k), np.uint64)])
    return u64.u64_to_t(tiles, resolve_device(device))


def _proof_fanout_cap(a_bound: int, b_bound: int, k: int) -> int | None:
    """Largest fanout at which safe_exact_bound holds for these operand
    bounds (None: every fanout proves).  The planner partitions each fanout
    class at it, so that routing stays per key."""
    denom = a_bound * b_bound * k
    if denom == 0:
        return None  # zero operands: every product is 0, any fanout proves
    cap = ((1 << 64) - 2) // denom
    # safe_exact_bound reads fanout 0 as 1; a cap of 0 still partitions
    # correctly (every key lands in the unproven part)
    return cap if cap < (1 << 63) else None


def plan(a, b, *, backend: str = "exact") -> SpgemmPlan:
    """Host planning half: join + rounds + assembly permutation, timed as
    ENGINE's `plan`.  Operands need only coords/nnzb/k, and under `hybrid` a
    bound() (DeviceBlockMatrix) for the proof split.  Host-only when the
    bounds are already resolved (chain.py's planner thread relies on it)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if a.k != b.k:
        raise ValueError(f"tile size mismatch: {a.k} vs {b.k}")
    with ENGINE.phase("plan"):
        split = None
        if backend == "hybrid":
            split = _proof_fanout_cap(a.bound(), b.bound(), a.k)
        join = symbolic_join(a.coords, b.coords)
        rounds = plan_rounds(join, a_sentinel=a.nnzb, b_sentinel=b.nnzb,
                             key_cap=launch_key_cap(a.k), split_fanout=split)
        return SpgemmPlan(k=a.k, join=join,
                          rounds=rounds, take=assembly_permutation(rounds, join.num_keys),
                          a_coords=np.asarray(a.coords), b_coords=np.asarray(b.coords),
                          backend=backend, split_fanout=split)


_plan = plan  # spgemm_device's `plan` argument shadows the name


def _upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host index array on `dev` without blocking the host: on CUDA it is
    staged in pinned memory and copied with non_blocking=True.  PyTorch's
    caching host allocator records the copy on the stream and reuses the
    pinned block only after the copy has run, so the block stays alive
    however soon the tensor is dropped."""
    t = torch.from_numpy(x)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def _assemble(outs: list[torch.Tensor], take: torch.Tensor) -> torch.Tensor:
    """Concatenate the (padded) round outputs plus one zero row and gather
    through the assembly permutation: every real key reads its own output
    row, the sentinel slot reads the zero row."""
    zero = outs[0].new_zeros((1, *outs[0].shape[1:]))
    return torch.cat(outs + [zero]).index_select(0, take)


def _hybrid_router(a: DeviceBlockMatrix, b: DeviceBlockMatrix, k: int, folds: Folds):
    """choose(rnd) -> (kernel name, fold, proven) for the hybrid backend.

    proven says whether the exactness proof held at the round's real max
    fanout: the proven bound is then valid whichever kernel runs (they give
    the same bits), so bound propagation reads proven, not the kernel."""
    a_bound, b_bound = a.bound(), b.bound()
    a_limbs, b_limbs = limbs_for_bound(a_bound), limbs_for_bound(b_bound)
    no_mod = partial(folds.exact, no_mod=True)
    mxu = partial(folds.mxu, a_limbs=a_limbs, b_limbs=b_limbs)
    policy = crossover.gate_policy(a.device)

    def choose(rnd):
        if safe_exact_bound(a_bound, b_bound, rnd.max_fanout, k) is None:
            return "mod", folds.exact, False
        P = rnd.pa.shape[1]
        # the padded width limits only the limb kernel's accumulators; the
        # proof, and so the no_mod fold and the bound, hold regardless
        if P * k > MAX_PAIR_DEPTH:
            return "no_mod", no_mod, True
        if policy == "auto":
            K = min(_shape_class(rnd.pa.shape[0]), crossover.MEASURE_KEYS)
            key = crossover.cache_key(a.device, a_limbs, b_limbs, k, K, P)
            if not crossover.mxu_wins(no_mod, mxu, key=key, k=k, K=K, P=P, device=a.device):
                return "no_mod", no_mod, True
        return "mxu", mxu, True

    return choose


def execute(p: SpgemmPlan, a: DeviceBlockMatrix, b: DeviceBlockMatrix,
            folds: Folds = KERNELS) -> DeviceBlockMatrix:
    """Device half: the rounds' indices and the assembly permutation queued
    to the card from pinned memory (ENGINE's `upload`), one launch per round
    on the kernel p.backend picks for it, then the assembly gather.  On the
    exact backend nothing here waits for the stream, so the host goes on to
    the next multiply while the card works; under hybrid and mxu an
    operand's first bound() (one reduction) and the `auto` gate's one
    measurement per shape do.  folds: the functions dispatched to (the CUDA
    kernels' wrappers by default)."""
    p.check_operands(a, b)
    if a.device != b.device:
        raise ValueError(f"operands lie on {a.device} and {b.device}")
    dev = a.device
    k = p.k
    if p.join.num_keys == 0:
        return DeviceBlockMatrix.empty(a.rows, b.cols, k, dev)
    if p.backend == "hybrid":
        choose = _hybrid_router(a, b, k, folds)
    elif p.backend == "mxu":
        mxu = partial(folds.mxu, a_limbs=limbs_for_bound(a.bound()),
                      b_limbs=limbs_for_bound(b.bound()))

        def choose(rnd):
            return "mxu", mxu, False
    else:
        def choose(rnd):
            return "mod", folds.exact, False
    with ENGINE.phase("upload"):
        indices = [(_upload(rnd.pa, dev), _upload(rnd.pb, dev)) for rnd in p.rounds]
        take = _upload(p.take, dev)
    outs, proven_rounds, used = [], 0, dict.fromkeys(rounds_by_kernel, 0)
    for rnd, (pa, pb) in zip(p.rounds, indices):
        name, fold, proven = choose(rnd)
        outs.append(fold(a.slab, b.slab, pa, pb))
        proven_rounds += proven
        used[name] += 1
    for name, n in used.items():
        rounds_by_kernel[name] += n
    slab = _assemble(outs, take)
    out_bound = MAX_BOUND
    if p.backend == "hybrid":
        log.info("spgemm[hybrid mxu=%d/%d no_mod=%d]: keys=%d", used["mxu"],
                 len(p.rounds), used["no_mod"], p.join.num_keys)
        if proven_rounds == len(p.rounds):
            proven = safe_exact_bound(a.bound(), b.bound(), int(p.join.fanouts.max()), k)
            if proven is not None:
                out_bound = min(proven, MAX_BOUND)
    return DeviceBlockMatrix(rows=a.rows, cols=b.cols, k=k, coords=p.join.keys,
                             slab=slab, val_bound=out_bound)


def spgemm_device(a, b, *, device="cuda", backend: str = "exact",
                  folds: Folds = KERNELS, plan: SpgemmPlan | None = None) -> DeviceBlockMatrix:
    """C = A x B, tiles staying on the device.

    a, b: DeviceBlockMatrix, or host BlockSparseMatrix (uploaded to
    `device` on entry).  backend: one of BACKENDS; exact and hybrid give the
    reference's bytes, mxu field mode.  plan: a prepared plan of this pair
    for this backend (chain.py's plan-ahead worker), or None to plan here,
    timed as ENGINE's `plan_wait`; the bytes are the same either way.  The
    result keeps all-zero output tiles (pruning happens only at final
    output, sparse_matrix_mult.cu:577-592) and carries rows=a.rows,
    cols=b.cols (:281-282)."""
    a = ensure_device(a, device)
    b = ensure_device(b, device)
    if plan is None:
        with ENGINE.phase("plan_wait"):
            plan = _plan(a, b, backend=backend)
    elif plan.backend != backend:
        raise ValueError(f"plan built for backend {plan.backend!r}, asked for {backend!r}")
    return execute(plan, a, b, folds=folds)


def spgemm(a: BlockSparseMatrix, b: BlockSparseMatrix, *,
           device="cuda", backend: str = "exact") -> BlockSparseMatrix:
    """C = A x B host-to-host: upload, multiply on `device`, fetch."""
    return spgemm_device(a, b, device=device, backend=backend).to_host()
