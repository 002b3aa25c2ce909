"""SpGEMM engine: one C = A x B, tiles staying on the device (the port's
counterpart of the JAX package's `ops/spgemm.py`).

Two phases:

  1. plan (host, ops/symbolic.py): sorted merge-join -> output structure,
     fanout-class rounds of (K, P) pair indices (or, on the dense route,
     pair streams), assembly permutation; memoized by operand structure
     (ops/plancache.py).
  2. execute (device): one numeric launch per round, then one gather that
     puts the round outputs in key order with the sentinel zero tile last.

spgemm_outofcore runs the same rounds with both operands and the result in
host memory, staging each round's tiles to the card through a pipeline.

Planning has three tiers: the plan cache (ops/plancache), then the warm
store on disk (ops/warmstore, when SPGEMM_TPU_WARM_DIR binds one), then the
planner, which on a confident sampled estimate (ops/estimate) returns at once
and defers the exact join to SpgemmPlan.ensure_exact (the chain's plan-ahead
worker, or execute).  An exact plan is written through to the warm store.

Delta recompute (ops/delta, SPGEMM_TPU_DELTA, default 1): spgemm_device on a
fingerprinted plan whose structure it multiplied before folds only the
output rows the changed input rows reach (a sub-plan, subplan) and splices
them into a new copy of the retained previous result (ops/cuda_splice.py +
csrc/splice.cu).  The bytes are the full multiply's.

Accumulator route (SPGEMM_TPU_ACCUM_ROUTE, default auto; the JAX package's
ops/spgemm.py:150-223, 705-817): 'ladder' rounds pad each key's pair list
to its fanout class and run the backend's kernel; 'dense' rounds ship each
class chunk as one pair stream and run the segmented fold
(ops/cuda_dense.py + csrc/numeric_round_dense.cu), always mod; under
'auto' a round of class >= DENSE_MIN_CLASS carries both layouts, and where
it would not run the limb kernel the dense gate (ops/crossover.dense_wins:
measured on the card, structural on the CPU) picks one.  The bytes are the
same on every route.  The mxu backend and out-of-core always plan ladder.
Unlike the JAX package, whose knob is jit-static, the route is part of the
plan cache's key, since a process may change it between multiplies.

Backends (BACKENDS), each a choice of numeric kernel per ladder round:

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

Cross-job batching (execute_batched, spgemmd's batch pickup): J multiplies
of one structure run each round as one launch over the J jobs' stacked
indices, as many jobs a launch as that cap allows; each job gets the bits
of its solo execute.
"""

from __future__ import annotations

import logging
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch

from spgemm_tpu_torch.ops import crossover, delta, estimate, plancache, u64, warmstore
from spgemm_tpu_torch.ops.cuda_dense import numeric_round_dense
from spgemm_tpu_torch.ops.cuda_splice import source_map, splice
from spgemm_tpu_torch.ops.cuda_mxu import limbs_for_bound, numeric_round_mxu
from spgemm_tpu_torch.ops.cuda_spgemm import numeric_round
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix, ensure_device, resolve_device
from spgemm_tpu_torch.ops.mxu_spgemm import MAX_PAIR_DEPTH, safe_exact_bound
from spgemm_tpu_torch.ops.symbolic import (ROUTES, SpgemmPlan, _shape_class,
                                           assembly_permutation, plan_rounds, slice_join,
                                           symbolic_join)
from spgemm_tpu_torch.utils import failpoints, knobs
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.timers import ENGINE

log = logging.getLogger("spgemm_tpu_torch.spgemm")

LAUNCH_OUT_ELEMENTS = 1 << 25
INDEX_LIMIT = 1 << 31  # slab indices are int32: a stacked slab's rows stay below it
OOC_ROUND_SIZE = 512  # keys per out-of-core round by default (the JAX package's)
BACKENDS = ("exact", "mxu", "hybrid")
MAX_BOUND = (1 << 64) - 2  # any result is a canonical residue, at most 2^64 - 2

# Rounds dispatched to each kernel, counted per round in execute (per launch
# in execute_batched, whose launch serves several jobs' copies of a round),
# beside the wrappers' launch counters: "mod" and "no_mod" are kernel 1's
# variants, "mxu" the limb kernel, "dense" the segmented fold.
rounds_by_kernel = {"mod": 0, "no_mod": 0, "mxu": 0, "dense": 0}


@dataclass(frozen=True)
class Folds:
    """The device functions execute and the delta path dispatch to: `exact`
    takes (a, b, pa, pb, no_mod=...), `mxu` takes (a, b, pa, pb,
    a_limbs=..., b_limbs=...), `dense` takes (a, b, pa, pb, seg, n_rows,
    row_ptr), `splice` takes (prev, sub, source map).  KERNELS are the CUDA
    kernels' wrappers; chip_smoke.py substitutes timed wrappers and the
    plain PyTorch versions."""

    exact: Callable = numeric_round
    mxu: Callable = numeric_round_mxu
    dense: Callable = numeric_round_dense
    splice: Callable = splice


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


def _bound(m) -> int:
    """The value bound the hybrid and mxu backends read: a device matrix's
    bound(), a host matrix's exact tile max."""
    if isinstance(m, BlockSparseMatrix):
        return int(m.tiles.max()) if m.nnzb else 0
    return m.bound()


def _build_exact(p: SpgemmPlan, route_pred: str | None = None) -> None:
    """Fill p's join, rounds and assembly permutation from the exact join,
    in place (inline, or later as a deferred plan's builder, timed then as
    ENGINE's `plan_exact`), on p's accumulator route.  Rounds are
    partitioned at the full proof split on either planning route: the JAX
    package drops the split where the sample saw no fanout above it, which
    here would save nothing (an empty part makes no round) and could change
    the plan, so estimator on and off give the same plans.

    route_pred: the estimator's predicted accumulator route.  Where the real
    one differs (dense iff some round is dense or carries a twin), ENGINE
    counts `est_route_mismatch`, where the JAX package emits
    obs_events.emit("accum_route_mismatch", ...)."""
    join = symbolic_join(p.a_coords, p.b_coords)
    rounds = plan_rounds(join, a_sentinel=len(p.a_coords), b_sentinel=len(p.b_coords),
                         key_cap=p.key_cap, split_fanout=p.split_fanout, route=p.route)
    p.join, p.rounds, p.take = join, rounds, assembly_permutation(rounds, join.num_keys)
    if route_pred is not None:
        real = ("dense" if any(r.route == "dense" or r.dense_alt is not None for r in rounds)
                else "ladder")
        if real != route_pred:
            ENGINE.incr("est_route_mismatch")


def _deferred_build(p: SpgemmPlan, route_pred: str | None) -> None:
    with ENGINE.phase("plan_exact"):
        _build_exact(p, route_pred)


def _new_plan(a, b, backend: str, route: str, key_cap: int, split: int | None,
              key: str | None) -> SpgemmPlan:
    """A plan-cache miss (or the cache off, key None): the warm store's
    plan for key, else the planner's, routed by the sampled estimator
    (JAX ops/spgemm._plan_host).  A plan that will be cached is frozen; an
    exact one is written through to the warm store."""
    if key is not None:
        warm = warmstore.load_plan(key)
        if warm is not None:
            return warm.freeze()
    p = SpgemmPlan(k=a.k, join=None, rounds=None, take=None,
                   a_coords=np.asarray(a.coords), b_coords=np.asarray(b.coords),
                   backend=backend, route=route, split_fanout=split, key_cap=key_cap,
                   fingerprint=key)
    if estimate.enabled():
        p.estimate = estimate.maybe_estimate(p.a_coords, p.b_coords)
    est = p.estimate
    route_pred = estimate.predicted_route(est) if backend != "mxu" else None
    if est is not None and est.confidence >= estimate.confidence_threshold():
        # confident: return now; the exact join runs in ensure_exact (the
        # JAX package also calls obs_profile.observe_estimate there)
        estimate.note_hit()
        ENGINE.incr("est_hits")
        p.plan_route = "estimated"
        p._exact_builder = partial(_deferred_build, route_pred=route_pred)
    elif est is not None:
        # a sample not to be trusted: the exact join inline (the JAX package
        # also calls obs_events.emit("est_fallback", ...))
        estimate.note_fallback()
        ENGINE.incr("est_fallbacks")
        with ENGINE.phase("join_fallback"):
            _build_exact(p, route_pred)
    else:
        _build_exact(p, route_pred)
    if key is not None:
        p.freeze()
        if not p.is_deferred:
            warmstore.save_plan(p)
    return p


def plan(a, b, *, backend: str = "exact", round_size: int | None = None,
         route: str | None = None) -> SpgemmPlan:
    """Host planning half: join + rounds + assembly permutation, timed as
    ENGINE's `plan`, memoized by structure (ops/plancache; hits and misses
    are ENGINE's `plan_cache_hits` and `plan_cache_misses`), then read from
    the warm store, then planned (see _new_plan: a confident estimate
    returns a deferred plan, estimator counts `est_hits` and
    `est_fallbacks`).  Every consumer calls ensure_exact().  Operands need
    only rows/cols/coords/nnzb/k, and under `hybrid` a value bound for the
    proof split: bound() of a DeviceBlockMatrix, the tile max of a host
    BlockSparseMatrix.  Host-only when those bounds are already resolved
    (chain.py's planner thread relies on it).

    round_size: at most this many keys per launch (the reference's
    small_size), within launch_key_cap(k); None = the card's cap.  Each
    key's fold order lives in its own pair list, so the bytes never depend
    on it.

    route: the accumulator route (symbolic.ROUTES); None reads
    SPGEMM_TPU_ACCUM_ROUTE, except under mxu, which plans ladder only (its
    field-mode fold has no dense kernel).  The bytes never depend on it."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if a.k != b.k:
        raise ValueError(f"tile size mismatch: {a.k} vs {b.k}")
    if round_size is not None and round_size < 1:
        raise ValueError(f"round_size must be >= 1, got {round_size}")
    k = a.k
    key_cap = launch_key_cap(k) if round_size is None else min(round_size, launch_key_cap(k))
    if route is None:
        route = "ladder" if backend == "mxu" else knobs.get("SPGEMM_TPU_ACCUM_ROUTE")
    if route not in ROUTES or (backend == "mxu" and route != "ladder"):
        raise ValueError(f"accumulator route {route!r} under backend {backend!r}: expected "
                         f"one of {ROUTES}, and 'ladder' under mxu")
    with ENGINE.phase("plan"):
        failpoints.check("plan.build")
        split = _proof_fanout_cap(_bound(a), _bound(b), k) if backend == "hybrid" else None
        if not plancache.enabled():
            return _new_plan(a, b, backend, route, key_cap, split, None)
        # everything the plan depends on, and the operand dims, which it
        # does not: a result must never come back under another shape
        meta = (k, a.nnzb, b.nnzb, backend, route, key_cap, split, a.rows, a.cols, b.rows,
                b.cols)
        key = plancache.fingerprint(a.coords, b.coords, meta)
        p, hit = plancache.get_or_build(
            key, lambda: _new_plan(a, b, backend, route, key_cap, split, key))
        ENGINE.incr("plan_cache_hits" if hit else "plan_cache_misses")
        return p


_plan = plan  # spgemm_device's `plan` argument shadows the name

_TORCH_INT = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64}


def _upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host index array on `dev` without blocking the host: on CUDA it is
    staged in pinned memory and copied with non_blocking=True.  PyTorch's
    caching host allocator records the copy on the stream and reuses the
    pinned block only after the copy has run, so the block stays alive
    however soon the tensor is dropped.  x may be read-only (a cached
    plan's); torch.from_numpy takes only writable arrays."""
    if dev.type != "cuda":
        return torch.from_numpy(np.require(x, requirements="W")).to(dev)
    buf = torch.empty(x.shape, dtype=_TORCH_INT[x.dtype], pin_memory=True)
    buf.numpy()[...] = x
    return buf.to(dev, non_blocking=True)


def _assemble(outs: list[torch.Tensor], take: torch.Tensor) -> torch.Tensor:
    """Concatenate the (padded) round outputs plus one zero row and gather
    through the assembly permutation: every real key reads its own output
    row, the sentinel slot reads the zero row."""
    zero = outs[0].new_zeros((1, *outs[0].shape[1:]))
    return torch.cat(outs + [zero]).index_select(0, take)


def _hybrid_router(a_bound: int, b_bound: int, k: int, device, folds: Folds):
    """choose(rnd) -> (kernel name, fold, proven) for the hybrid backend,
    from the operands' value bounds and the device the rounds run on.

    proven says whether the exactness proof held at the round's real max
    fanout: the proven bound is then valid whichever kernel runs (they give
    the same bits), so bound propagation reads proven, not the kernel."""
    a_limbs, b_limbs = limbs_for_bound(a_bound), limbs_for_bound(b_bound)
    no_mod = partial(folds.exact, no_mod=True)
    mxu = partial(folds.mxu, a_limbs=a_limbs, b_limbs=b_limbs)
    policy = crossover.gate_policy(device)

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
            key = crossover.cache_key(device, a_limbs, b_limbs, k, K, P)
            if not crossover.mxu_wins(no_mod, mxu, key=key, k=k, K=K, P=P, device=device):
                return "no_mod", no_mod, True
        return "mxu", mxu, True

    return choose


def _router(backend: str, k: int, device, folds: Folds, bounds: Callable):
    """choose(rnd) for `backend`; bounds() gives the operands' value bounds
    and is called only by the backends that read them (hybrid and mxu)."""
    if backend == "hybrid":
        return _hybrid_router(*bounds(), k, device, folds)
    if backend == "mxu":
        a_bound, b_bound = bounds()
        mxu = partial(folds.mxu, a_limbs=limbs_for_bound(a_bound),
                      b_limbs=limbs_for_bound(b_bound))
        return lambda rnd: ("mxu", mxu, False)
    return lambda rnd: ("mod", folds.exact, False)


def _dense_gate(rnd, ladder: str, fold: Callable, k: int, device, folds: Folds) -> bool:
    """Should this auto round run its dense twin instead of `fold` (kernel
    1's `ladder` variant) on its ladder layout?  The JAX package's
    _dense_gate: measured once per shape under the 'auto' policy, the
    ladder layout's padded-MAC ratio under 'proof'.  The timed key class is
    the round's, clamped as the hybrid gate's, with the real pairs scaled
    to it."""
    policy = crossover.gate_policy(device)
    K_pad, P = rnd.pa.shape
    K = min(_shape_class(K_pad), crossover.MEASURE_KEYS)
    key = crossover.dense_cache_key(device, ladder, k, K, P) if policy == "auto" else ""
    return crossover.dense_wins(fold, folds.dense, key=key, k=k, K=K, P=P,
                                real_pairs=-(-rnd.real_pairs * K // K_pad), device=device,
                                policy=policy, padded_ratio=rnd.padded_mac_ratio())


def _route_rounds(p: SpgemmPlan, choose: Callable, device, folds: Folds,
                  bounds: Callable) -> list[tuple]:
    """(kernel name, fold, proven, the round in the layout it runs) for each
    of p's rounds (the JAX package's execute, ops/spgemm.py:795-817).  A
    dense round runs the segmented fold, and under hybrid still counts its
    proof, which holds whatever kernel folds it.  An auto round with a twin
    asks the dense gate, unless it would run the limb kernel."""
    routed = []
    for rnd in p.rounds:
        if rnd.route == "dense":
            proven = (p.backend == "hybrid"
                      and safe_exact_bound(*bounds(), rnd.max_fanout, p.k) is not None)
            routed.append(("dense", folds.dense, proven, rnd))
            continue
        name, fold, proven = choose(rnd)
        if (rnd.dense_alt is not None and name != "mxu"
                and _dense_gate(rnd, name, fold, p.k, device, folds)):
            routed.append(("dense", folds.dense, proven, rnd.dense_alt))
        else:
            routed.append((name, fold, proven, rnd))
    return routed


def _count_rounds(backend: str, used: dict, n_rounds: int, keys: int) -> None:
    for name, n in used.items():
        rounds_by_kernel[name] += n
    if backend == "hybrid":
        log.info("spgemm[hybrid mxu=%d/%d no_mod=%d]: keys=%d", used["mxu"],
                 n_rounds, used["no_mod"], keys)


def execute(p: SpgemmPlan, a: DeviceBlockMatrix, b: DeviceBlockMatrix,
            folds: Folds = KERNELS) -> DeviceBlockMatrix:
    """Device half: each round's kernel and layout chosen (_route_rounds),
    the chosen layouts' indices and the assembly permutation queued to the
    card from pinned memory (ENGINE's `upload`), one launch per round (a
    dense one timed as ENGINE's `dense_fold` and counted as `route_dense`),
    then the assembly gather.  On the exact backend with no dense twin
    nothing here waits for the stream, so the host goes on to the next
    multiply while the card works; under hybrid and mxu an operand's first
    bound() (one reduction) and an `auto` gate's one measurement per shape
    do.  folds: the functions dispatched to (the CUDA kernels' wrappers by
    default)."""
    p.check_operands(a, b)
    if a.device != b.device:
        raise ValueError(f"operands lie on {a.device} and {b.device}")
    p.ensure_exact()
    dev = a.device
    k = p.k
    if p.join.num_keys == 0:
        return DeviceBlockMatrix.empty(a.rows, b.cols, k, dev)

    def bounds():
        return a.bound(), b.bound()

    failpoints.check("kernel.dispatch")
    routed = _route_rounds(p, _router(p.backend, k, dev, folds, bounds), dev, folds, bounds)
    with ENGINE.phase("upload"):
        indices = [[_upload(x, dev) for x in ((lay.pa, lay.pb, lay.seg, lay.row_ptr)
                                               if name == "dense" else (lay.pa, lay.pb))]
                   for name, _, _, lay in routed]
        take = _upload(p.take, dev)
    outs, proven_rounds, used = [], 0, dict.fromkeys(rounds_by_kernel, 0)
    for (name, fold, proven, lay), idx in zip(routed, indices):
        if name == "dense":
            pa, pb, seg, row_ptr = idx
            with ENGINE.phase("dense_fold"):
                outs.append(fold(a.slab, b.slab, pa, pb, seg, lay.n_rows, row_ptr))
            ENGINE.incr("route_dense")
        else:
            outs.append(fold(a.slab, b.slab, *idx))
        proven_rounds += proven
        used[name] += 1
    _count_rounds(p.backend, used, len(p.rounds), p.join.num_keys)
    slab = _assemble(outs, take)
    out_bound = MAX_BOUND
    if p.backend == "hybrid" and proven_rounds == len(p.rounds):
        proven = safe_exact_bound(a.bound(), b.bound(), int(p.join.fanouts.max()), k)
        if proven is not None:
            out_bound = min(proven, MAX_BOUND)
    return DeviceBlockMatrix(rows=a.rows, cols=b.cols, k=k, coords=p.join.keys,
                             slab=slab, val_bound=out_bound)


def _stack_width(K: int, k: int, jobs: int) -> int:
    """How many jobs' copies of a round of K padded keys one launch takes:
    all of them while the launch stays within launch_key_cap(k), the
    card's one per-launch budget, else fewer (at worst one a launch).  The
    JAX package derives the width from the TPU's SMEM index budget and
    XLA's gather budget, neither of which exists here.  The width decides
    only how many launches there are, never the bits."""
    return min(jobs, max(1, launch_key_cap(k) // max(K, 1)))


def stack_on_card(idx: torch.Tensor, sentinel: int, jobs: int) -> torch.Tensor:
    """symbolic.stack_round_indices of a (K, P) round's indices, computed
    where they lie: (jobs, K, P), job j's real indices shifted by
    j * sentinel and every sentinel on the shared zero tile at
    jobs * sentinel (the same values; tests hold the two equal).  The round
    is uploaded once, at one job's size, and the host does no per-job
    numpy work: stacking on the host, then a J-fold upload, made a batch of
    Medium chains slower on the card than its solo chains."""
    offsets = (torch.arange(jobs, device=idx.device, dtype=idx.dtype) * sentinel).view(-1, 1, 1)
    return torch.where(idx == sentinel, jobs * sentinel, idx + offsets)


def execute_batched(p: SpgemmPlan, pairs: list, folds: Folds = KERNELS) -> list:
    """execute() for J operand pairs of one structure (cross-job batching,
    the JAX package's execute_batched): the J jobs' slabs are concatenated
    tiles only, with one shared zero tile last, and each round launches
    once per width-chunk (_stack_width) with the jobs' indices stacked
    along the leading axis (stack_on_card).  Each job's rounds are sliced
    back out of the (chunk, K, k, k) output and gathered through the
    plan's own assembly permutation: row arithmetic, never a second fold.  Every key keeps its pair list and fold order, so each
    job gets the bits of its solo execute(p, a, b).  Returns the J results
    in the order of pairs.

    Routing: exact and hybrid run kernel 1's mod fold on every round (the
    hybrid router and its speed gate are skipped: its routes give the same
    bits), and under hybrid each job still gets its proven val_bound; mxu
    runs kernel 2 at the widest limbs of all jobs.  An auto round runs its
    ladder layout.  Falls back to J solo executes, with the same bits, when
    the stacked indices would not fit int32 or a round is dense (a 1-D
    stream does not stack).  ENGINE phases `upload`, `numeric_dispatch`
    and `assembly`; a launch counts once, however many jobs it serves."""
    if len(pairs) == 1:
        return [execute(p, *pairs[0], folds=folds)]
    for a, b in pairs:
        p.check_operands(a, b)
    devices = {m.device for pair in pairs for m in pair}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    p.ensure_exact()
    dev, k, J = devices.pop(), p.k, len(pairs)
    if p.join.num_keys == 0:
        return [DeviceBlockMatrix.empty(a.rows, b.cols, k, dev) for a, b in pairs]
    nnzb_a, nnzb_b = len(p.a_coords), len(p.b_coords)
    if max(nnzb_a, nnzb_b) * J + 1 >= INDEX_LIMIT or any(r.pa.ndim != 2 for r in p.rounds):
        return [execute(p, a, b, folds=folds) for a, b in pairs]
    if p.backend == "mxu":
        name = "mxu"
        fold = partial(folds.mxu, a_limbs=max(limbs_for_bound(a.bound()) for a, _ in pairs),
                       b_limbs=max(limbs_for_bound(b.bound()) for _, b in pairs))
    else:
        name, fold = "mod", folds.exact
    with ENGINE.phase("upload"):
        indices = [(_upload(rnd.pa, dev), _upload(rnd.pb, dev)) for rnd in p.rounds]
        take = _upload(p.take, dev)
    outs: list[list] = [[] for _ in range(J)]
    launches = fused = 0
    with ENGINE.phase("numeric_dispatch"):
        failpoints.check("kernel.dispatch")
        # tiles only, then job 0's sentinel zero tile once: the shared one
        a_slab = torch.cat([a.slab[:nnzb_a] for a, _ in pairs] + [pairs[0][0].slab[nnzb_a:]])
        b_slab = torch.cat([b.slab[:nnzb_b] for _, b in pairs] + [pairs[0][1].slab[nnzb_b:]])
        for rnd, (pa, pb) in zip(p.rounds, indices):
            spa, spb = stack_on_card(pa, nnzb_a, J), stack_on_card(pb, nnzb_b, J)
            width = _stack_width(rnd.pa.shape[0], k, J)
            for lo in range(0, J, width):
                out = fold(a_slab, b_slab, spa[lo:lo + width], spb[lo:lo + width])
                launches += 1
                fused += out.shape[0] > 1
                for j in range(out.shape[0]):
                    outs[lo + j].append(out[j])
    del a_slab, b_slab  # J jobs' copies of the inputs: freed before J outputs are assembled
    rounds_by_kernel[name] += launches
    with ENGINE.phase("assembly"):
        results = []
        for (a, b), job_outs in zip(pairs, outs):
            out_bound = MAX_BOUND
            if p.backend == "hybrid":
                proven = safe_exact_bound(a.bound(), b.bound(), int(p.join.fanouts.max()), k)
                if proven is not None:
                    out_bound = min(proven, MAX_BOUND)
            results.append(DeviceBlockMatrix(rows=a.rows, cols=b.cols, k=k,
                                             coords=p.join.keys, slab=_assemble(job_outs, take),
                                             val_bound=out_bound))
    log.info("spgemm[%s,x%d-job-batch]: nnzb %d x %d -> keys=%d pairs=%d rounds=%d "
             "launches=%d fused=%d", p.backend, J, nnzb_a, nnzb_b, p.join.num_keys,
             int(p.join.pair_ptr[-1]), len(p.rounds), launches, fused)
    return results


def subplan(parent: SpgemmPlan, keep: np.ndarray) -> tuple[SpgemmPlan, np.ndarray]:
    """The parent plan cut to the output keys the boolean mask keep selects
    (the delta path's dirty keys): each kept key's pair list whole and in
    order (symbolic.slice_join), the rounds rebuilt under the parent's key
    cap, proof split and accumulator route, so a kept key folds exactly as
    under the parent.
    Never cached.  Returns (sub_plan, kept key indices), the indices being
    where the splice puts the sub-plan's rows."""
    parent.ensure_exact()
    sub_join, kept = slice_join(parent.join, keep)
    rounds = plan_rounds(sub_join, a_sentinel=len(parent.a_coords),
                         b_sentinel=len(parent.b_coords), key_cap=parent.key_cap,
                         split_fanout=parent.split_fanout, route=parent.route)
    return SpgemmPlan(k=parent.k, join=sub_join, rounds=rounds,
                      take=assembly_permutation(rounds, sub_join.num_keys),
                      a_coords=parent.a_coords, b_coords=parent.b_coords,
                      backend=parent.backend, route=parent.route,
                      split_fanout=parent.split_fanout, key_cap=parent.key_cap), kept


def _delta_key(p: SpgemmPlan, a: DeviceBlockMatrix, b: DeviceBlockMatrix) -> str:
    """The delta store's key: the plan's fingerprint (which holds the
    operand dims, so a retained result never answers another shape) and
    the operands' devices, so a result retained on one card never answers
    a multiply on another."""
    return f"{p.fingerprint}|dev{a.device}x{b.device}"


def _rehydrate_delta_entry(key: str, raw: dict, device) -> delta.DeltaEntry:
    """A warm-store delta record (host arrays) as a live entry, its result
    uploaded to `device` (the device the key names)."""
    res = raw["result"]
    result = DeviceBlockMatrix(rows=res["rows"], cols=res["cols"], k=res["k"],
                               coords=res["coords"],
                               slab=torch.from_numpy(res["slab"]).to(device),
                               val_bound=res["val_bound"])
    return delta.DeltaEntry(key=key, version=raw["version"], a_src=raw["a_src"],
                            b_src=raw["b_src"], result=result, out_rows=raw["out_rows"])


def _delta_execute(p: SpgemmPlan, a: DeviceBlockMatrix, b: DeviceBlockMatrix,
                   folds: Folds, digests: tuple = (None, None)) -> DeviceBlockMatrix:
    """execute() for a structure multiplied before (JAX ops/spgemm.
    _delta_execute): diff the operands against the retained entry, fold
    only the output rows the changed input rows reach, and splice them into
    a new copy of the retained result (never into it: the caller holds it
    as the last multiply's answer).  An empty diff returns the retained
    result; an all-dirty one, the full multiply.  First contact, a lineage
    it cannot prove or an evicted entry is a counted full fallback that
    seeds the entry.  digests: the operands' row digests computed ahead
    for this multiply (delta.stash_digests), else hashed here.  The JAX
    package's obs_profile.observe_delta, obs_events.emit("delta_fallback")
    and _observe_memory calls wait for the port's obs/."""
    p.check_operands(a, b)
    p.ensure_exact()
    join = p.join
    key = _delta_key(p, a, b)
    entry = delta.lookup(key)
    if entry is None:
        raw = warmstore.load_delta(key)
        if raw is not None:
            entry = _rehydrate_delta_entry(key, raw, a.device)
            delta.seed_entry(entry)
    d = None
    reason = "no_entry" if entry is None else None
    if entry is not None:
        with ENGINE.phase("delta_diff"):
            d = delta.diff(entry, a, b, join, p.a_coords, p.b_coords, digests)
        if d is None:
            reason = "provenance_mismatch"
    if d is None:
        out_row_ids = np.unique(join.keys[:, 0]) if join.num_keys else np.zeros(0, np.int64)
        total_rows = len(out_row_ids)
        ENGINE.incr("delta_full_fallbacks")
        ENGINE.incr("delta_rows_recomputed", total_rows)
        ENGINE.incr("delta_rows_total", total_rows)
        delta.note_fallback_reason(reason)
        result = execute(p, a, b, folds=folds)
        with ENGINE.phase("delta_diff"):
            delta.store_full(key, a, b, result, total_rows, out_row_ids, digests)
        return result
    total_rows = entry.out_rows
    n_dirty = len(d.dirty_rows)
    ENGINE.incr("delta_rows_recomputed", n_dirty)
    ENGINE.incr("delta_rows_total", total_rows)
    if n_dirty == 0:
        result = entry.result  # both operands proven unchanged
    elif n_dirty >= total_rows:
        result = execute(p, a, b, folds=folds)
    else:
        sub_plan, kept = subplan(p, d.key_mask)
        sub = execute(sub_plan, a, b, folds=folds)
        with ENGINE.phase("delta_splice"):
            failpoints.check("delta.splice")
            prev = entry.result
            src = source_map(kept, np.arange(len(kept)), join.num_keys + 1)
            slab = folds.splice(prev.slab, sub.slab, _upload(src, prev.device))
            vb = max(MAX_BOUND if prev.val_bound is None else prev.val_bound,
                     MAX_BOUND if sub.val_bound is None else sub.val_bound)
            result = DeviceBlockMatrix(rows=a.rows, cols=b.cols, k=p.k, coords=join.keys,
                                       slab=slab, val_bound=min(vb, MAX_BOUND))
        log.info("spgemm[delta]: recomputed %d/%d output rows (%d/%d keys)",
                 n_dirty, total_rows, len(kept), join.num_keys)
    delta.commit(entry, result, d, total_rows)
    return result


def spgemm_device(a, b, *, device="cuda", backend: str = "exact",
                  folds: Folds = KERNELS, plan: SpgemmPlan | None = None,
                  round_size: int | None = None,
                  digests: tuple | None = None) -> DeviceBlockMatrix:
    """C = A x B, tiles staying on the device.

    a, b: DeviceBlockMatrix, or host BlockSparseMatrix (uploaded to
    `device` on entry).  backend: one of BACKENDS; exact and hybrid give the
    reference's bytes, mxu field mode.  plan: a prepared plan of this pair
    for this backend (chain.py's plan-ahead worker), or None to plan here,
    timed as ENGINE's `plan_wait`; the bytes are the same either way.
    round_size: keys per launch at most (see plan).  With SPGEMM_TPU_DELTA
    on (the default) and a fingerprinted plan, a structure multiplied before
    takes the delta path (_delta_execute); the bytes are the same.
    digests: (a's, b's) row digests computed ahead for this multiply alone
    (delta.stash_digests, on chain.py's plan-ahead worker), or None to hash
    on the delta path as needed.  The result keeps all-zero output tiles
    (pruning happens only at final output, sparse_matrix_mult.cu:577-592)
    and carries rows=a.rows, cols=b.cols (:281-282)."""
    a = ensure_device(a, device)
    b = ensure_device(b, device)
    if plan is None:
        with ENGINE.phase("plan_wait"):
            plan = _plan(a, b, backend=backend, round_size=round_size)
    elif plan.backend != backend:
        raise ValueError(f"plan built for backend {plan.backend!r}, asked for {backend!r}")
    if delta.enabled() and plan.fingerprint is not None:
        return _delta_execute(plan, a, b, folds, digests or (None, None))
    return execute(plan, a, b, folds=folds)


def spgemm(a: BlockSparseMatrix, b: BlockSparseMatrix, *, device="cuda",
           backend: str = "exact", round_size: int | None = None,
           folds: Folds = KERNELS) -> BlockSparseMatrix:
    """C = A x B host-to-host: upload, multiply on `device`, fetch (the CLI's
    --stream multiply: chain partials stay in host memory)."""
    return spgemm_device(a, b, device=device, backend=backend, folds=folds,
                         round_size=round_size).to_host()


def spgemm_outofcore(a, b, *, device="cuda", round_size: int | None = None,
                     backend: str = "exact", folds: Folds = KERNELS) -> BlockSparseMatrix:
    """C = A x B without either operand slab on the device (the JAX
    package's spgemm_outofcore, ops/spgemm.py:1305-1550).

    The reference keeps its matrices in host RAM and stages one round at a
    time to the GPU (sparse_matrix_mult.cu:167-257); so does this.  Each
    round of at most round_size keys (default OOC_ROUND_SIZE, the JAX
    package's 512) uploads only the tiles it references, so the card holds
    at most SPGEMM_TPU_OOC_DEPTH rounds' sub-slabs and outputs whatever the
    operands' size.  At depth >= 2 three stages overlap:

      staging thread -- np.unique / searchsorted / the gather of the
                        round's tiles into pinned host memory (ENGINE
                        `stage_prep`);
      main thread    -- the host-to-device copy on a copy stream and the
                        numeric launch on the current stream (`dispatch`);
                        the hybrid router, whose gate may measure on the
                        card, runs here;
      landing thread -- waits on the round's event, then scatters its
                        device-to-host copy into the host result
                        (`assembly`).

    Depth 1 runs the three in turn, one round at a time.  A round's sub-slab
    holds exactly its referenced tiles plus the zero tile last: the kernels
    skip a slot whose index is the slab's last row, so padding the slab (as
    the JAX package does for its jit cache) would fold pad slots instead of
    skipping them.  The bytes are the resident path's at any depth and
    round size.  The rounds are always planned ladder, as the JAX package's
    out-of-core and sharded strategies are.  a, b: host BlockSparseMatrix (a
    DeviceBlockMatrix is fetched first); hybrid and mxu read the host tiles'
    exact maxima as bounds."""
    if isinstance(a, DeviceBlockMatrix):
        a = a.to_host()
    if isinstance(b, DeviceBlockMatrix):
        b = b.to_host()
    dev = resolve_device(device)
    depth = knobs.get("SPGEMM_TPU_OOC_DEPTH")
    p = plan(a, b, backend=backend, route="ladder",
             round_size=OOC_ROUND_SIZE if round_size is None else round_size).ensure_exact()
    k = p.k
    if p.join.num_keys == 0:
        return BlockSparseMatrix(rows=a.rows, cols=b.cols, k=k)
    choose = _router(backend, k, dev, folds, lambda: (_bound(a), _bound(b)))
    on_card = dev.type == "cuda"
    # host tensors over the operands' and the result's memory: torch's
    # gather and scatter run on the host's cores, numpy's on one
    a_tiles, b_tiles = (torch.from_numpy(np.require(m.tiles, requirements="W").view(np.int64))
                        for m in (a, b))
    out_tiles = np.zeros((p.join.num_keys, k, k), np.int64)
    out_t = torch.from_numpy(out_tiles)
    used = dict.fromkeys(rounds_by_kernel, 0)
    if on_card:
        compute = torch.cuda.current_stream(dev)
        copy_stream, land_stream = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

    def stage(rnd):
        """Stage 1, host only: (a_sub, sub_pa, b_sub, sub_pb), pinned on
        the card's host."""
        staged = []
        for idx, nnzb, tiles in ((rnd.pa, a.nnzb, a_tiles), (rnd.pb, b.nnzb, b_tiles)):
            u = np.unique(idx)
            u = u[u < nnzb]  # the operand's sentinel is not a tile
            sub = torch.empty((len(u) + 1, k, k), dtype=torch.int64, pin_memory=on_card)
            torch.index_select(tiles, 0, torch.from_numpy(u), out=sub[:-1])
            sub[-1] = 0
            ix = torch.empty(idx.shape, dtype=torch.int32, pin_memory=on_card)
            # the sentinel, past every real index, lands on len(u): the zero tile
            ix.numpy()[...] = np.searchsorted(u, idx)
            staged += [sub, ix]
        ENGINE.incr("ooc_upload_bytes", sum(t.nbytes for t in staged))
        return staged

    def launch(rnd, staged):
        """Stage 2, main thread: upload, one launch, queue the fetch.
        Returns (host rows, event the landing waits on, key_index)."""
        name, fold, _ = choose(rnd)
        used[name] += 1
        ENGINE.incr("ooc_rounds")
        n = len(rnd.key_index)
        if not on_card:
            return fold(*staged[0::2], *staged[1::2])[:n], None, rnd.key_index
        with torch.cuda.stream(copy_stream):
            a_sub, pa, b_sub, pb = (t.to(dev, non_blocking=True) for t in staged)
        compute.wait_stream(copy_stream)
        for t in (a_sub, pa, b_sub, pb):
            t.record_stream(compute)  # allocated on the copy stream, read here
        out = fold(a_sub, b_sub, pa, pb)
        land_stream.wait_stream(compute)
        with torch.cuda.stream(land_stream):
            host = torch.empty((n, k, k), dtype=torch.int64, pin_memory=True)
            host.copy_(out[:n], non_blocking=True)
            done = torch.cuda.Event()
            done.record(land_stream)
        out.record_stream(land_stream)
        return host, done, rnd.key_index

    def land(host, done, key_index):
        """Stage 3: wait for this round's copy only, then scatter."""
        if done is not None:
            done.synchronize()
        out_t.index_copy_(0, torch.tensor(key_index), host)

    _pipeline(p.rounds, stage, launch, land, depth)
    _count_rounds(backend, used, len(p.rounds), p.join.num_keys)
    return BlockSparseMatrix(rows=a.rows, cols=b.cols, k=k, coords=p.join.keys,
                             tiles=out_tiles.view(np.uint64))


def _pipeline(rounds, stage, launch, land, depth: int) -> None:
    """Run stage on a staging thread, launch here and land on a landing
    thread, with at most `depth` rounds staged ahead and at most `depth`
    launched and not yet landed (on the card).  The staging of round
    i + depth is submitted once round i has launched and the oldest landing
    beyond depth - 1 has been awaited, so depth 1 runs the three stages in
    turn.  A failure in any stage is raised here by .result(); the queued
    work is cancelled and both threads joined."""
    def staged(rnd):
        with ENGINE.phase("stage_prep"):
            return stage(rnd)

    def landed(item):
        with ENGINE.phase("assembly"):
            land(*item)

    stager = ThreadPoolExecutor(1, thread_name_prefix="ooc-staging")
    lander = ThreadPoolExecutor(1, thread_name_prefix="ooc-landing")
    try:
        ahead = deque(stager.submit(staged, rnd) for rnd in rounds[:depth])
        landing: deque = deque()
        for i, rnd in enumerate(rounds):
            item = ahead.popleft().result()
            with ENGINE.phase("dispatch"):
                item = launch(rnd, item)
            landing.append(lander.submit(landed, item))
            if len(landing) == depth:
                landing.popleft().result()
            if i + depth < len(rounds):
                ahead.append(stager.submit(staged, rounds[i + depth]))
        for fut in landing:
            fut.result()
    finally:
        stager.shutdown(cancel_futures=True)
        lander.shutdown(cancel_futures=True)
